"""Shared case of ``test_torch_degeneracy.py``, ``test_torch_skip_steady.py``
and ``test_torch_skip_steady_rig.py`` (not a test module): the corridor
course of the JAX package's ``tests/test_degeneracy_e2e.py`` at a small
width.

The tunnel (``make_corridor_world(wall_height=3, ceiling=True)``, sensor
1.2 m above the base) is driven straight along +x at 2 m/s with 0.02 rad of
wobble, range noise 0.01 m, and a companion 5 m ahead that rides with the
vehicle 3 sweeps in every 10 from ``COMP_START``. The configuration is
``indoor_degenerate`` (the window and mapper remap armed at 175) with the
tracker skipped on the steady path, on an 8x360 sensor of 20 m range with
the small caps and the 4/2 window of ``tests/test_torch_pipeline.py``. At
this width every window's weakest eigenvalue lies far below 175 (17-31), so
the persistence count alone decides engagement: off while it counts up,
on from its fifth consistent sweep.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mloam_tpu.core import se3 as jse3
from mloam_tpu.core.rangeimage import LidarModel as JModel
from mloam_tpu.core.se3 import Pose as JPose
from mloam_tpu.models import platforms as jplatforms
from mloam_tpu.sim import world as JW
from mloam_tpu_torch.utils import convert

COMP_START = 5
MOUNT = ([1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 1.2])


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def configs(n_lidars=1):
    j = jplatforms.synthetic(n_lidars=n_lidars)
    j = dataclasses.replace(
        j,
        rig=dataclasses.replace(
            j.rig, models=(JModel(n_rings=8, n_cols=360, max_range=20.0),) * n_lidars),
        features=dataclasses.replace(j.features, cap_less_flat=512),
        tracker=dataclasses.replace(j.tracker, skip_steady=True),
        odometry=dataclasses.replace(
            j.odometry, window_size=4, opt_window_size=2, cap_frame_corner=128,
            cap_frame_surf=256, localmap_precap_corner=256,
            localmap_precap_surf=640))
    j = jplatforms.indoor_degenerate(j)
    return j, convert.config_from_reference(dataclasses.asdict(j))


def render(jcfg, n, extrinsic=None):
    """The course's sweeps for one lidar mounted at ``extrinsic`` (base <-
    lidar, applied after the 1.2 m mount), rendered by the JAX package."""
    mount = JPose(jnp.array(MOUNT[0]), jnp.array(MOUNT[1]))
    if extrinsic is not None:
        mount = jse3.compose(mount, extrinsic)
    imgs, gt = JW.render_sequence(
        JW.make_corridor_world(wall_height=3.0, ceiling=True),
        JW.make_straight_trajectory(speed=2.0, wobble=0.02),
        jcfg.rig.models[0], n, noise_std=0.01, noise_seed=1000, extrinsic=mount,
        companions=jnp.array([[5.0, 0.8, 0.12]]), companion_frames=(COMP_START, n),
        companion_period=(3, 10))
    return imgs, gt


def tframe(imgs, i):
    return convert.range_image_from_numpy(tuple(np.asarray(f[i]) for f in imgs))


def load_state(tp, jp):
    """Give the port's odometry pipeline the JAX pipeline's state (mode 0)."""
    np_ = lambda x: jax.tree.map(np.asarray, x)
    tp.frame_idx, tp.ext_mode = jp.frame_idx, jp.ext_mode
    tp.window = convert.window_state_from_numpy(np_(jp.window))
    tp.prev_feats = [None if f is None else convert.feature_frame_from_numpy(np_(f))
                     for f in jp.prev_feats]
    tp.motions = [convert.pose_from_numpy(np_(m)) for m in jp.motions]
    tp.world_pose = convert.pose_from_numpy(np_(jp.world_pose))
