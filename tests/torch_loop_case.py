"""Shared case of the loop-closure tests (not a test module): keyframes
rendered by the JAX package on the circle of its own ``tests/test_loop.py``
(world seed 3, a 16x900 sensor, keyframes every 360/14 degrees on a 6 m
circle, the last revisiting the first), their features extracted by the JAX
frontend, and their poses drifting from the truth. Everything is handed to
the port as numpy.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mloam_tpu.config import LoopConfig as JLoopConfig
from mloam_tpu.core import rotations as jrot
from mloam_tpu.core import se3 as jse3
from mloam_tpu.core.rangeimage import LidarModel as JModel
from mloam_tpu.frontend import features as JF
from mloam_tpu.frontend import segmentation as JS
from mloam_tpu.models import platforms as jplatforms
from mloam_tpu.sim import world as JW
from mloam_tpu_torch.utils import convert

MODEL = JModel(n_rings=16, n_cols=900)
JCFG = jplatforms.synthetic(1)
JLCFG = JLoopConfig(num_exclude_recent=4, loop_distance_threshold=10.0)
N_KF = 14


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def np_(x):
    return jax.tree.map(np.asarray, x)


def configs():
    """(JAX MloamConfig, port MloamConfig, JAX LoopConfig, port LoopConfig)."""
    import dataclasses

    tcfg = convert.config_from_reference(dataclasses.asdict(JCFG))
    tl = convert.config_from_reference(
        dataclasses.asdict(dataclasses.replace(JCFG, loop=JLCFG))).loop
    return JCFG, tcfg, JLCFG, tl


def circle_pose(k, n=N_KF, radius=6.0):
    ang = 2 * np.pi * k / n
    q = jrot.so3_exp_quat(jnp.array([0.0, 0.0, float(ang + np.pi / 2)]))
    return jse3.Pose(q, jnp.array([radius * np.cos(ang), radius * np.sin(ang), 0.6]))


@functools.lru_cache(maxsize=None)
def keyframes(drift_step=(0.04, 0.02, 0.0, 0.0, 0.0, 0.008), n=N_KF + 1):
    """[(gt pose, drifted pose, corner, surf)] as JAX values, keyframe k
    drifted by exp(k * drift_step)."""
    w = JW.make_world(jax.random.PRNGKey(3), extent=30.0, n_walls=20, n_poles=10)
    frontend = jax.jit(lambda img: JF.extract(
        img, JS.segment(img, MODEL, JCFG.segmenter).segmented, JCFG.features))
    oc = JCFG.odometry
    out = []
    for k in range(n):
        gt = circle_pose(k)
        ff = frontend(JW.render_scan(w, gt, gt, MODEL))
        corner = JF.downsample_featcloud(ff.less_sharp, oc.corner_map_leaf, oc.cap_frame_corner)
        surf = JF.downsample_featcloud(ff.less_flat, oc.surf_map_leaf, oc.cap_frame_surf)
        drift = jse3.exp(jnp.asarray(drift_step, jnp.float32) * k)
        out.append((gt, jse3.compose(gt, drift), corner, surf))
    return out

