"""Port vs JAX package: the robust losses in the window and the tracker.

  * ``gm`` (Geman-McClure, c 0.12) and ``gnc_gm`` (its graduated surrogate:
    ``max(gn_iters, 8)`` iterations under ``robust.gnc_mu_schedule``) in the
    window step of ``tests/test_torch_odometry.py`` (a pre-filled window, a
    new frame 3 cm / 5 mrad off: push, optimize, marginalize), held as that
    test holds huber: poses to 1e-4, cost to 1e-3 relative, the new prior
    to 1e-3 of its scale;
  * the same two losses in ``track`` on two rendered sweeps: pose to 1e-4
    rad / 1e-4 m, as ``tests/test_torch_odometry.py`` holds huber.

The JAX side runs jitted (its eager dispatch compiles op by op).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mloam_tpu import config as JC
from mloam_tpu.config import SegmenterConfig as JSegCfg
from mloam_tpu.core import se3 as jse3
from mloam_tpu.frontend import features as JF
from mloam_tpu.frontend import segmentation as JS
from mloam_tpu.odometry import estimator as JE
from mloam_tpu.odometry import tracker as JT
from mloam_tpu.sim import world as JW
from mloam_tpu_torch import config as TC
from mloam_tpu_torch.core import se3 as tse3
from mloam_tpu_torch.odometry import estimator as TE
from mloam_tpu_torch.odometry import tracker as TT
from mloam_tpu_torch.utils import convert
from test_torch_odometry import N, _example_frame, small_cfg

LOSSES = [("gm", 0.12), ("gnc_gm", 0.12)]


def np_(x):
    return jax.tree.map(np.asarray, x)


def loss_cfgs(mode, c):
    j, _ = small_cfg()
    j = JC.with_loss_mode(j, mode, gm_c=c)
    return j, convert.config_from_reference(dataclasses.asdict(j))


def _window_step(jw, pose, c, s, cfg):
    jw2, solve = JE.optimize_window(JE.push_frame(jw, pose, c, s, cfg), cfg)
    return JE.marginalize_pivot(jw2, solve, cfg), solve


_jit_window_step = jax.jit(_window_step, static_argnames=("cfg",))
_jit_track = jax.jit(JT.track, static_argnames=("cfg",))


@pytest.fixture(scope="module")
def two_sweeps():
    """Two sweeps of a rendered world, features extracted by the JAX
    package (the fixture of ``tests/test_torch_odometry.py``, jitted)."""
    jcfg, _ = small_cfg()
    model = jcfg.rig.models[0]
    w = JW.make_world(jax.random.PRNGKey(0))
    traj = JW.make_trajectory(jax.random.PRNGKey(1), speed_scale=2.0)
    imgs, _ = JW.render_sequence(w, traj, model, 2)

    @jax.jit
    def frontend(img):
        return JF.extract(img, JS.segment(img, model, JSegCfg()).segmented, jcfg.features)
    return [frontend(type(imgs)(*(f[i] for f in imgs))) for i in range(2)]


@pytest.mark.parametrize("mode,c", LOSSES, ids=[m for m, _ in LOSSES])
def test_window_step_with_robust_loss_matches_reference(mode, c):
    jcfg, tcfg = loss_cfgs(mode, c)
    assert tcfg.odometry.loss_mode == mode and tcfg.odometry.gm_c == c
    rng = np.random.default_rng(0)
    jw = JE.init_window(jcfg, jcfg.odometry.cap_frame_corner, jcfg.odometry.cap_frame_surf)
    for i in range(jcfg.odometry.window_size):
        cc, s = _example_frame(jcfg, rng, 0.05 * i)
        pose = jse3.Pose(jnp.array([1.0, 0, 0, 0]), jnp.array([0.05 * i, 0.0, 0.0]))
        jw = JE.push_frame(jw, pose, cc, s, jcfg)
    cc, s = _example_frame(jcfg, rng, 0.05 * 4)
    new_pose = jse3.boxplus(
        jse3.Pose(jnp.array([1.0, 0, 0, 0]), jnp.array([0.2, 0.0, 0.0])),
        jnp.array([0.03, -0.02, 0.01, 0.0, 0.0, 0.005]))
    tw = convert.window_state_from_numpy(np_(jw))
    jw3, jsolve = _jit_window_step(jw, new_pose, cc, s, cfg=jcfg)
    tw2, tsolve = TE.optimize_window(TE.push_frame(
        tw, convert.pose_from_numpy(np_(new_pose)), convert.featcloud_from_numpy(np_(cc)),
        convert.featcloud_from_numpy(np_(s)), tcfg), tcfg)
    tw3 = TE.marginalize_pivot(tw2, tsolve, tcfg)
    np.testing.assert_allclose(N(tw3.poses.q), N(jw3.poses.q), atol=1e-4)
    np.testing.assert_allclose(N(tw3.poses.t), N(jw3.poses.t), atol=1e-4)
    np.testing.assert_allclose(float(tsolve.cost), float(jsolve.cost), rtol=1e-3, atol=1e-6)
    psc = np.abs(N(jw3.prior.H)).max()
    np.testing.assert_allclose(N(tw3.prior.H), N(jw3.prior.H), atol=1e-3 * psc)
    np.testing.assert_allclose(N(tw3.prior.b), N(jw3.prior.b),
                               atol=1e-3 * max(np.abs(N(jw3.prior.b)).max(), 1.0))
    # the loss differs from huber's: the same window solves to another cost
    _, thub = small_cfg()
    _, hsolve = TE.optimize_window(TE.push_frame(
        convert.window_state_from_numpy(np_(jw)), convert.pose_from_numpy(np_(new_pose)),
        convert.featcloud_from_numpy(np_(cc)), convert.featcloud_from_numpy(np_(s)), thub), thub)
    assert abs(float(hsolve.cost) - float(tsolve.cost)) > 1e-3 * abs(float(hsolve.cost))


@pytest.mark.parametrize("mode,c", LOSSES, ids=[m for m, _ in LOSSES])
def test_track_with_robust_loss_matches_reference(two_sweeps, mode, c):
    ff0, ff1 = two_sweeps
    jcfg, tcfg = loss_cfgs(mode, c)
    jres, _ = _jit_track(ff0, ff1, jse3.Pose.identity(), cfg=jcfg.tracker)
    tres, _ = TT.track(convert.feature_frame_from_numpy(np_(ff0)),
                       convert.feature_frame_from_numpy(np_(ff1)),
                       tse3.Pose.identity(), tcfg.tracker)
    d = tse3.boxminus(tres.pose, convert.pose_from_numpy(np_(jres.pose)))
    assert float(d[3:].abs().max()) < 1e-4      # rad
    assert float(d[:3].abs().max()) < 1e-4      # m
    assert int(tres.n_plane) == int(jres.n_plane) and int(tres.n_edge) == int(jres.n_edge)
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=1e-2, atol=1e-6)


def test_robust_configs_reach_every_solver():
    cfg = TC.with_loss_mode(convert.config_from_reference(dataclasses.asdict(small_cfg()[0])),
                            "gnc_gm", gm_c=0.2)
    assert cfg.tracker.loss_mode == cfg.odometry.loss_mode == cfg.mapping.loss_mode == "gnc_gm"
    assert cfg.mapping.gm_c == 0.2
