"""Port vs JAX package: online extrinsic calibration (ESTIMATE_EXTRINSIC 1
and the 2 -> 1 -> 0 transitions), at small width.

The window solve in calibration mode runs on a carried-across dual-lidar
window (a room corner seen by both lidars, lidar 1 through an extrinsic that
starts 3 cm / 30 mrad off): H, the refined poses and extrinsic and the new
prior's H agree to 1e-4 relative to their largest entry, over two steps so
that the second solve replays a prior that spans the extrinsic block. The
gradients g and the prior's b are taken at a near-optimum, where they are
sums that nearly cancel: they are held to 1e-4 of the gradient a 1 cm /
10 mrad step would give, 1e-2 of the largest entry of H (observed: at most
3e-6 of it; g's own largest entry is far smaller). The pipeline's
transitions are held against the JAX pipeline's on the same buffers and
samples.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mloam_tpu.core import se3 as jse3
from mloam_tpu.core.rangeimage import LidarModel as JModel
from mloam_tpu.frontend.features import FeatCloud as JFeatCloud
from mloam_tpu.models import platforms as jplatforms
from mloam_tpu.models.pipeline import OdometryPipeline as JPipeline
from mloam_tpu.odometry import estimator as JE
from mloam_tpu.odometry import initializer as JI
from mloam_tpu_torch.core import se3 as tse3
from mloam_tpu_torch.core.rangeimage import RangeImage
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.models.pipeline import OdometryPipeline
from mloam_tpu_torch.models.run_synthetic import render_rig
from mloam_tpu_torch.odometry import estimator as TE
from mloam_tpu_torch.odometry import initializer as TI
from mloam_tpu_torch.utils import convert

REL = 1e-4
X_TRUE = np.array([0.25, -0.1, 0.05, 0.05, -0.03, 0.5], np.float32)
X_OFF = np.array([0.03, -0.02, 0.01, 0.01, -0.02, 0.03], np.float32)


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def small_cfg(extrinsic_mode=1, n_lidars=2, **calib):
    j = jplatforms.synthetic(n_lidars=n_lidars, extrinsic_mode=extrinsic_mode)
    j = dataclasses.replace(
        j,
        rig=dataclasses.replace(j.rig, models=(JModel(n_rings=8, n_cols=360),) * n_lidars),
        features=dataclasses.replace(j.features, cap_less_flat=512),
        calib=dataclasses.replace(j.calib, **calib),
        odometry=dataclasses.replace(
            j.odometry, window_size=4, opt_window_size=2, cap_frame_corner=128,
            cap_frame_surf=256, localmap_precap_corner=256,
            localmap_precap_surf=640))
    return j, convert.config_from_reference(dataclasses.asdict(j))


def jext(X):
    """[2] extrinsics: lidar 0 at the base, lidar 1 at X."""
    I0 = jse3.Pose.identity()
    return jse3.Pose(jnp.stack([I0.q, X.q]), jnp.stack([I0.t, X.t]))


def _room(rng, n_edge, n_wall):
    u = rng.uniform(-4, 4, size=(n_wall, 2)).astype(np.float32)
    k = rng.integers(0, 3, size=n_wall)
    z = np.zeros(n_wall, np.float32)
    walls = np.where((k == 0)[:, None], np.stack([u[:, 0], u[:, 1], z - 1], 1),
                     np.where((k == 1)[:, None], np.stack([u[:, 0], z + 4, u[:, 1] * 0.5], 1),
                              np.stack([z + 4, u[:, 0], u[:, 1] * 0.5], 1)))
    t = rng.uniform(-1, 2, size=n_edge).astype(np.float32)
    k = rng.integers(0, 3, size=n_edge)
    z = np.zeros(n_edge, np.float32)
    edges = np.where((k == 0)[:, None], np.stack([z + 4, z + 4, t], 1),
                     np.where((k == 1)[:, None], np.stack([t * 2, z + 4, z - 1], 1),
                              np.stack([z + 4, t * 2, z - 1], 1)))
    return edges.astype(np.float32), walls.astype(np.float32)


def _frame(cfg, rng, shift, X):
    """Both lidars' clouds of the room seen from a base shifted by ``shift``
    along x; lidar 1's points in its own frame through the true X."""
    nc, ns = cfg.odometry.cap_frame_corner, cfg.odometry.cap_frame_surf
    Xinv = jse3.inverse(X)
    out = []
    for n, idx in ((nc, 0), (ns, 1)):
        per = []
        for l in range(2):
            pts = _room(rng, nc, ns)[idx] - np.array([shift, 0, 0], np.float32)
            if l == 1:
                pts = np.asarray(jse3.transform_points(Xinv, jnp.asarray(pts)))
            per.append(pts)
        out.append(JFeatCloud(xyz=jnp.asarray(np.stack(per)),
                              mask=jnp.asarray(rng.random((2, n)) < 0.9),
                              time=jnp.zeros((2, n)),
                              ring=jnp.zeros((2, n), jnp.int32)))
    return out


def _close(t, j, rel=REL, scale=None):
    j = N(j)
    scale = np.abs(j).max() if scale is None else scale
    np.testing.assert_allclose(N(t), j, atol=rel * max(scale, 1e-6))


def test_calibration_window_step_matches_reference():
    jcfg, tcfg = small_cfg()
    rng = np.random.default_rng(0)
    X = jse3.exp(jnp.asarray(X_TRUE))
    X0 = jse3.boxplus(X, jnp.asarray(X_OFF))
    jw = JE.init_window(jcfg, jcfg.odometry.cap_frame_corner, jcfg.odometry.cap_frame_surf)
    jw = JE.reset_prior(JE.set_extrinsics(jw, jext(X0)), jcfg, calibrate_ext=True)
    for i in range(jcfg.odometry.window_size):
        c, s = _frame(jcfg, rng, 0.05 * i, X)
        jw = JE.push_frame(jw, jse3.Pose(jnp.array([1.0, 0, 0, 0]),
                                         jnp.array([0.05 * i, 0.0, 0.0])), c, s, jcfg)
    tw = convert.window_state_from_numpy(jax.tree.map(np.asarray, jw))
    assert tw.prior.H.shape == (24, 24)               # 3 poses + 1 extrinsic

    for step in range(2):
        c, s = _frame(jcfg, rng, 0.05 * (4 + step), X)
        new_pose = jse3.boxplus(
            jse3.Pose(jnp.array([1.0, 0, 0, 0]), jnp.array([0.05 * (4 + step), 0.0, 0.0])),
            jnp.array([0.02, -0.01, 0.01, 0.0, 0.0, 0.004]))
        tc = convert.featcloud_from_numpy(jax.tree.map(np.asarray, c))
        ts = convert.featcloud_from_numpy(jax.tree.map(np.asarray, s))
        tpose = convert.pose_from_numpy(jax.tree.map(np.asarray, new_pose))
        jw2, jsolve = JE.optimize_window(JE.push_frame(jw, new_pose, c, s, jcfg), jcfg,
                                         calibrate_ext=True)
        jw = JE.marginalize_pivot(jw2, jsolve, jcfg, calibrate_ext=True)
        tw2, tsolve = TE.optimize_window(TE.push_frame(tw, tpose, tc, ts, tcfg), tcfg,
                                         calibrate_ext=True)
        tw = TE.marginalize_pivot(tw2, tsolve, tcfg, calibrate_ext=True)

        assert tsolve.H.shape == (24, 24) and tsolve.eig_min.shape == (4,)
        assert abs(int(tsolve.n_surf) - int(jsolve.n_surf)) <= 2
        assert int(tsolve.n_surf) > 100 and int(tsolve.n_corner) > 20
        _close(tsolve.H, jsolve.H)
        _close(tsolve.g, jsolve.g, scale=np.abs(N(jsolve.H)).max() * 1e-2)
        _close(tsolve.H_anchor, jsolve.H_anchor)
        _close(tsolve.g_anchor, jsolve.g_anchor, scale=np.abs(N(jsolve.H)).max() * 1e-2)
        _close(tsolve.eig_min, jsolve.eig_min)
        np.testing.assert_allclose(float(tsolve.cost), float(jsolve.cost), rtol=1e-3)
        for a, b in ((tw.poses.q, jw.poses.q), (tw.poses.t, jw.poses.t),
                     (tw.ext.q, jw.ext.q), (tw.ext.t, jw.ext.t)):
            np.testing.assert_allclose(N(a), N(b), atol=REL)
        _close(tw.prior.H, jw.prior.H)
        _close(tw.prior.b, jw.prior.b, scale=np.abs(N(jw.prior.H)).max() * 1e-2)
        # the extrinsic blocks moved past the zero block of the new pose
        assert float(tw.prior.H[12:18].abs().max()) == 0.0
        assert float(tw.prior.H[18:, 18:].abs().max()) > 0.0
        # the prior's linearization points do not alias the live window
        assert tw.prior_ext.q.data_ptr() != tw.ext.q.data_ptr()
    # the extrinsic moved toward the truth
    err0 = float(jnp.linalg.norm(jnp.asarray(X_OFF)))
    err = float(tse3.boxminus(Pose(tw.ext.q[1], tw.ext.t[1]),
                              convert.pose_from_numpy(jax.tree.map(np.asarray, X))).norm())
    assert err < 0.5 * err0


def test_calibration_map_is_formed_by_the_reference_lidar_only():
    jcfg, tcfg = small_cfg()
    nc, ns = jcfg.odometry.cap_frame_corner, jcfg.odometry.cap_frame_surf
    rng = np.random.default_rng(1)
    jw = JE.init_window(jcfg, nc, ns)

    def cloud(n, base):
        # lidar 0 near the base, lidar 1 far above it (z + 100)
        xyz0 = base + rng.uniform(-5, 5, size=(n, 3)).astype(np.float32)
        xyz = np.stack([xyz0, xyz0 + np.array([0, 0, 100.0], np.float32)])
        return JFeatCloud(xyz=jnp.asarray(xyz), mask=jnp.ones((2, n), bool),
                          time=jnp.zeros((2, n)), ring=jnp.zeros((2, n), jnp.int32))

    for i in range(jcfg.odometry.window_size + 1):
        base = np.array([float(i), 0.0, 0.0], np.float32)
        jw = JE.push_frame(jw, jse3.Pose(jnp.array([1.0, 0, 0, 0]), jnp.asarray(base)),
                           cloud(nc, base), cloud(ns, base), jcfg)
    tw = convert.window_state_from_numpy(jax.tree.map(np.asarray, jw))
    for lidars in ((0,), None):
        jm = JE.build_local_map(jw, jcfg, map_lidars=lidars)
        tm = TE.build_local_map(tw, tcfg, map_lidars=lidars)
        for a, b in ((tm[1], jm[1]), (tm[3], jm[3])):
            np.testing.assert_array_equal(N(a), N(b))
        for xyz, m in ((tm[0], tm[1]), (tm[2], tm[3])):
            z = N(xyz[..., 2])[N(m)]
            assert z.size > 0
            if lidars == (0,):
                assert z.max() < 50.0, "non-reference lidar points in the calibration map"
            else:
                assert z.max() > 50.0


def test_reset_prior_does_not_alias_live_buffers():
    _, tcfg = small_cfg()
    for calibrate_ext, dim in ((True, 24), (False, 18)):
        w = TE.init_window(tcfg, 8, 16, device="cpu")
        r = TE.reset_prior(w, tcfg, calibrate_ext=calibrate_ext)
        assert r.prior.H.shape == (dim, dim) and not bool(r.prior.valid)
        for a, b in ((r.prior_poses.q, r.poses.q), (r.prior_poses.t, r.poses.t),
                     (r.prior_ext.q, r.ext.q), (r.prior_ext.t, r.ext.t)):
            assert a.data_ptr() != b.data_ptr()
            assert torch.equal(a, b)
        r.poses.t.add_(1.0)                     # a write into the live window
        assert float(r.prior_poses.t.abs().max()) == 0.0


def _hand_eye_pairs(seed, X, n, yaw_only=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        phi = (0.2 * rng.standard_normal(3)).astype(np.float32)
        if yaw_only:
            phi[:2] = 0.0
        xi = np.concatenate([0.3 * rng.standard_normal(3), phi]).astype(np.float32)
        A = jse3.exp(jnp.asarray(xi))
        out.append((A, jse3.compose(jse3.compose(jse3.inverse(X), A), X)))
    return out


@pytest.mark.parametrize("motion", ["rich", "yaw_only"])
def test_try_init_calib_installs_the_reference_extrinsic(motion):
    jcfg, tcfg = small_cfg(extrinsic_mode=2)
    X = jse3.exp(jnp.asarray(X_TRUE))
    jpipe, tpipe = JPipeline(jcfg), OdometryPipeline(tcfg, device="cpu")
    assert jpipe.ext_mode == tpipe.ext_mode == 2
    for A, B in _hand_eye_pairs(3, X, 40, yaw_only=motion == "yaw_only"):
        jpipe.calib_buffers[1] = JI.add_pair(jpipe.calib_buffers[1], A, B)
        tpipe.calib_buffers[1] = TI.add_pair(
            tpipe.calib_buffers[1], convert.pose_from_numpy(jax.tree.map(np.asarray, A)),
            convert.pose_from_numpy(jax.tree.map(np.asarray, B)))
    jpipe._try_init_calib()
    tpipe._try_init_calib()
    assert tpipe.ext_mode == jpipe.ext_mode == (1 if motion == "rich" else 2)
    if motion == "yaw_only":
        assert torch.equal(tpipe.window.ext.q, torch.tensor([[1.0, 0, 0, 0]] * 2))
        return
    q, jq = N(tpipe.window.ext.q[1]), N(jpipe.window.ext.q[1])
    assert min(np.abs(q - jq).max(), np.abs(q + jq).max()) < 1e-5
    np.testing.assert_allclose(N(tpipe.window.ext.t), N(jpipe.window.ext.t), atol=1e-4)
    assert tpipe.window.prior.H.shape == jpipe.window.prior.H.shape == (24, 24)
    assert torch.equal(tpipe.window.prior_ext.t, tpipe.window.ext.t)
    err = float(tse3.boxminus(Pose(tpipe.window.ext.q[1], tpipe.window.ext.t[1]),
                              convert.pose_from_numpy(jax.tree.map(np.asarray, X))).norm())
    assert err < 1e-3


def test_collect_calib_sample_freezes_the_same_mean():
    n_samples = 6
    jcfg, tcfg = small_cfg(extrinsic_mode=1, n_calib_samples=n_samples)
    X = jse3.exp(jnp.asarray(X_TRUE))
    jpipe, tpipe = JPipeline(jcfg), OdometryPipeline(tcfg, device="cpu")
    rng = np.random.default_rng(4)
    for _ in range(n_samples - 1):
        s = jse3.boxplus(X, jnp.asarray((0.01 * rng.standard_normal(6)).astype(np.float32)))
        jpipe.ext_samples[1].append((np.asarray(s.q), np.asarray(s.t)))
        tpipe.ext_samples[1].append((np.asarray(s.q), np.asarray(s.t)))
    last = jse3.boxplus(X, jnp.asarray((0.01 * rng.standard_normal(6)).astype(np.float32)))
    jpipe.window = JE.set_extrinsics(jpipe.window, jext(last))
    tpipe.set_extrinsics(convert.pose_from_numpy(jax.tree.map(np.asarray, jext(last))))

    # an ill-conditioned extrinsic block is not sampled
    low = np.array([500.0, 500.0, 500.0, 10.0], np.float32)
    jpipe._collect_calib_sample(types.SimpleNamespace(eig_min=jnp.asarray(low)))
    tpipe._collect_calib_sample(types.SimpleNamespace(eig_min=torch.from_numpy(low)))
    assert tpipe.ext_mode == jpipe.ext_mode == 1
    assert len(tpipe.ext_samples[1]) == n_samples - 1

    high = np.array([500.0, 500.0, 500.0, 200.0], np.float32)
    jpipe._collect_calib_sample(types.SimpleNamespace(eig_min=jnp.asarray(high)))
    tpipe._collect_calib_sample(types.SimpleNamespace(eig_min=torch.from_numpy(high)))
    assert tpipe.ext_mode == jpipe.ext_mode == 0
    np.testing.assert_allclose(N(tpipe.window.ext.q), N(jpipe.window.ext.q), atol=1e-5)
    np.testing.assert_allclose(N(tpipe.window.ext.t), N(jpipe.window.ext.t), atol=1e-5)
    assert tpipe.ext_cov.shape == (1, 6, 6)
    np.testing.assert_allclose(tpipe.ext_cov, jpipe.ext_cov, atol=1e-7, rtol=1e-4)
    # back to pure odometry: the prior spans the poses only, and is empty
    assert tpipe.window.prior.H.shape == (18, 18) and not bool(tpipe.window.prior.valid)


def test_mode1_sweeps_reduce_the_extrinsic_error():
    """Refinement on a rendered dual rig, started 7 cm (tangent norm) off
    the true extrinsic: a few mode-1 sweeps pull it in."""
    _, tcfg = small_cfg(extrinsic_mode=1, n_calib_samples=1000)
    Xg = tse3.exp(torch.from_numpy(X_TRUE))
    ident = Pose.identity()
    X = Pose(torch.stack([ident.q, Xg.q]), torch.stack([ident.t, Xg.t]))
    n = 8
    seqs, _ = render_rig(tcfg, n, seed=0, extrinsics=X, wobble=0.1, device="cpu")
    X0 = tse3.boxplus(Xg, torch.tensor([0.05, -0.03, 0.02, 0.02, -0.01, 0.03]))
    pipe = OdometryPipeline(tcfg, device="cpu")
    pipe.set_extrinsics(Pose(torch.stack([ident.q, X0.q]), torch.stack([ident.t, X0.t])))
    err0 = float(tse3.boxminus(X0, Xg).norm())
    for i in range(n):
        out = pipe.process([RangeImage(*(f[i] for f in s)) for s in seqs])
        assert out.ext_mode == 1 and torch.isfinite(out.pose.t).all()
    err = float(tse3.boxminus(Pose(out.extrinsics.q[1], out.extrinsics.t[1]), Xg).norm())
    assert err < 0.6 * err0, f"refinement did not converge: {err0} -> {err}"
    assert err < 0.05
