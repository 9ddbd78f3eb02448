"""Port vs JAX package: odometry/tracker and odometry/estimator.

``track`` runs on two rendered sweeps (features extracted by the JAX package
and carried across as numpy, so only the tracker differs): pose to 1e-4 rad /
1e-4 m. The window step (pre-filled window -> push + optimize + marginalize,
the step of ``__graft_entry__.entry()`` at small capacities) carries the whole
``WindowState`` across: poses to 1e-4, cost to 1e-3 relative, the new prior
to 1e-3 of its scale (a Schur complement of f32 sums taken in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mloam_tpu.config import SegmenterConfig as JSegCfg
from mloam_tpu.core import se3 as jse3
from mloam_tpu.core.rangeimage import LidarModel as JModel
from mloam_tpu.frontend import features as JF
from mloam_tpu.frontend import segmentation as JS
from mloam_tpu.frontend.features import FeatCloud as JFeatCloud
from mloam_tpu.models import platforms as jplatforms
from mloam_tpu.odometry import estimator as JE
from mloam_tpu.odometry import tracker as JT
from mloam_tpu.sim import world as JW
from mloam_tpu_torch.core import se3 as tse3
from mloam_tpu_torch.odometry import estimator as TE
from mloam_tpu_torch.odometry import tracker as TT
from mloam_tpu_torch.utils import convert


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def small_cfg():
    j = jplatforms.synthetic(n_lidars=1)
    j = dataclasses.replace(
        j,
        rig=dataclasses.replace(j.rig, models=(JModel(n_rings=8, n_cols=360),)),
        features=dataclasses.replace(j.features, cap_less_flat=512),
        odometry=dataclasses.replace(
            j.odometry, window_size=4, opt_window_size=2, cap_frame_corner=128,
            cap_frame_surf=256, localmap_precap_corner=256,
            localmap_precap_surf=640))
    return j, convert.config_from_reference(dataclasses.asdict(j))


def test_config_round_trip():
    j, t = small_cfg()
    assert dataclasses.asdict(t) == jax.tree.map(
        lambda x: x, dataclasses.asdict(j))
    assert t.rig.n_lidars == 1 and t.odometry.window_size == 4
    assert type(t.rig.models[0]).__module__.startswith("mloam_tpu_torch")


@pytest.fixture(scope="module")
def two_sweeps():
    jcfg, _ = small_cfg()
    model = jcfg.rig.models[0]
    w = JW.make_world(jax.random.PRNGKey(0))
    traj = JW.make_trajectory(jax.random.PRNGKey(1), speed_scale=2.0)
    imgs, gt = JW.render_sequence(w, traj, model, 2)
    ffs = []
    for i in range(2):
        img = type(imgs)(*(f[i] for f in imgs))
        seg = JS.segment(img, model, JSegCfg())
        ffs.append(JF.extract(img, seg.segmented, jcfg.features))
    rel = jse3.relative(jse3.Pose(gt.q[0], gt.t[0]), jse3.Pose(gt.q[1], gt.t[1]))
    return ffs, rel


def test_track_matches_reference(two_sweeps):
    (ff0, ff1), rel = two_sweeps
    jcfg, tcfg = small_cfg()
    jres, jdesk = JT.track(ff0, ff1, jse3.Pose.identity(), jcfg.tracker)
    t0 = convert.feature_frame_from_numpy(jax.tree.map(np.asarray, ff0))
    t1 = convert.feature_frame_from_numpy(jax.tree.map(np.asarray, ff1))
    tres, tdesk = TT.track(t0, t1, tse3.Pose.identity(), tcfg.tracker)
    dq = tse3.boxminus(tres.pose, convert.pose_from_numpy(jax.tree.map(np.asarray, jres.pose)))
    assert float(dq[3:].abs().max()) < 1e-4      # rad
    assert float(dq[:3].abs().max()) < 1e-4      # m
    assert int(tres.n_edge) == int(jres.n_edge) and int(tres.n_plane) == int(jres.n_plane)
    assert int(tres.n_plane) > 20
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=1e-2, atol=1e-6)
    np.testing.assert_allclose(N(tres.H), N(jres.H), rtol=1e-3, atol=1e-3 * np.abs(N(jres.H)).max())
    for a, b in zip(tdesk, jdesk):
        np.testing.assert_allclose(N(a.xyz), N(b.xyz), atol=1e-4)
    # and it moved towards the true motion: one solve of 3 GN iterations from
    # the identity on an 8-ring sensor closes most of the 9 cm / 50 mrad step
    # in both packages (the window solve refines the rest)
    rel_t = convert.pose_from_numpy(jax.tree.map(np.asarray, rel))
    err, step = tse3.boxminus(tres.pose, rel_t), tse3.log(rel_t)
    assert float(step[:3].norm()) > 0.05
    assert float(err[:3].norm()) < 0.5 * float(step[:3].norm())
    assert float(err[3:].norm()) < 0.5 * float(step[3:].norm())


def _example_frame(cfg, rng, shift):
    """A room corner sampled at the frame capacities, seen from a sensor
    shifted by ``shift`` along x (so successive frames overlap)."""
    nc, ns = cfg.odometry.cap_frame_corner, cfg.odometry.cap_frame_surf

    def walls(n):
        u = rng.uniform(-4, 4, size=(n, 2)).astype(np.float32)
        k = rng.integers(0, 3, size=n)
        p = np.where((k == 0)[:, None], np.stack([u[:, 0], u[:, 1], -1 + 0 * u[:, 0]], 1),
            np.where((k == 1)[:, None], np.stack([u[:, 0], 4 + 0 * u[:, 0], u[:, 1] * 0.5], 1),
                     np.stack([4 + 0 * u[:, 0], u[:, 0], u[:, 1] * 0.5], 1)))
        return p.astype(np.float32)

    def edges(n):
        t = rng.uniform(-1, 2, size=n).astype(np.float32)
        k = rng.integers(0, 3, size=n)
        p = np.where((k == 0)[:, None], np.stack([4 + 0 * t, 4 + 0 * t, t], 1),
            np.where((k == 1)[:, None], np.stack([t * 2, 4 + 0 * t, -1 + 0 * t], 1),
                     np.stack([4 + 0 * t, t * 2, -1 + 0 * t], 1)))
        return p.astype(np.float32)

    def cloud(xyz):
        n = xyz.shape[0]
        xyz = xyz - np.array([shift, 0, 0], np.float32)
        return JFeatCloud(xyz=jnp.asarray(xyz[None]), mask=jnp.asarray(rng.random((1, n)) < 0.9),
                          time=jnp.zeros((1, n)), ring=jnp.zeros((1, n), jnp.int32))

    return cloud(edges(nc)), cloud(walls(ns))


def test_window_step_matches_reference():
    jcfg, tcfg = small_cfg()
    rng = np.random.default_rng(0)
    jw = JE.init_window(jcfg, jcfg.odometry.cap_frame_corner, jcfg.odometry.cap_frame_surf)
    for i in range(jcfg.odometry.window_size):
        c, s = _example_frame(jcfg, rng, 0.05 * i)
        pose = jse3.Pose(jnp.array([1.0, 0, 0, 0]), jnp.array([0.05 * i, 0.0, 0.0]))
        jw = JE.push_frame(jw, pose, c, s, jcfg)
    c, s = _example_frame(jcfg, rng, 0.05 * 4)
    # the new frame enters 3 cm and 5 mrad off: the solve has work to do
    new_pose = jse3.boxplus(
        jse3.Pose(jnp.array([1.0, 0, 0, 0]), jnp.array([0.2, 0.0, 0.0])),
        jnp.array([0.03, -0.02, 0.01, 0.0, 0.0, 0.005]))

    tw = convert.window_state_from_numpy(jax.tree.map(np.asarray, jw))
    tc = convert.featcloud_from_numpy(jax.tree.map(np.asarray, c))
    ts = convert.featcloud_from_numpy(jax.tree.map(np.asarray, s))
    tpose = convert.pose_from_numpy(jax.tree.map(np.asarray, new_pose))

    # local map first: same voxels on both sides
    jm = JE.build_local_map(jw, jcfg)
    tm = TE.build_local_map(tw, tcfg)
    for a, b in ((tm[1], jm[1]), (tm[3], jm[3])):
        np.testing.assert_array_equal(N(a), N(b))
    np.testing.assert_allclose(N(tm[2])[N(tm[3])], N(jm[2])[N(jm[3])], atol=1e-5)

    jw2 = JE.push_frame(jw, new_pose, c, s, jcfg)
    jw2, jsolve = JE.optimize_window(jw2, jcfg)
    jw3 = JE.marginalize_pivot(jw2, jsolve, jcfg)
    tw2 = TE.push_frame(tw, tpose, tc, ts, tcfg)
    tw2, tsolve = TE.optimize_window(tw2, tcfg)
    tw3 = TE.marginalize_pivot(tw2, tsolve, tcfg)

    assert int(tw3.count) == int(jw3.count) == 5
    assert int(tsolve.n_surf) > 100 and int(tsolve.n_corner) > 20
    assert abs(int(tsolve.n_surf) - int(jsolve.n_surf)) <= 2
    assert abs(int(tsolve.n_corner) - int(jsolve.n_corner)) <= 2
    np.testing.assert_allclose(N(tw3.poses.q), N(jw3.poses.q), atol=1e-4)
    np.testing.assert_allclose(N(tw3.poses.t), N(jw3.poses.t), atol=1e-4)
    np.testing.assert_allclose(float(tsolve.cost), float(jsolve.cost), rtol=1e-3, atol=1e-6)
    sc = np.abs(N(jsolve.H)).max()
    np.testing.assert_allclose(N(tsolve.H), N(jsolve.H), atol=1e-3 * sc)
    np.testing.assert_allclose(N(tsolve.H_anchor), N(jsolve.H_anchor), atol=1e-3 * sc)
    np.testing.assert_allclose(N(tsolve.eig_blocks), N(jsolve.eig_blocks), rtol=1e-3, atol=1e-3 * sc)
    np.testing.assert_allclose(N(tsolve.frozen), N(jsolve.frozen), atol=1e-4)
    psc = np.abs(N(jw3.prior.H)).max()
    np.testing.assert_allclose(N(tw3.prior.H), N(jw3.prior.H), atol=1e-3 * psc)
    np.testing.assert_allclose(N(tw3.prior.b), N(jw3.prior.b),
                               atol=1e-3 * max(np.abs(N(jw3.prior.b)).max(), 1.0))
    assert bool(tw3.prior.valid)
    np.testing.assert_allclose(N(tw3.prior_poses.t), N(jw3.prior_poses.t), atol=1e-4)
    # the solve pulled the new frame back towards where the geometry puts it
    assert float(tw3.poses.t[-1, 0]) < 0.2 + 0.03 - 0.01
    # the prior's linearization points do not alias the live window
    assert tw3.prior_poses.t.data_ptr() != tw3.poses.t.data_ptr()


def test_window_helpers():
    _, tcfg = small_cfg()
    w = TE.init_window(tcfg, 8, 16, device="cpu")
    assert w.corner.xyz.shape == (5, 1, 8, 3) and w.surf.mask.shape == (5, 1, 16)
    assert TE.prior_dim(tcfg, False) == 18 and TE.prior_dim(tcfg, True) == 18
    w2 = TE.reset_prior(w, tcfg, calibrate_ext=False)
    assert w2.prior_poses.q.data_ptr() != w2.poses.q.data_ptr()
    ext = tse3.Pose(torch.tensor([[0.0, 1.0, 0, 0]]), torch.ones(1, 3))
    assert torch.equal(TE.set_extrinsics(w, ext).ext.t, ext.t)
    w3 = TE.drop_prior(w._replace(prior=w.prior._replace(valid=torch.tensor(True))), tcfg)
    assert not bool(w3.prior.valid) and w3.prior.H.shape == (18, 18)
