"""Port vs JAX package: the multi-LiDAR pipeline (dual rig, known
extrinsics, ESTIMATE_EXTRINSIC 0), ``_prep_frame`` per lidar, and chunked
replay, at small width (8x360 range images, caps 128/256, window 4/2).

The JAX package renders both lidars' sequences (lidar 1 mounted at the
JAX e2e test's extrinsic, 30 deg of yaw and 38 cm off) and the port sees
those renderings, so only the pipelines differ. Poses agree to 1 cm / 2 mrad
per frame, the bound of ``tests/test_torch_pipeline.py`` for the same
8-ring sensor. The JAX pipeline streams the first ``window_size`` sweeps and
replays the rest with its ``process_chunk``; the port streams all of them,
and a second port pipeline replays the same tail with its own
``process_chunk``, which must give the streaming state exactly.
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
from mloam_tpu.core.rangeimage import RangeImage as JRangeImage
from mloam_tpu.frontend.features import FeatCloud as JFeatCloud
from mloam_tpu.models import platforms as jplatforms
from mloam_tpu.models.pipeline import OdometryPipeline as JPipeline
from mloam_tpu.odometry import estimator as JE
from mloam_tpu.sim import world as JW
from mloam_tpu_torch.core import se3 as tse3
from mloam_tpu_torch.core.rangeimage import RangeImage
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.models.pipeline import OdometryPipeline
from mloam_tpu_torch.utils import convert, evaluation

N_FRAMES = 7
X_Q = [0.9659258, 0.0, 0.0, 0.258819]
X_T = [0.3, -0.2, 0.1]


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def small_cfg(n_lidars=2, extrinsic_mode=0, **calib):
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


def jext():
    I0 = jse3.Pose.identity()
    return jse3.Pose(jnp.stack([I0.q, jnp.asarray(X_Q, jnp.float32)]),
                     jnp.stack([I0.t, jnp.asarray(X_T, jnp.float32)]))


@pytest.fixture(scope="module")
def rig():
    jcfg, tcfg = small_cfg()
    w = JW.make_world(jax.random.PRNGKey(0))
    traj = JW.make_trajectory(jax.random.PRNGKey(1))
    model = jcfg.rig.models[0]
    ext = jext()
    imgs0, gt = JW.render_sequence(w, traj, model, N_FRAMES)
    imgs1, _ = JW.render_sequence(w, traj, model, N_FRAMES,
                                  extrinsic=jse3.Pose(ext.q[1], ext.t[1]))
    return jcfg, tcfg, (imgs0, imgs1), gt


def tframes(seqs, i):
    return [convert.range_image_from_numpy(tuple(np.asarray(f[i]) for f in s))
            for s in seqs]


def tstacked(seqs, lo, hi):
    return tuple(convert.range_image_from_numpy(tuple(np.asarray(f[lo:hi]) for f in s))
                 for s in seqs)


def tpipe(tcfg):
    pipe = OdometryPipeline(tcfg, device="cpu")
    pipe.set_extrinsics(convert.pose_from_numpy(jax.tree.map(np.asarray, jext())))
    return pipe


def test_dual_rig_matches_reference_and_chunked_replay_equals_streaming(rig):
    jcfg, tcfg, seqs, gt = rig
    ws = jcfg.odometry.window_size
    jpipe = JPipeline(jcfg)
    jpipe.window = JE.set_extrinsics(jpipe.window, jext())
    jt, jq = [], []
    for i in range(ws):
        out = jpipe.process([JRangeImage(*(f[i] for f in s)) for s in seqs])
        jt.append(N(out.pose.t)), jq.append(N(out.pose.q))
    stacked = tuple(JRangeImage(*(f[ws:] for f in s)) for s in seqs)
    q, t, *_ = jpipe.process_chunk(stacked)
    jt, jq = np.concatenate([np.stack(jt), N(t)]), np.concatenate([np.stack(jq), N(q)])

    # the port, streaming
    a = tpipe(tcfg)
    tt, tq, outs = [], [], []
    for i in range(N_FRAMES):
        out = a.process(tframes(seqs, i))
        tt.append(N(out.pose.t)), tq.append(N(out.pose.q))
        outs.append(out)
    tt, tq = np.stack(tt), np.stack(tq)
    assert all(o.ext_mode == 0 for o in outs)
    assert a.frame_idx == N_FRAMES and bool(a.window.prior.valid)
    assert outs[-1].win_eig.shape == (3, 6)
    assert len(a.last_outlier) == 2 and a.last_outlier[1].mask.any()
    assert np.isfinite(tt).all() and np.isfinite(tq).all()
    d = tse3.boxminus(Pose(torch.from_numpy(tq), torch.from_numpy(tt)),
                      Pose(torch.from_numpy(jq), torch.from_numpy(jt)))
    assert float(d[:, :3].norm(dim=-1).max()) < 0.01       # 1 cm
    assert float(d[:, 3:].norm(dim=-1).max()) < 2e-3       # 2 mrad
    g = N(gt.t)[:N_FRAMES]
    ate_t, ate_j = evaluation.ate_rmse(tt, g), evaluation.ate_rmse(jt, g)
    assert ate_t <= ate_j + 0.01 and ate_t < 0.05

    # the port, chunked: the same state as streaming, exactly
    b = tpipe(tcfg)
    for i in range(ws):
        b.process(tframes(seqs, i))
    with pytest.raises(RuntimeError, match="steady"):
        tpipe(tcfg).process_chunk(tstacked(seqs, ws, N_FRAMES))
    cq, ct, pq, pt, cost, nc, ns = b.process_chunk(tstacked(seqs, ws, N_FRAMES))
    k = N_FRAMES - ws
    assert cq.shape == (k, 4) and ct.shape == (k, 3) and cost.shape == (k,)
    assert torch.equal(ct, torch.from_numpy(tt[ws:]))
    assert torch.equal(cq, torch.from_numpy(tq[ws:]))
    assert torch.equal(pt, torch.stack([o.pose_predict.t for o in outs[ws:]]))
    assert torch.equal(ns, torch.stack([o.n_surf for o in outs[ws:]]))
    assert b.frame_idx == a.frame_idx
    for x, y in zip(convert.to_numpy(b.window), convert.to_numpy(a.window)):
        for u, v in zip(jax.tree.leaves(x), jax.tree.leaves(y)):
            np.testing.assert_array_equal(u, v)
    assert torch.equal(b.motions[0].t, a.motions[0].t)
    assert torch.equal(b.last_outlier[1].xyz, a.last_outlier[1].xyz)


@pytest.mark.parametrize("mode2", [False, True], ids=["through_extrinsic", "own_motion"])
def test_prep_frame_matches_reference_per_lidar(rig, mode2):
    """Lidar l is de-skewed with E⁻¹∘M∘E (modes 0 and 1) or, in mode 2,
    with its own tracked motion; lidar 0 always with the reference motion."""
    jcfg, tcfg, _, _ = rig
    rng = np.random.default_rng(3)
    n = 64
    motion0 = jse3.exp(jnp.array([0.4, 0.05, 0.01, 0.01, -0.02, 0.08]))
    motion1 = jse3.exp(jnp.array([0.1, -0.3, 0.02, 0.03, 0.01, 0.06]))

    def cloud():
        return JFeatCloud(
            xyz=jnp.asarray(rng.uniform(-20, 20, (n, 3)).astype(np.float32)),
            mask=jnp.asarray(rng.random(n) < 0.8),
            time=jnp.asarray(rng.random(n).astype(np.float32)),
            ring=jnp.zeros((n,), jnp.int32))

    corners, surfs = (cloud(), cloud()), (cloud(), cloud())
    # the JAX method reads one attribute of its pipeline, the config
    jc, js = JPipeline._prep_frame(
        types.SimpleNamespace(cfg=jcfg), jext(), motion0, (motion0, motion1), corners, surfs, mode2)
    tp = OdometryPipeline(tcfg, device="cpu")
    c_ = lambda f: convert.featcloud_from_numpy(jax.tree.map(np.asarray, f))
    p_ = lambda p: convert.pose_from_numpy(jax.tree.map(np.asarray, p))
    tc, ts = tp._prep_frame(p_(jext()), p_(motion0), (p_(motion0), p_(motion1)),
                            [c_(c) for c in corners], [c_(s) for s in surfs], mode2)
    assert tc.xyz.shape == (2, n, 3)
    for t, j in ((tc, jc), (ts, js)):
        for l in range(2):
            np.testing.assert_allclose(N(t.xyz[l]), N(j.xyz[l]), atol=2e-5)
        np.testing.assert_array_equal(N(t.mask), N(j.mask))
    # the two modes really de-skew lidar 1 differently
    other, _ = tp._prep_frame(p_(jext()), p_(motion0), (p_(motion0), p_(motion1)),
                              [c_(c) for c in corners], [c_(s) for s in surfs], not mode2)
    assert float((other.xyz[1] - tc.xyz[1]).abs().max()) > 1e-3
    assert torch.equal(other.xyz[0], tc.xyz[0])


def test_four_lidar_rig_in_mode_2_tracks_every_lidar():
    """Mode-2 start with three unknown extrinsics, through ``run``: every
    non-reference lidar is tracked on its own and its screw-consistent pairs
    fill its own hand-eye buffer; the window solve matches the reference
    lidar only."""
    from mloam_tpu_torch.models import run_synthetic

    _, tcfg = small_cfg(n_lidars=4, extrinsic_mode=2)
    exts = tse3.exp(torch.tensor([[0.0] * 6,
                                  [0.25, -0.1, 0.05, 0.05, -0.03, 0.5],
                                  [-0.2, 0.15, -0.05, -0.04, 0.06, -0.4],
                                  [0.1, 0.3, 0.02, 0.03, -0.05, 1.0]]))
    n = 8
    seen = []

    def on_sweep(i, out, pipe):
        assert torch.isfinite(out.pose.t).all()
        seen.append((i, out, pipe))

    res = run_synthetic.run(n_frames=n, seed=0, verbose=False, device="cpu", cfg=tcfg,
                            extrinsics=exts, install_extrinsics=False, wobble=0.25,
                            on_sweep=on_sweep)
    assert [x[0] for x in seen] == list(range(n))
    _, out, pipe = seen[-1]
    assert res["modes"] == [2] * n and pipe.ext_mode == 2
    # nothing installed: every lidar's estimate is still the identity
    assert len(res["ext_err"]) == n and len(res["ext_err"][-1]) == 3
    assert res["ext_err"][-1][0] == pytest.approx((0.5033885, 0.2738613), rel=1e-4)
    assert out.win_eig.shape == (3, 6)              # poses only: no extrinsic blocks
    for l in (1, 2, 3):
        assert int(pipe.calib_buffers[l].head) > 0, f"lidar {l} gathered no pairs"
        assert not torch.equal(pipe.motions[l].t, pipe.motions[0].t)
    assert int(pipe.calib_buffers[0].head) == 0
    assert len(res["sweep_ms"]) == n
    assert res["ate_m"] < 0.05
