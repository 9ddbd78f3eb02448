"""The slice as a whole: rendered sweep to refined pose, port vs JAX package.

The JAX package's ``World`` and ``Trajectory`` are carried across as numpy
(the two packages draw different worlds from the same seed). Rendering must
agree to 1e-4 m of range (grazing rays apart, see the test); the same 7 sweeps then go through both
``OdometryPipeline``s at a small width (8x360 range image, caps 128/256,
window 4/2), which takes the port through every stage of ``process``: first
frame, warm-up, warm window step and the steady step.

Pose agreement: the two sides run the same algorithm in f32 with different
summation orders, different k-NN distance forms and, on a threshold pixel,
possibly one feature more or less. On this 8-ring sensor the problem is
poorly conditioned in yaw, and the difference grows along the sequence:
observed 1.5 mm and 1.7 mrad at the seventh sweep. The stated bound is
1 cm / 2 mrad per frame, and the port's ATE may exceed the JAX package's by
at most 1 cm.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mloam_tpu.core.rangeimage import LidarModel as JModel
from mloam_tpu.core.rangeimage import RangeImage as JRangeImage
from mloam_tpu.models import platforms as jplatforms
from mloam_tpu.models.pipeline import OdometryPipeline as JPipeline
from mloam_tpu.sim import world as JW
from mloam_tpu_torch.core import rangeimage as TRI
from mloam_tpu_torch.core import se3 as tse3
from mloam_tpu_torch.models.pipeline import OdometryPipeline
from mloam_tpu_torch.sim import world as TW
from mloam_tpu_torch.utils import convert, evaluation

N_FRAMES = 7


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


@pytest.fixture(scope="module")
def sequences():
    jcfg, tcfg = small_cfg()
    jw = JW.make_world(jax.random.PRNGKey(0))
    jtraj = JW.make_trajectory(jax.random.PRNGKey(1))
    jimgs, jgt = JW.render_sequence(jw, jtraj, jcfg.rig.models[0], N_FRAMES)
    tw = convert.world_from_numpy(jax.tree.map(np.asarray, jw))
    ttraj = convert.trajectory_from_numpy(
        (np.asarray(jtraj.amp), np.asarray(jtraj.freq), np.asarray(jtraj.phase),
         jtraj.yaw_rate, jtraj.wobble))
    timgs, tgt = TW.render_sequence(tw, ttraj, tcfg.rig.models[0], N_FRAMES,
                                    device="cpu")
    return jcfg, tcfg, jimgs, jgt, timgs, tgt


def test_render_sequence_matches_reference(sequences):
    _, _, jimgs, jgt, timgs, tgt = sequences
    np.testing.assert_allclose(N(tgt.t), N(jgt.t), atol=1e-6)
    np.testing.assert_allclose(N(tgt.q), N(jgt.q), atol=1e-6)
    jv, tv = N(jimgs.valid), N(timgs.valid)
    # a ray grazing a wall's edge can hit on one side only: 1 of the 20160
    # rays of these 7 sweeps does
    assert (jv != tv).sum() <= 1
    assert tv.mean() > 0.5
    both = jv & tv
    # ranges agree to 1e-4 m, except rays that graze the ground far out: there
    # t = h / (d.n) divides by ~0.015, which amplifies the last-ulp difference
    # of the interpolated ray direction some 70 times (observed: 0.18 % of
    # the rays beyond 1e-4 m, the worst 4.3 mm at 24 m)
    err = np.abs(N(timgs.rng)[both] - N(jimgs.rng)[both])
    assert (err > 1e-4).mean() < 0.005
    assert err.max() < 5e-3
    np.testing.assert_allclose(N(timgs.xyz)[both], N(jimgs.xyz)[both], atol=5e-3)
    # j / C: XLA multiplies by the reciprocal, PyTorch divides — one ulp
    np.testing.assert_allclose(N(timgs.time), N(jimgs.time), atol=1e-7)


def test_unit_rays_and_wire_format(sequences):
    jcfg, tcfg, jimgs, _, timgs, _ = sequences
    from mloam_tpu.core import rangeimage as JRI

    jm, tm = jcfg.rig.models[0], tcfg.rig.models[0]
    np.testing.assert_allclose(N(TRI.unit_rays(tm)), N(JRI.unit_rays(jm)), atol=1e-6)
    jimg = JRangeImage(*(f[2] for f in jimgs))
    timg = TRI.RangeImage(*(f[2] for f in timgs))
    jp, tp = JRI.pack_frame(jimg), TRI.pack_frame(timg)
    # quantised to 2 mm counts: a range within 1e-4 m of a count boundary may
    # round either way
    assert np.abs(jp.rng_q.astype(np.int64) - tp.rng_q.astype(np.int64)).max() <= 1
    ju = JRI.unpack_frame(JRI.PackedFrame(jnp.asarray(jp.rng_q), jnp.asarray(jp.intensity_q)),
                          JRI.unit_rays(jm), jm)
    tu = TRI.unpack_frame(TRI.PackedFrame(jp.rng_q, jp.intensity_q), TRI.unit_rays(tm), tm)
    np.testing.assert_array_equal(N(tu.valid), N(ju.valid))
    np.testing.assert_array_equal(N(tu.rng), N(ju.rng))     # bit-equal ranges
    np.testing.assert_allclose(N(tu.xyz), N(ju.xyz), atol=1e-5)
    flat = TRI.flatten(tu)
    assert flat[0].shape == (8 * 360, 3) and flat[1].dtype == torch.bool


def test_pipeline_matches_reference(sequences):
    jcfg, tcfg, jimgs, jgt, timgs, tgt = sequences
    jpipe = JPipeline(jcfg)
    tpipe = OdometryPipeline(tcfg, device="cpu")
    jt, jq, tt, tq = [], [], [], []
    for i in range(N_FRAMES):
        jout = jpipe.process([JRangeImage(*(f[i] for f in jimgs))])
        # the port sees the JAX package's rendering, so only the pipeline differs
        timg = convert.range_image_from_numpy(
            tuple(np.asarray(f[i]) for f in jimgs))
        tout = tpipe.process([timg])
        jt.append(N(jout.pose.t)), jq.append(N(jout.pose.q))
        tt.append(N(tout.pose.t)), tq.append(N(tout.pose.q))
        assert tout.ext_mode == 0
    assert tpipe.frame_idx == N_FRAMES and int(tpipe.window.count) == 5
    assert bool(tpipe.window.prior.valid)            # the steady step ran
    assert tout.win_eig is not None and tout.win_eig.shape == (3, 6)
    jt, jq, tt, tq = map(np.stack, (jt, jq, tt, tq))
    assert np.isfinite(tt).all() and np.isfinite(tq).all()
    d = tse3.boxminus(tse3.Pose(torch.from_numpy(tq), torch.from_numpy(tt)),
                      tse3.Pose(torch.from_numpy(jq), torch.from_numpy(jt)))
    assert float(d[:, :3].norm(dim=-1).max()) < 0.01       # 1 cm
    assert float(d[:, 3:].norm(dim=-1).max()) < 2e-3       # 2 mrad
    gt = N(jgt.t)
    ate_t = evaluation.ate_rmse(tt, gt)
    ate_j = evaluation.ate_rmse(jt, gt)
    assert ate_t <= ate_j + 0.01
    assert ate_t < 0.05
    # the last outlier cloud is kept for the mapper, as in the JAX package
    np.testing.assert_array_equal(N(tpipe.last_outlier[0].mask),
                                  N(jpipe.last_outlier[0].mask))


def test_pipeline_reset_and_packed_input(sequences):
    _, tcfg, _, _, timgs, _ = sequences
    pipe = OdometryPipeline(tcfg, device="cpu")
    img = TRI.RangeImage(*(f[0] for f in timgs))
    a = pipe.process([img])
    pipe.process([TRI.RangeImage(*(f[1] for f in timgs))])
    pipe.reset()
    assert pipe.frame_idx == 0 and int(pipe.window.count) == 0
    b = pipe.process([TRI.pack_frame(img)])       # wire-format input
    assert torch.equal(a.pose.t, b.pose.t)
    assert int(pipe.window.corner.mask[-1].sum()) > 0


def test_run_synthetic_small_on_cpu():
    from mloam_tpu_torch.models import run_synthetic

    _, tcfg = small_cfg()
    res = run_synthetic.run(n_frames=6, seed=3, verbose=False, device="cpu", cfg=tcfg)
    assert res["n_frames"] == 6 and res["device"] == "cpu"
    assert np.isfinite(res["est_t"]).all() and res["ate_m"] < 0.05


def test_process_chunk_of_one_lidar_equals_streaming(sequences):
    """Chunked replay of one lidar's wire-format sweeps (a PackedFrame with a
    leading K axis) leaves the state exactly where K ``process`` calls do."""
    _, tcfg, _, _, timgs, _ = sequences
    packed = [TRI.pack_frame(TRI.RangeImage(*(f[i] for f in timgs)))
              for i in range(N_FRAMES)]
    ws = tcfg.odometry.window_size
    a = OdometryPipeline(tcfg, device="cpu")
    outs = [a.process([p]) for p in packed]
    b = OdometryPipeline(tcfg, device="cpu")
    for p in packed[:ws]:
        b.process([p])
    tail = TRI.PackedFrame(*(np.stack(f) for f in zip(*packed[ws:])))
    q, t, pq, pt, cost, nc, ns = b.process_chunk(tail)
    assert t.shape == (N_FRAMES - ws, 3)
    assert torch.equal(t, torch.stack([o.pose.t for o in outs[ws:]]))
    assert torch.equal(q, torch.stack([o.pose.q for o in outs[ws:]]))
    assert torch.equal(cost, torch.stack([o.cost for o in outs[ws:]]))
    assert torch.equal(b.window.prior.H, a.window.prior.H)
    assert b.frame_idx == a.frame_idx == N_FRAMES
