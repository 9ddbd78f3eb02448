"""Checkpoint / resume of the port against the JAX package's, at 8x360.

The file format is the JAX package's: for fresh pipelines of all three
kinds the two packages write the same keys with the same shapes (dtypes
differ where the port keeps int64), and a file either one writes loads into
the other's pipeline, every leaf equal to the bit after the dtype cast. A
generic tree round-trips with its meta, each leaf back in its template's
kind (tensor device and dtype, host int), and a missing field raises
``KeyError``. A pipeline restored past the window size re-enters through the
first-sweep branch in both packages (its output pose is the restored world
pose, to the bit, and the window is pushed), where the port would have
handed ``None`` to its steady step before ``_is_steady`` required the
previous sweep's features. ``save_pipeline`` flushes a ``SlamPipeline``
before it captures the loop graph."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from mloam_tpu.core.rangeimage import LidarModel as JModel
from mloam_tpu.core.rangeimage import RangeImage as JRangeImage
from mloam_tpu.models import pipeline as JP
from mloam_tpu.models import platforms as jplatforms
from mloam_tpu.utils import checkpoint as JCK
from mloam_tpu_torch.core.rangeimage import RangeImage
from mloam_tpu_torch.models import pipeline as TP
from mloam_tpu_torch.models import run_synthetic
from mloam_tpu_torch.odometry.initializer import MotionBuffer
from mloam_tpu_torch.utils import checkpoint as TCK
from mloam_tpu_torch.utils import convert


def small_cfgs(**mapping):
    j = jplatforms.synthetic(n_lidars=1)
    j = dataclasses.replace(
        j,
        rig=dataclasses.replace(j.rig, models=(JModel(n_rings=8, n_cols=360),)),
        features=dataclasses.replace(j.features, cap_less_flat=512),
        odometry=dataclasses.replace(
            j.odometry, window_size=4, opt_window_size=2, cap_frame_corner=128,
            cap_frame_surf=256, localmap_precap_corner=256, localmap_precap_surf=640),
        mapping=dataclasses.replace(j.mapping, max_keyframes=8, cap_map_corner=1024,
                                    cap_map_surf=2048, **mapping),
        loop=dataclasses.replace(j.loop, capacity=8, skip_interval=1))
    return j, convert.config_from_reference(dataclasses.asdict(j))


KINDS = {"odom": (JP.OdometryPipeline, TP.OdometryPipeline),
         "full": (JP.FullPipeline, TP.FullPipeline),
         "slam": (JP.SlamPipeline, TP.SlamPipeline)}


def _frames(tcfg, n):
    imgs, _ = run_synthetic.render(tcfg, n, seed=0, device="cpu")
    return [RangeImage(*(f[i] for f in imgs)) for i in range(n)]


@pytest.fixture(scope="module")
def cfgs():
    return small_cfgs()


@pytest.fixture(scope="module")
def run_states(cfgs, tmp_path_factory):
    """Each kind of port pipeline after 6 sweeps (past the 4-sweep window:
    mapped sweeps and keyframes in the full and slam kinds), saved."""
    _, tcfg = cfgs
    frames = _frames(tcfg, 7)
    d = tmp_path_factory.mktemp("ck")
    out = {}
    for kind, (_, TC) in KINDS.items():
        pipe = TC(tcfg, device="cpu")
        for f in frames[:6]:
            pipe.process([f])
        path = str(d / f"{kind}.npz")
        TCK.save_pipeline(path, pipe)
        out[kind] = (pipe, path)
    return out, frames


def _load(path):
    with np.load(path) as z:
        return dict(z)


def test_generic_tree_round_trips_in_its_templates_kinds(tmp_path):
    buf = MotionBuffer.empty(8, "cpu")._replace(
        head=torch.tensor(5, dtype=torch.int32),
        ref_t=torch.arange(24, dtype=torch.float32).reshape(8, 3))
    tree = (buf, 7, [torch.ones(2, dtype=torch.int64)], None)
    path = str(tmp_path / "t.npz")
    TCK.save_state(path, tree, meta={"note": "x"})
    template = (MotionBuffer.empty(8, "cpu"), 0, [torch.zeros(2, dtype=torch.int64)], None)
    (out, n, lst, none), meta = TCK.load_state(path, template)
    assert meta == {"note": "x"}
    assert out.head.dtype == torch.int32 and int(out.head) == 5
    assert torch.equal(out.ref_t, buf.ref_t) and out.ref_t.dtype == torch.float32
    assert isinstance(n, int) and n == 7 and isinstance(lst, list) and none is None
    assert torch.equal(lst[0], torch.ones(2, dtype=torch.int64))
    # the JAX package reads the same file into its own MotionBuffer
    from mloam_tpu.odometry.initializer import MotionBuffer as JBuf

    jtree, jmeta = JCK.load_state(path, (JBuf.empty(8), 0, [np.zeros(2)], None))
    assert int(jtree[0].head) == 5 and jmeta == meta
    np.testing.assert_array_equal(np.asarray(jtree[0].ref_t), buf.ref_t.numpy())


def test_a_missing_field_raises_key_error(tmp_path):
    path = str(tmp_path / "t.npz")
    TCK.save_state(path, MotionBuffer.empty(4, "cpu"))
    data = _load(path)
    del data["tgt_t"]
    np.savez_compressed(path, **data)
    with pytest.raises(KeyError, match="tgt_t"):
        TCK.load_state(path, MotionBuffer.empty(4, "cpu"))
    with pytest.raises(KeyError, match="tgt_t"):   # as the JAX package does
        from mloam_tpu.odometry.initializer import MotionBuffer as JBuf

        JCK.load_state(path, JBuf.empty(4))


@pytest.mark.parametrize("kind", list(KINDS))
def test_fresh_pipelines_write_the_same_keys_and_shapes(kind, cfgs, tmp_path):
    jcfg, tcfg = cfgs
    JC, TC = KINDS[kind]
    JCK.save_pipeline(str(tmp_path / "j.npz"), JC(jcfg))
    TCK.save_pipeline(str(tmp_path / "t.npz"), TC(tcfg, device="cpu"))
    j, t = _load(tmp_path / "j.npz"), _load(tmp_path / "t.npz")
    assert sorted(j) == sorted(t)
    assert {k: j[k].shape for k in j} == {k: t[k].shape for k in t}
    widened = {k for k in j if j[k].dtype != t[k].dtype}
    assert all(j[k].dtype == np.int32 and t[k].dtype == np.int64 for k in widened), widened
    assert json.loads(bytes(j["__meta__"])) == json.loads(bytes(t["__meta__"]))


def _leaves_equal(path_a, path_b):
    a, b = _load(path_a), _load(path_b)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k].astype(a[k].dtype), err_msg=k)


@pytest.mark.parametrize("kind", list(KINDS))
def test_files_load_across_the_two_packages(kind, cfgs, run_states, tmp_path):
    """The port's file -> the JAX package's pipeline -> its file -> the
    port's pipeline -> its file: every leaf the port wrote comes back."""
    jcfg, tcfg = cfgs
    JC, TC = KINDS[kind]
    pipe, path = run_states[0][kind]
    jpipe = JC(jcfg)
    JCK.load_pipeline(path, jpipe)
    o = jpipe.full.odom if kind == "slam" else jpipe.odom if kind == "full" else jpipe
    to = pipe.full.odom if kind == "slam" else pipe.odom if kind == "full" else pipe
    assert o.frame_idx == to.frame_idx == 6
    np.testing.assert_array_equal(np.asarray(o.window.poses.t), to.window.poses.t.numpy())
    JCK.save_pipeline(str(tmp_path / "j.npz"), jpipe)
    _leaves_equal(path, tmp_path / "j.npz")
    tpipe = TC(tcfg, device="cpu")
    TCK.load_pipeline(str(tmp_path / "j.npz"), tpipe)
    TCK.save_pipeline(str(tmp_path / "t.npz"), tpipe)
    _leaves_equal(path, tmp_path / "t.npz")
    if kind != "odom":
        ms = (tpipe.full if kind == "slam" else tpipe).mapper_state
        assert isinstance(ms.step, int) and ms.step > 0
        assert ms.db.head.dtype == (pipe.full if kind == "slam" else pipe).mapper_state.db.head.dtype
        assert int(ms.db.valid.sum()) >= 1
    if kind == "slam":
        assert tpipe.loop_kf_count == pipe.loop_kf_count == int(tpipe.loop_state.count)
        assert tpipe.kf_counter == pipe.kf_counter


@pytest.mark.parametrize("kind", ["odom", "full"])
def test_a_restored_pipeline_reenters_through_the_first_sweep_branch(kind, cfgs, run_states):
    """Both packages restore the same file and take the next sweep through
    the first-sweep branch: no tracking, the output pose is the restored
    world pose, the window pushed by one slot. Then the port tracks again."""
    jcfg, tcfg = cfgs
    JC, TC = KINDS[kind]
    (_, path), frames = run_states[0][kind], run_states[1]
    tpipe, jpipe = TC(tcfg, device="cpu"), JC(jcfg)
    TCK.load_pipeline(path, tpipe)
    JCK.load_pipeline(path, jpipe)
    to = tpipe.odom if kind == "full" else tpipe
    jo = jpipe.odom if kind == "full" else jpipe
    assert to.frame_idx >= tcfg.odometry.window_size and to.prev_feats[0] is None
    assert not to._is_steady()
    with pytest.raises(RuntimeError, match="steady"):
        to.process_chunk(RangeImage(*(x[None] for x in frames[6])))
    w_before = to.window.poses.t.clone()
    world = to.world_pose.t.clone()
    tout = tpipe.process([frames[6]])
    jimg = JRangeImage(*(jax.numpy.asarray(x.numpy()) for x in frames[6]))
    jout = jpipe.process([jimg])
    todom = tout.odom if kind == "full" else tout
    jodom = jout.odom if kind == "full" else jout
    assert torch.equal(todom.pose.t, world) and torch.equal(todom.pose_predict.t, world)
    np.testing.assert_array_equal(np.asarray(jodom.pose.t), world.numpy())
    assert float(todom.cost) == 0.0 and todom.win_eig is None   # no solve ran
    assert to.prev_feats[0] is not None and to.frame_idx == 7 == jo.frame_idx
    np.testing.assert_array_equal(to.window.poses.t[:-1].numpy(), w_before[1:].numpy())
    np.testing.assert_array_equal(to.window.poses.t[-1].numpy(), world.numpy())
    np.testing.assert_array_equal(np.asarray(jo.window.poses.t), to.window.poses.t.numpy())
    if kind == "full":
        assert tout.mapped == jout.mapped
    nxt = tpipe.process([frames[5]])     # the steady step again: it tracks
    nodom = nxt.odom if kind == "full" else nxt
    assert nodom.win_eig is not None and bool(torch.isfinite(nodom.pose.t).all())


def test_save_flushes_a_slam_pipeline_before_capturing(tmp_path):
    """As tests/test_checkpoint.py:58-100 at 8x360: a small loop course with
    a keyframe every 0.3 m and mapping on every sweep, saved with a keyframe
    in flight; the restored graph's keyframe count equals the stored one."""
    _, tcfg = small_cfgs(keyframe_dist=0.3, skip_frames=1)
    tcfg = dataclasses.replace(tcfg, loop=dataclasses.replace(tcfg.loop, capacity=32))
    imgs, _ = run_synthetic.render_rig(tcfg, 12, seed=2, device="cpu",
                                       world={"extent": 25.0},
                                       loop={"radius": 5.0, "period_s": 8.0})
    pipe = TP.SlamPipeline(tcfg, device="cpu")
    for i in range(12):
        pipe.process([RangeImage(*(f[i] for f in imgs[0]))])
    assert pipe._pending_kf is not None or pipe._pending_verify is not None
    count_before = pipe.loop_kf_count
    path = str(tmp_path / "slam.npz")
    TCK.save_pipeline(path, pipe)
    assert pipe._pending_kf is None and pipe._pending_verify is None
    assert pipe.loop_kf_count >= count_before
    pipe2 = TP.SlamPipeline(tcfg, device="cpu")
    TCK.load_pipeline(path, pipe2)
    stored = int(pipe2.loop_state.count)
    assert pipe2.loop_kf_count == stored == pipe.loop_kf_count >= 1
    assert pipe2.kf_counter == pipe.kf_counter
    out = pipe2.process([RangeImage(*(f[11] for f in imgs[0]))])
    assert bool(torch.isfinite(out.full.map_pose.t).all())
