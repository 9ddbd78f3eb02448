"""The batched frontend of a uniform rig (the steady step of a rig whose
lidars share one sensor model): the port against itself and against the JAX
package, at 8x360.

- Label propagation over a batch ``[B, R, C]`` (the plain version, what a CPU
  tensor runs) is integer-exact against the TPU kernel under ``jax.vmap``,
  run in interpret mode as ``tests/test_torch_labels.py`` runs it.
- The batched frontend (``unpack_frame`` -> ``segment`` -> ``extract`` ->
  the three ``downsample_featcloud``s) gives each lidar the outputs of its
  own unrolled frontend to the bit, for rigs of 2 and 4 lidars, from range
  images and from packed frames, and where one lidar's coordinates are 10x
  another's: each lidar's voxel sums keep their own fixed-point scale.
- It agrees with the JAX package's vmapped ``_frontend_impl`` within the
  bounds of ``tests/test_torch_frontend.py``.
- ``OdometryPipeline`` with the batched frontend gives the poses and window
  of the unrolled frontends (what a mixed rig runs) to the bit, streaming and
  through ``process_chunk``, with one label call for the rig on each steady
  sweep.
- The corridor program's ``--no-project-prior`` (the JAX program's
  ``CORR_PP=0``) reaches the config, and a caller's own ``configure`` is kept.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mloam_tpu.core import se3 as jse3
from mloam_tpu.core.rangeimage import LidarModel as JModel
from mloam_tpu.core.rangeimage import RangeImage as JRangeImage
from mloam_tpu.models import platforms as jplatforms
from mloam_tpu.models.pipeline import OdometryPipeline as JPipeline
from mloam_tpu.ops import pallas_labels as PL
from mloam_tpu.sim import world as JW
from mloam_tpu_torch.core import rangeimage as RI
from mloam_tpu_torch.core.rangeimage import LidarModel
from mloam_tpu_torch.models import experiments as X
from mloam_tpu_torch.models.pipeline import OdometryPipeline
from mloam_tpu_torch.ops import hopper_labels
from mloam_tpu_torch.utils import convert
from test_torch_frontend import _assert_same_rows, _rows
from test_torch_labels import _random_case

N_FRAMES = 7
# lidar l > 0 at exp([rho, phi]) from the base: the dual rig's second lidar is
# the JAX e2e test's (30 deg of yaw, 38 cm off), the others the Hercules rig's
TANGENTS = ([0.3, -0.2, 0.1, 0.0, 0.0, 0.5235988],
            [-0.2, 0.15, -0.05, -0.04, 0.06, -0.4],
            [0.1, 0.3, 0.02, 0.03, -0.05, 1.0])


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def small_cfg(n_lidars):
    j = jplatforms.synthetic(n_lidars=n_lidars, extrinsic_mode=0)
    j = dataclasses.replace(
        j,
        rig=dataclasses.replace(j.rig, models=(JModel(n_rings=8, n_cols=360),) * n_lidars),
        features=dataclasses.replace(j.features, cap_less_flat=512),
        odometry=dataclasses.replace(
            j.odometry, window_size=4, opt_window_size=2, cap_frame_corner=128,
            cap_frame_surf=256, localmap_precap_corner=256,
            localmap_precap_surf=640))
    return j, convert.config_from_reference(dataclasses.asdict(j))


def jext(n_lidars):
    xi = jnp.asarray([[0.0] * 6] + list(TANGENTS[:n_lidars - 1]), jnp.float32)
    return jse3.exp(xi)


@pytest.fixture(scope="module")
def rig4():
    """Four lidars' renderings of one course, by the JAX simulator."""
    jcfg, _ = small_cfg(4)
    w = JW.make_world(jax.random.PRNGKey(0))
    traj = JW.make_trajectory(jax.random.PRNGKey(1))
    model = jcfg.rig.models[0]
    ext = jext(4)
    seqs = tuple(
        jax.tree.map(np.asarray, JW.render_sequence(
            w, traj, model, N_FRAMES, extrinsic=jse3.Pose(ext.q[l], ext.t[l]))[0])
        for l in range(4))
    return seqs


def tframes(seqs, i):
    return [convert.range_image_from_numpy(tuple(f[i] for f in s)) for s in seqs]


def flat(tree):
    """Every tensor of a nested tuple, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in flat(x)]
    return []


def assert_bits_equal(got, want, what):
    g, w = flat(got), flat(want)
    assert len(g) == len(w) > 0, what
    for k, (a, b) in enumerate(zip(g, w)):
        assert a.shape == b.shape and a.dtype == b.dtype, f"{what}: tensor {k}"
        assert torch.equal(a, b), f"{what}: tensor {k} of {len(g)} differs"


def batch_pipe(cfg, on):
    """A pipeline of a uniform rig, batched (``on``) or held to the unrolled
    frontends a mixed rig runs."""
    pipe = OdometryPipeline(cfg, device="cpu")
    assert pipe._uniform_rig
    pipe._uniform_rig = on
    return pipe


# ------------------------------------------------------------------- K1

def _pallas_vmapped(labels, conn_h, conn_v, rounds):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        fn = functools.partial(PL.propagate_labels_pallas.__wrapped__, rounds=rounds)
        out = jax.vmap(fn)(jnp.asarray(labels), jnp.asarray(conn_h), jnp.asarray(conn_v))
    finally:
        pl.pallas_call = orig
    return np.asarray(out)


@pytest.mark.parametrize("rounds", [1, 3, 8])
@pytest.mark.parametrize("shape", [(2, 8, 360), (4, 16, 384), (3, 5, 130)])
def test_batched_plain_labels_equal_vmapped_tpu_kernel(shape, rounds):
    b, r, c = shape
    cases = [_random_case(r, c, seed=100 * i + rounds) for i in range(b)]
    labels, ch, cv = (np.stack(x) for x in zip(*cases))
    want = _pallas_vmapped(labels, ch, cv, rounds)
    got = hopper_labels.propagate_labels(
        torch.from_numpy(labels), torch.from_numpy(ch), torch.from_numpy(cv), rounds)
    assert got.dtype == torch.int32 and got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)
    # each image as alone
    for i in range(b):
        alone = hopper_labels.propagate_labels(*(torch.from_numpy(x[i]) for x in (labels, ch, cv)),
                                               rounds)
        np.testing.assert_array_equal(got[i].numpy(), alone.numpy())


def test_batch_arguments_are_checked():
    labels, ch, cv = (torch.from_numpy(x) for x in _random_case(4, 16, 0))
    with pytest.raises(ValueError, match="65535"):
        hopper_labels.propagate_labels(labels[None].expand(0, 4, 16), ch[None].expand(0, 4, 16),
                                       cv[None].expand(0, 4, 16), 3)
    big = (hopper_labels.MAX_IMAGES + 1, 1, 1)
    with pytest.raises(ValueError, match="65535"):
        hopper_labels.propagate_labels(torch.zeros(big, dtype=torch.int32),
                                       torch.zeros(big, dtype=torch.bool),
                                       torch.zeros(big, dtype=torch.bool), 3)
    with pytest.raises(TypeError):
        hopper_labels.propagate_labels(labels[None, None], ch[None, None], cv[None, None], 3)
    with pytest.raises(TypeError):
        hopper_labels.propagate_labels(labels[None].expand(2, 4, 16), ch, cv, 3)


# ------------------------------------------------------------- frontend

def _inputs(seqs, n_lidars, frame, kind):
    imgs = tframes(seqs[:n_lidars], frame)
    if kind == "scaled":
        # lidar 1 sees a world 10x the size: its coordinates are 10x lidar 0's
        imgs[1] = imgs[1]._replace(xyz=imgs[1].xyz * 10.0, rng=imgs[1].rng * 10.0)
    if kind == "packed":
        imgs = [RI.pack_frame(img) for img in imgs]
    return imgs


@pytest.mark.parametrize("n_lidars,kind", [(2, "images"), (2, "packed"), (2, "scaled"),
                                           (4, "images"), (4, "packed")])
@pytest.mark.parametrize("frame", [1, 5])
def test_batched_frontend_equals_unrolled_to_the_bit(rig4, n_lidars, kind, frame):
    _, tcfg = small_cfg(n_lidars)
    pipe = OdometryPipeline(tcfg, device="cpu")
    imgs = _inputs(rig4, n_lidars, frame, kind)
    unrolled = pipe._frontends(imgs)
    batched = pipe._frontends(imgs, batched=True)
    for l in range(n_lidars):
        for k, name in enumerate(("features", "corner", "surf", "outlier")):
            assert_bits_equal(batched[k][l], unrolled[k][l], f"lidar {l} {name}")
    assert bool(unrolled[1][1].mask.any()) and bool(unrolled[3][1].mask.any())


def test_batched_frontend_agrees_with_vmapped_reference(rig4):
    jcfg, tcfg = small_cfg(2)
    jpipe = JPipeline(jcfg)
    stacked = JRangeImage(*(jnp.asarray(np.stack([s[i][3] for s in rig4[:2]]))
                            for i in range(len(JRangeImage._fields))))
    # op by op, as tests/test_torch_frontend.py runs the JAX functions: a
    # jitted program fuses the curvature's window sum into another order
    jff, jc, js, jo = jax.vmap(functools.partial(jpipe._frontend_impl, model_idx=0))(stacked)
    pipe = OdometryPipeline(tcfg, device="cpu")
    tff, tc, ts, to = pipe._frontends(tframes(rig4[:2], 3), batched=True)
    for l in range(2):
        for name in ("sharp", "less_sharp", "flat"):
            jf = jax.tree.map(lambda x: np.asarray(x[l]), getattr(jff, name))
            tf = getattr(tff[l], name)
            assert int(jf.mask.sum()) > 0
            # same slot layout: (ring, sector, rank)
            np.testing.assert_array_equal(N(tf.mask), jf.mask)
            np.testing.assert_array_equal(N(tf.ring), jf.ring)
            np.testing.assert_allclose(N(tf.xyz), jf.xyz, atol=1e-6)
            np.testing.assert_allclose(N(tf.time)[N(tf.mask)], jf.time[jf.mask], atol=1e-7)
        # voxel centroids, as sets, to f32 summation order
        for tfc, jfc in ((tff[l].less_flat, jff.less_flat), (tc[l], jc), (ts[l], js),
                         (to[l], jo)):
            jr = _rows(jax.tree.map(lambda x: np.asarray(x[l]), jfc))
            tr = _rows(tfc)
            assert jr.shape == tr.shape and jr.shape[0] > 0
            _assert_same_rows(tr, jr, atol=1e-5)


# ------------------------------------------------------------- pipeline

def _run(tcfg, seqs, monkeypatch, on, chunk_from=None):
    """Poses, last output and final window of a streaming run (or of one
    that replays sweeps ``chunk_from..`` through ``process_chunk``), and
    the label calls' shapes per sweep."""
    pipe = batch_pipe(tcfg, on)
    n = len(seqs)
    pipe.set_extrinsics(convert.pose_from_numpy(jax.tree.map(np.asarray, jext(n))))
    calls, per_sweep = [], []
    real = hopper_labels.propagate_labels

    def rec(labels, ch, cv, rounds=3):
        calls.append(tuple(labels.shape))
        return real(labels, ch, cv, rounds)

    monkeypatch.setattr(hopper_labels, "propagate_labels", rec)
    poses = []
    stop = N_FRAMES if chunk_from is None else chunk_from
    for i in range(stop):
        out = pipe.process(tframes(seqs, i))
        poses.append(torch.cat([out.pose.q, out.pose.t]))
        per_sweep.append(calls[:])
        calls.clear()
    if chunk_from is not None:
        stacked = tuple(convert.range_image_from_numpy(tuple(f[chunk_from:] for f in s))
                        for s in seqs)
        q, t, *rest = pipe.process_chunk(stacked)
        poses += list(torch.cat([q, t], -1))
        per_sweep.append(calls[:])
        out = rest
    monkeypatch.setattr(hopper_labels, "propagate_labels", real)
    return torch.stack(poses), out, pipe, per_sweep


@pytest.mark.parametrize("n_lidars", [2, 4])
def test_pipeline_switch_on_equals_off_to_the_bit(rig4, monkeypatch, n_lidars):
    _, tcfg = small_cfg(n_lidars)
    seqs = rig4[:n_lidars]
    ws = tcfg.odometry.window_size
    on, out_on, p_on, calls_on = _run(tcfg, seqs, monkeypatch, True)
    off, out_off, p_off, calls_off = _run(tcfg, seqs, monkeypatch, False)
    assert all(o == 0 for o in (p_on.ext_mode, p_off.ext_mode))
    assert torch.equal(on, off)
    assert_bits_equal(out_on, out_off, "last output")
    assert_bits_equal(p_on.window, p_off.window, "window")
    assert_bits_equal(p_on.prev_feats[0], p_off.prev_feats[0], "tracker features")
    assert_bits_equal(p_on.last_outlier, p_off.last_outlier, "outliers")
    img = (8, 360)
    # one label call per lidar before the window fills, one for the rig after
    assert calls_off == [[img] * n_lidars] * N_FRAMES
    assert calls_on == [[img] * n_lidars] * ws + [[(n_lidars,) + img]] * (N_FRAMES - ws)
    # the same tail replayed by process_chunk, batched and unrolled
    c_on, rest_on, pc_on, chunk_calls = _run(tcfg, seqs, monkeypatch, True, chunk_from=ws)
    c_off, rest_off, pc_off, _ = _run(tcfg, seqs, monkeypatch, False, chunk_from=ws)
    assert chunk_calls[-1] == [(n_lidars,) + img] * (N_FRAMES - ws)
    assert torch.equal(c_on, on) and torch.equal(c_off, on)
    assert_bits_equal(rest_on, rest_off, "chunk outputs")
    assert_bits_equal(pc_on.window, p_on.window, "chunk window")
    assert_bits_equal(pc_off.window, p_on.window, "chunk window, off")


def test_uniform_rig_rule(monkeypatch):
    """Batched exactly when the rig has L > 1 lidars of one sensor model;
    the JAX package's opt-in switch has no say in the port."""
    _, one = small_cfg(1)
    _, two = small_cfg(2)
    _, four = small_cfg(4)
    mixed = dataclasses.replace(two, rig=dataclasses.replace(
        two.rig, models=(LidarModel(n_rings=8, n_cols=360), LidarModel(n_rings=8, n_cols=720))))
    assert OdometryPipeline(two, device="cpu")._uniform_rig
    assert OdometryPipeline(four, device="cpu")._uniform_rig
    assert not OdometryPipeline(one, device="cpu")._uniform_rig
    assert not OdometryPipeline(mixed, device="cpu")._uniform_rig
    monkeypatch.setenv("MLOAM_BATCH_FE", "0")
    assert OdometryPipeline(two, device="cpu")._uniform_rig


@pytest.mark.parametrize("argv,want", [([], True), (["--no-project-prior"], False),
                                       ("configure", False)])
def test_corridor_honours_corr_pp(monkeypatch, argv, want):
    """The corridor program's ``--no-project-prior`` is the JAX program's
    ``CORR_PP=0`` (``mloam_tpu/models/experiments.py:700-702``): it sets
    ``odometry.remap_project_prior`` of the corridor course, default on; a
    caller's ``configure`` that sets the field is kept."""
    def small(cfg):
        return dataclasses.replace(cfg, rig=dataclasses.replace(
            cfg.rig, models=(LidarModel(n_rings=8, n_cols=360),)))

    if argv == "configure":
        def configure(cfg):
            return small(dataclasses.replace(cfg, odometry=dataclasses.replace(
                cfg.odometry, remap_project_prior=False)))
    else:
        got = {}

        def measure(*a, configure):
            got["configure"] = configure
            return {"summary": {}}
        monkeypatch.setattr(X, "measure_corridor", measure)
        monkeypatch.setattr(X, "write_corridor", lambda res: None)
        X.main(["corridor"] + argv)

        def configure(cfg):
            return got["configure"](small(cfg))
    cfg, imgs, gt = X.corridor_course(1, 0.01, 0, device="cpu", configure=configure)
    assert cfg.odometry.remap_project_prior is want
    assert cfg.tracker.skip_steady and cfg.rig.models[0].max_range == 20.0
    assert imgs.rng.shape[-2:] == (8, 360)
