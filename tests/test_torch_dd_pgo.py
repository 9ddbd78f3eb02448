"""The nested-dissection PGO/BA solver, port vs JAX package.

A 64-pose survey graph (the JAX package's ``make_survey_graph``, 8 loops,
noise 0.05), converted to numpy, goes through both packages: the partitions
equal array for array; 5 DD steps on a 4-shard 1-D and a 2x2 (host, factor)
layout (JAX: 4 of the 8 virtual devices; port: stacked meshes) equal the JAX
DD step and the port's 5 dense ``pgo_step``s to 1e-4 m / 1e-4 in quaternion
components, 4-DoF included; ``point_block`` H / g to 1e-4 (relative to the
largest entry) of the JAX block; ``associate_block`` in f32 and in bf16
on candidates at least 1 m apart (no near ties: the two packages sum the
three products in another order) to 1e-4 relative; the BA with in-step
re-association on the 2x2 layout to 1e-4 m of the JAX package's and of the
truth, the chunked association equal to the unchunked. Port only: point
factors converge on both layouts, a non-PD block gives NaN, and the bf16
separator reductions (``reduce_dtype``) halve the bytes and still converge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import mloam_tpu.core.rotations as jrot
from mloam_tpu.core.se3 import Pose as JPose
from mloam_tpu.parallel import dd_pgo as JDD
from mloam_tpu.parallel import scaling_model as JSM
from mloam_tpu.parallel.mesh import FACTOR_AXIS, HOST_AXIS
from mloam_tpu_torch.core import rotations as rot
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.parallel import dd_pgo as DD
from mloam_tpu_torch.parallel import mesh as M
from mloam_tpu_torch.parallel import sharded_pgo as PG
from mloam_tpu_torch.utils import convert

N_POSES = 64
TOL = 1e-4


def T(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def graph():
    """(JAX poses, edges, gt) and the port's, from the same numpy arrays."""
    poses, edges, gt = JSM.make_survey_graph(N_POSES, n_loops=8, noise=0.05)
    tp = convert.pose_from_numpy(jax.tree.map(np.asarray, poses))
    te = convert.pose_graph_edges_from_numpy(jax.tree.map(np.asarray, edges))
    tgt = convert.pose_from_numpy(jax.tree.map(np.asarray, gt))
    return (poses, edges, gt), (tp, te, tgt)


@pytest.fixture(scope="module")
def meshes():
    devs = np.asarray(jax.devices()[:4])
    jm = {"1d": Mesh(devs, (FACTOR_AXIS,)),
          "2x2": Mesh(devs.reshape(2, 2), (HOST_AXIS, FACTOR_AXIS))}
    tm = {"1d": M.make_mesh(4, device="cpu"),
          "2x2": M.make_multihost_mesh(2, 2, device="cpu")}
    return jm, tm


def close(tp, jp, tol=TOL):
    np.testing.assert_allclose(tp.t.numpy(), np.asarray(jp.t), rtol=0, atol=tol)
    dq = np.minimum(np.abs(tp.q.numpy() - np.asarray(jp.q)).max(-1),
                    np.abs(tp.q.numpy() + np.asarray(jp.q)).max(-1))
    assert dq.max() < tol, dq.max()


def dense(tp, te, iters, dof4=False):
    for _ in range(iters):
        tp, _ = PG.pgo_step(tp, te, dof4=dof4)
    return tp


@pytest.mark.parametrize("shards,hosts", [(4, 1), (4, 2), (8, 2)])
def test_build_partition_arrays_equal(graph, shards, hosts):
    (_, edges, _), _ = graph
    j = JDD.build_partition(np.asarray(edges.i), np.asarray(edges.j), N_POSES, shards,
                            n_hosts=hosts)
    t = DD.build_partition(np.asarray(edges.i), np.asarray(edges.j), N_POSES, shards,
                           n_hosts=hosts)
    conv = convert.dd_partition_from_numpy(j)
    for f, a, b, c in zip(DD.DDPartition._fields, j, t, conv):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c), err_msg=f)


@pytest.mark.parametrize("layout", ["1d", "2x2"])
def test_dd_step_matches_jax_and_dense(graph, meshes, layout):
    (jp, je, _), (tp, te, _) = graph
    jm, tm = meshes
    jout, jcost = JDD.optimize_pose_graph_dd(jp, je, jm[layout], iters=5)
    out, cost = DD.optimize_pose_graph_dd(tp, te, tm[layout], iters=5)
    close(out, jout)
    ref = dense(tp, te, 5)
    close(out, ref)
    assert float(cost) == pytest.approx(float(jcost), rel=1e-2, abs=1e-7)


def test_dof4_matches_jax_and_dense(graph, meshes):
    (jp, je, _), (tp, te, _) = graph
    jm, tm = meshes
    jout, _ = JDD.optimize_pose_graph_dd(jp, je, jm["2x2"], iters=4, dof4=True)
    out, _ = DD.optimize_pose_graph_dd(tp, te, tm["2x2"], iters=4, dof4=True)
    close(out, jout)
    close(out, dense(tp, te, 4, dof4=True))


def test_dof4_rejects_map_factors(graph, meshes):
    _, (tp, te, _) = graph
    _, tm = meshes
    z = torch.zeros
    ms = DD.MapShard(pts=z(N_POSES, 4, 3), anchors=z(N_POSES, 4, 3),
                     normals=z(N_POSES, 4, 3), w=z(N_POSES, 4), valid=z(N_POSES, 4))
    with pytest.raises(ValueError, match="dof4"):
        DD.optimize_pose_graph_dd(tp, te, tm["1d"], iters=1, dof4=True, map_shard=ms)


def _rel_close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-12)
    np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=tol)


def test_point_block_matches_jax(graph):
    (jp, _, jgt), (tp, _, _) = graph
    rng = np.random.default_rng(3)
    K = 16
    pts = rng.standard_normal((K, 3)).astype(np.float32)
    nrm = rng.standard_normal((K, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    d = rng.standard_normal(K).astype(np.float32)
    w = rng.uniform(0.5, 1.5, K).astype(np.float32)
    for k in (0, 7, 40):
        jH, jg, jc = JDD.point_block(JPose(jp.q[k], jp.t[k]), *map(jnp.asarray, (pts, nrm, d, w)))
        H, g, c = DD.point_block(Pose(tp.q[k], tp.t[k]), *map(T, (pts, nrm, d, w)))
        _rel_close(H, jH)
        _rel_close(g, jg)
        assert float(c) == pytest.approx(float(jc), rel=TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_associate_block_matches_jax(graph, dtype):
    """Candidates on a 1 m grid, points within 0.2 m of one of them (or of
    no valid one): the nearest anchor is unambiguous at either precision;
    a quarter of the candidates invalid, some points past ``max_dist``."""
    (jp, _, _), (tp, _, _) = graph
    rng = np.random.default_rng(5)
    k = 9
    q, t = np.asarray(jp.q[k]), np.asarray(jp.t[k])
    R = np.asarray(jrot.quat_to_matrix(jnp.asarray(q)))
    g = np.stack(np.meshgrid(*[np.arange(-3.0, 3.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    anchors = (g + t).astype(np.float32)                          # [216, 3]
    M_ = anchors.shape[0]
    valid = (rng.random(M_) > 0.25).astype(np.float32)
    nrm = rng.standard_normal((M_, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    pick = rng.integers(0, M_, 24)
    pw = anchors[pick] + rng.uniform(-0.2, 0.2, (24, 3))
    pw[:4] += 0.45                            # four points far from every anchor
    pts = ((pw - t) @ R).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 24).astype(np.float32)
    sd = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jH, jg, jc = JDD.associate_block(JPose(jp.q[k], jp.t[k]), *map(jnp.asarray, (
        pts, anchors, nrm, w, valid)), max_dist=0.5, m_tile=64, search_dtype=sd[0])
    H, g, c = DD.associate_block(Pose(tp.q[k], tp.t[k]), *map(T, (
        pts, anchors, nrm, w, valid)), max_dist=0.5, m_tile=64, search_dtype=sd[1])
    _rel_close(H, jH)
    _rel_close(g, jg)
    assert float(c) == pytest.approx(float(jc), rel=TOL)


@pytest.fixture(scope="module")
def map_shard(graph):
    """The JAX package's own re-association case (tests/test_dd_pgo.py:133):
    scan points lie on their nearest map plane at the truth."""
    (_, _, gt), _ = graph
    Mc, K = 24, 12
    anc = jax.vmap(lambda q, t, p: jnp.einsum("ij,kj->ki", jrot.quat_to_matrix(q), p) + t)(
        gt.q, gt.t, jax.random.normal(jax.random.PRNGKey(7), (N_POSES, Mc, 3)))
    pts_b = jax.vmap(lambda q, t, a: jnp.einsum("ji,kj->ki", jrot.quat_to_matrix(q), a - t))(
        gt.q, gt.t, anc[:, :K])
    nrm = jax.random.normal(jax.random.PRNGKey(8), (N_POSES, Mc, 3))
    nrm = nrm / jnp.linalg.norm(nrm, axis=-1, keepdims=True)
    ms = JDD.MapShard(pts=pts_b, anchors=anc, normals=nrm, w=jnp.ones((N_POSES, K)),
                      valid=jnp.ones((N_POSES, Mc)))
    return ms, convert.map_shard_from_numpy(jax.tree.map(np.asarray, ms))


def test_ba_reassociation_matches_jax_and_truth(graph, meshes, map_shard):
    (jp, je, _), (tp, te, tgt) = graph
    jm, tm = meshes
    jms, tms = map_shard
    jout, jcost = JDD.optimize_pose_graph_dd(jp, je, jm["2x2"], iters=8, map_shard=jms)
    out, cost = DD.optimize_pose_graph_dd(tp, te, tm["2x2"], iters=8, map_shard=tms)
    close(out, jout)
    assert float(torch.linalg.norm(out.t - tgt.t, dim=1).mean()) < 1e-4
    assert float(cost) < 1e-5 and float(jcost) < 1e-5
    # chunked association, on the 1-D layout: the same program output
    o1, _ = DD.optimize_pose_graph_dd(tp, te, tm["1d"], iters=2, map_shard=tms)
    o2, _ = DD.optimize_pose_graph_dd(tp, te, tm["1d"], iters=2, map_shard=tms,
                                      assoc_chunk=4)
    assert torch.equal(o1.t, o2.t) and torch.equal(o1.q, o2.q)


def test_point_factors_converge_and_layouts_agree(graph, meshes):
    """The JAX package's point-factor case (tests/test_dd_pgo.py:109), port
    only: anchors at the truth pull the solution to it, on both layouts."""
    (_, _, gt), (tp, te, tgt) = graph
    _, tm = meshes
    K = 12
    pts = jax.random.normal(jax.random.PRNGKey(3), (N_POSES, K, 3))
    nrm = jax.random.normal(jax.random.PRNGKey(4), (N_POSES, K, 3))
    nrm = nrm / jnp.linalg.norm(nrm, axis=-1, keepdims=True)
    pw = jax.vmap(lambda q, t, p: jnp.einsum("ij,kj->ki", jrot.quat_to_matrix(q), p) + t)(
        gt.q, gt.t, pts)
    d = -jnp.einsum("nki,nki->nk", nrm, pw)
    pf = convert.point_factors_from_numpy(jax.tree.map(np.asarray, JDD.PointFactors(
        pts=pts, normals=nrm, d=d, w=jnp.ones((N_POSES, K)))))
    o1, _ = DD.optimize_pose_graph_dd(tp, te, tm["1d"], iters=8, point_factors=pf)
    o2, _ = DD.optimize_pose_graph_dd(tp, te, tm["2x2"], iters=8, point_factors=pf)
    assert float(torch.linalg.norm(o1.t - tgt.t, dim=1).mean()) < 1e-4
    np.testing.assert_allclose(o1.t.numpy(), o2.t.numpy(), atol=1e-4)


def test_non_pd_block_gives_nan(graph, meshes):
    """A NaN edge weight makes a shard's block unfactorable: NaN poses, as
    the JAX package's Cholesky gives them, not a regularised step."""
    _, (tp, te, _) = graph
    _, tm = meshes
    w = te.weight.clone()
    w[3] = torch.nan
    out, _ = DD.optimize_pose_graph_dd(tp, te._replace(weight=w), tm["1d"], iters=1)
    assert torch.isnan(out.t).any()
    assert rot.quat_to_matrix(out.q).shape == (N_POSES, 3, 3)


def test_reduce_dtype_halves_the_bytes_and_still_converges(graph, meshes):
    """``reduce_dtype``: the separator reductions in bf16 move half the
    float bytes of f32 and the solve still cuts the error tenfold (the
    JAX package's option; its own tests do not run it); in f32 it is the
    default solve to the bit."""
    _, (tp, te, tgt) = graph
    _, tm = meshes
    runs = {}
    for rd in (None, torch.float32, torch.bfloat16):
        mesh = M.make_mesh(4, device="cpu")
        out, _ = DD.optimize_pose_graph_dd(tp, te, mesh, iters=5, reduce_dtype=rd)
        runs[rd] = (out, mesh.collectives["psum:factor"]["bytes"])
    assert torch.equal(runs[None][0].t, runs[torch.float32][0].t)
    assert runs[torch.bfloat16][1] < 0.75 * runs[None][1]
    err0 = float(torch.linalg.norm(tp.t - tgt.t, dim=1).mean())
    assert float(torch.linalg.norm(runs[torch.bfloat16][0].t - tgt.t, dim=1).mean()) < 0.1 * err0
