"""Meshes and the edge-sharded pose-graph solve.

The stacked mesh's collectives against their definitions (a psum is the
sum over the reduced shards, an all_gather their concatenation in mesh
order, ``index_sum`` the one-device ``index_sum`` of every shard's rows to
the bit); ``optimize_pose_graph(mesh=)`` dense and PCG on a 48-pose survey
graph against the JAX package's mesh form (4 of the 8 virtual devices, 1-D
and 2x2) to 1e-4 m / 1e-4 in quaternion components, and equal to the bit to
the one-device solve of the same padded edges. Then the process form: four
gloo ranks (``tests/torch_mesh_worker.py``, ``file://`` rendezvous in a
temporary directory, 60 s on the join and on every collective, 180 s for
the whole run) as a 2x2 (host, factor) mesh give the stacked 2x2 mesh's
results: the DD solve and the mesh PGO to 1e-6 (on the CPU a rank's
elementwise kernels and its single-threaded LAPACK round otherwise than the
stacked form's batched ones, and the DD's float reductions run in another
order), the reductions, gathers and fixed-point sums to the bit. This is the only
multi-rank check that exists: the card's machine has one GPU, so the NCCL
form runs there with one rank only.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from mloam_tpu.parallel import mesh as JM
from mloam_tpu.parallel import scaling_model as JSM
from mloam_tpu.parallel import sharded_pgo as JPG
from mloam_tpu_torch.ops.segsum import index_sum
from mloam_tpu_torch.parallel import mesh as M
from mloam_tpu_torch.parallel import sharded_pgo as PG
from mloam_tpu_torch.utils import convert

import torch_mesh_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4


@pytest.fixture(scope="module")
def graph():
    poses, edges, gt = JSM.make_survey_graph(48, n_loops=4, noise=0.03)
    tp = convert.pose_from_numpy(jax.tree.map(np.asarray, poses))
    te = convert.pose_graph_edges_from_numpy(jax.tree.map(np.asarray, edges))
    return (poses, edges), (tp, te)


def test_stacked_collectives_follow_their_definitions():
    mesh = M.make_multihost_mesh(2, 3, device="cpu")
    x = torch.randn(2, 3, 4, 5, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(mesh.psum(x, "factor"), x.sum(1, keepdim=True), rtol=0, atol=0)
    torch.testing.assert_close(mesh.psum(x, ("host", "factor")),
                               x.sum((0, 1), keepdim=True), rtol=0, atol=0)
    torch.testing.assert_close(mesh.pmax(x, "host"), x.amax(0, keepdim=True), rtol=0, atol=0)
    # a value replicated along the reduced axis is counted once per shard
    rep = mesh.psum(x, "factor")
    torch.testing.assert_close(mesh.psum(rep, "factor"), 3 * rep, rtol=0, atol=0)
    g = mesh.all_gather(x, ("host", "factor"))
    assert g.shape == (1, 1, 24, 5)
    torch.testing.assert_close(g[0, 0], x.reshape(24, 5), rtol=0, atol=0)
    gf = mesh.all_gather(x, "factor")
    assert gf.shape == (2, 1, 12, 5)
    torch.testing.assert_close(gf[:, 0], x.reshape(2, 12, 5), rtol=0, atol=0)
    assert mesh.collectives["psum:factor"] == {"calls": 3, "bytes": 3 * 20 * 4}
    torch.testing.assert_close(mesh.shard(torch.arange(12)), torch.arange(12).reshape(2, 3, 2),
                               rtol=0, atol=0)
    assert mesh.axis_index("host").shape == (2, 1)


def test_mesh_index_sum_has_the_one_device_bits():
    """Shards' rows reduced in fixed point with the bound over all shards:
    the bits of one ``index_sum`` over the rows concatenated, in any
    layout; values over many magnitudes, so a per-shard scale would not."""
    g = torch.Generator().manual_seed(1)
    v = torch.randn(8, 50, 3, generator=g) * 10.0 ** torch.randint(-6, 6, (8, 50, 1), generator=g)
    idx = torch.randint(0, 7, (8, 50), generator=g)
    want = index_sum(v.reshape(400, 3), idx.reshape(400), 7)
    for mesh in (M.make_mesh(8, device="cpu"), M.make_multihost_mesh(2, 4, device="cpu")):
        got = mesh.replicated(mesh.index_sum(mesh.shard(v.reshape(400, 3)),
                                             mesh.shard(idx.reshape(400)), 7,
                                             M.data_axes(mesh)))
        assert torch.equal(got, want)


@pytest.mark.parametrize("solver", ["dense", "cg"])
@pytest.mark.parametrize("layout", ["1d", "2x2"])
def test_optimize_pose_graph_mesh_matches_jax(graph, solver, layout):
    (jp, je), (tp, te) = graph
    devs = np.asarray(jax.devices()[:4])
    if layout == "1d":
        jmesh, mesh = JM.make_mesh(4), M.make_mesh(4, device="cpu")
    else:
        jmesh = Mesh(devs.reshape(2, 2), (JM.HOST_AXIS, JM.FACTOR_AXIS))
        mesh = M.make_multihost_mesh(2, 2, device="cpu")
    jout = JPG.optimize_pose_graph(jp, je, iters=3, mesh=jmesh, solver=solver, cg_iters=40)
    out = PG.optimize_pose_graph(tp, te, iters=3, mesh=mesh, solver=solver, cg_iters=40)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(jout.t), rtol=0, atol=TOL)
    dq = np.minimum(np.abs(out.q.numpy() - np.asarray(jout.q)).max(-1),
                    np.abs(out.q.numpy() + np.asarray(jout.q)).max(-1))
    assert dq.max() < TOL
    one = PG.optimize_pose_graph(tp, PG.pad_edges(te, mesh.size), iters=3, solver=solver,
                                 cg_iters=40)
    assert torch.equal(out.t, one.t) and torch.equal(out.q, one.q)


@pytest.mark.parametrize("layout", ["1d", "2x2"])
def test_dense_mesh_linearization_is_the_one_device_one(graph, layout):
    """The mesh form of the dense step sums the Hessian's blocks per pose
    pair as one device does: (H, g, cost) equal the one-device ones of the
    padded edges to the bit, and no reduction carries H's size."""
    _, (tp, te) = graph
    mesh = M.make_mesh(4, device="cpu") if layout == "1d" else M.make_multihost_mesh(
        2, 2, device="cpu")
    padded = PG.pad_edges(te, mesh.size)
    sharded = PG.PoseGraphEdges(*(mesh.shard(x) for x in padded))
    got = PG._linearize_edges(tp, sharded, mesh=mesh, axis_name=M.data_axes(mesh))
    want = PG._linearize_edges(tp, padded)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    n = tp.q.shape[0]
    assert max(c["bytes"] for c in mesh.collectives.values()) < (n * 6) ** 2 * 4


def test_edge_padding_is_identity_and_weightless(graph):
    _, (_, te) = graph
    p = PG.pad_edges(te, 5)
    e = te.i.shape[0]
    assert p.i.shape[0] % 5 == 0 and p.i.shape[0] - e < 5
    assert (p.weight[e:] == 0).all() and (p.z_q[e:] == torch.tensor([1.0, 0, 0, 0])).all()


def test_process_mesh_equals_stacked_mesh(graph, tmp_path):
    _, (tp, te) = graph
    np.savez(tmp_path / "case.npz", q=tp.q.numpy(), t=tp.t.numpy(), i=te.i.numpy(),
             j=te.j.numpy(), zq=te.z_q.numpy(), zt=te.z_t.numpy(), w=te.weight.numpy())
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "torch_mesh_worker.py"),
                               str(r), "4", str(tmp_path), "2", "2"], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    want = worker.run_case(M.make_multihost_mesh(2, 2, device="cpu"), tp, te)
    stacked_chip = M.make_multihost_mesh(2, 2, device="cpu")
    ramp = stacked_chip.shard(torch.arange(24, dtype=torch.float32).reshape(4, 6))
    chip_sum = stacked_chip.psum(ramp, "factor")
    chip_max = stacked_chip.pmax(ramp, "factor")
    for r in range(4):
        got = dict(np.load(tmp_path / f"rank{r}.npz"))
        h, c = got.pop("coords")
        assert (h, c) == divmod(r, 2)
        np.testing.assert_array_equal(got.pop("psum_chip"), chip_sum[h, 0].numpy())
        np.testing.assert_array_equal(got.pop("pmax_chip"), chip_max[h, 0].numpy())
        for k in ("dd_t", "dd_q", "dd_cost", "dense_t", "dense_q", "cg_t", "cg_q"):
            np.testing.assert_allclose(got.pop(k), want[k], rtol=1e-6, atol=1e-6, err_msg=k)
        for k, v in got.items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
