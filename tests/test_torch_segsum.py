"""The order-independent segment sums (``ops/segsum.index_sum``) and where
the port uses them: voxel centroids, the mapper's weighted voxel filter and
the pose graph's normal equations; and the PGO solver's ``auto`` rule.

Each sum is held equal to ``index_add_`` within 1e-6 of the group's sum of
magnitudes (the float sum's own rounding is of that order), and bit-equal
when the members are presented in another order: the property that makes a
run on the card repeat, since there the order of float atomics changes from
run to run. ``index_add_`` on the CPU adds in index order, so permuting its
input changes its last bits; ``index_sum`` must not change at all.
"""

import numpy as np
import pytest
import torch

from mloam_tpu_torch.core import se3
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.ops import voxel
from mloam_tpu_torch.ops.segsum import index_sum
from mloam_tpu_torch.parallel import sharded_pgo as PG


def _groups(seed, n=5000, n_out=300, width=(3,)):
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, n_out, (n,), generator=g)
    vals = (torch.randn((n,) + width, generator=g) * 40.0
            + torch.randn((1,) + width, generator=g) * 100.0)
    return vals, idx, n_out


@pytest.mark.parametrize("width", [(), (3,), (3, 3)], ids=["scalar", "vec3", "mat3"])
def test_index_sum_equals_index_add(width):
    vals, idx, n_out = _groups(1, width=width)
    got = index_sum(vals, idx, n_out)
    want = torch.zeros((n_out,) + width).index_add_(0, idx, vals)
    mag = torch.zeros((n_out,) + width, dtype=torch.float64).index_add_(
        0, idx, vals.double().abs())
    exact = torch.zeros((n_out,) + width, dtype=torch.float64).index_add_(0, idx, vals.double())
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(((got.double() - want.double()).abs() <= 1e-6 * mag + 1e-30).all())
    # and it rounds the exact sum once: within one float32 ulp of it
    ulp = torch.nextafter(exact.float().abs(), torch.tensor(float("inf"))) - exact.float().abs()
    assert bool(((got.double() - exact).abs() <= ulp.double() + 1e-30).all())


def test_index_sum_is_bit_equal_under_any_member_order():
    vals, idx, n_out = _groups(2)
    base = index_sum(vals, idx, n_out)
    differs = 0
    for seed in range(5):
        perm = torch.randperm(vals.shape[0], generator=torch.Generator().manual_seed(seed))
        assert torch.equal(index_sum(vals[perm], idx[perm], n_out), base)
        differs += int((torch.zeros_like(base).index_add_(0, idx[perm], vals[perm])
                        != torch.zeros_like(base).index_add_(0, idx, vals)).sum())
    # the float sum does depend on the order (the property is not vacuous)
    assert differs > 0


def test_index_sum_columns_scale_apart_and_nan_stays_in_its_column():
    """Each column has its own scale: a column of 1e-6 values beside one of
    1e3 keeps float32 precision; a non-finite value turns its column NaN."""
    vals, idx, n_out = _groups(3, width=(2,))
    vals[:, 0] *= 1e-8
    got = index_sum(vals, idx, n_out)
    want = torch.zeros((n_out, 2), dtype=torch.float64).index_add_(0, idx, vals.double())
    np.testing.assert_allclose(got[:, 0].numpy(), want[:, 0].numpy(), rtol=1e-5, atol=1e-12)
    vals[7, 1] = float("nan")
    got = index_sum(vals, idx, n_out)
    assert torch.isnan(got[:, 1]).all() and not torch.isnan(got[:, 0]).any()
    assert index_sum(torch.zeros((0, 3)), torch.zeros(0, dtype=torch.int64), 4).abs().sum() == 0


def _cloud(seed, n=4000):
    g = torch.Generator().manual_seed(seed)
    xyz = torch.rand((n, 3), generator=g) * torch.tensor([40.0, 30.0, 4.0]) - 20
    mask = torch.rand(n, generator=g) < 0.8
    A = torch.randn((n, 3, 3), generator=g) * 0.05
    cov = A @ A.transpose(-1, -2) + 1e-4 * torch.eye(3)
    pay = torch.rand((n, 2), generator=g)
    return xyz, mask, cov, pay


@pytest.mark.parametrize("packed", [False, True], ids=["lexsort", "packed"])
def test_voxel_filters_are_bit_equal_under_point_order(packed):
    xyz, mask, cov, pay = _cloud(4)
    perm = torch.randperm(xyz.shape[0], generator=torch.Generator().manual_seed(9))
    a = voxel.voxel_downsample(xyz, mask, 0.8, pay, packed=packed)
    b = voxel.voxel_downsample(xyz[perm], mask[perm], 0.8, pay[perm], packed=packed)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    a = voxel.voxel_downsample_with_cov(xyz, cov, mask, 0.8, 0.05, pay, packed=packed)
    b = voxel.voxel_downsample_with_cov(xyz[perm], cov[perm], mask[perm], 0.8, 0.05,
                                        pay[perm], packed=packed)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    a = voxel.voxel_downsample_two_class(xyz[:2000], mask[:2000], 0.4, xyz[2000:],
                                         mask[2000:], 0.8)
    p1, p2 = perm[perm < 2000], perm[perm >= 2000]
    b = voxel.voxel_downsample_two_class(xyz[p1], mask[p1], 0.4, xyz[p2], mask[p2], 0.8)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_voxel_sums_equal_index_add():
    """The weighted voxel filter's sums against the ``index_add_`` form they
    replace (Σw, Σw·x, Σw²·Σ)."""
    xyz, mask, cov, _ = _cloud(5)
    thr = 0.05
    out_xyz, out_cov, out_mask, _ = voxel.voxel_downsample_with_cov(xyz, cov, mask, 0.8, thr)
    tr = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1)
    ok = mask & (tr < thr)
    red = voxel.voxel_reduce(voxel.voxel_coords(xyz, 0.8), ok)
    n = xyz.shape[0]
    ws = torch.where(red.sorted_valid, torch.clamp(thr - tr, min=0.0)[red.order], 0.0)
    wsum = torch.zeros(n).index_add_(0, red.seg_id, ws).clamp(min=1e-12)
    want_xyz = torch.zeros_like(xyz).index_add_(0, red.seg_id, ws[:, None] * xyz[red.order])
    want_cov = torch.zeros_like(cov).index_add_(
        0, red.seg_id, (ws * ws)[:, None, None] * cov[red.order])
    m = out_mask
    np.testing.assert_allclose(out_xyz[m].numpy(), (want_xyz / wsum[:, None])[m].numpy(),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(out_cov[m].numpy(),
                               (want_cov / (wsum * wsum)[:, None, None])[m].numpy(),
                               rtol=1e-5, atol=1e-9)
    got = voxel.segment_mean(xyz, red)
    cnt = torch.zeros(n).index_add_(0, red.seg_id, red.sorted_valid.float()).clamp(min=1e-12)
    want = torch.zeros_like(xyz).index_add_(
        0, red.seg_id, torch.where(red.sorted_valid[:, None], xyz[red.order], 0.0))
    np.testing.assert_allclose(got[m].numpy(), (want / cnt[:, None])[m].numpy(),
                               rtol=1e-6, atol=1e-5)


def _ring(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    ang = torch.arange(n) * (2 * np.pi / n)
    xi = torch.zeros(n, 6)
    xi[:, 0], xi[:, 1], xi[:, 5] = 10 * torch.cos(ang), 10 * torch.sin(ang), ang + np.pi / 2
    gt = se3.exp(xi)
    gt = Pose(gt.q, xi[:, :3].clone())
    i = torch.arange(n - 1)
    rel = se3.relative(Pose(gt.q[i], gt.t[i]), Pose(gt.q[i + 1], gt.t[i + 1]))
    rel = se3.compose(rel, se3.exp(1e-3 * torch.randn(n - 1, 6, generator=g)))
    li = torch.arange(0, n - 10, 10)
    lrel = se3.relative(Pose(gt.q[li], gt.t[li]), Pose(gt.q[li + 10], gt.t[li + 10]))
    edges = PG.PoseGraphEdges(
        torch.cat([i, li]), torch.cat([i + 1, li + 10]), torch.cat([rel.q, lrel.q]),
        torch.cat([rel.t, lrel.t]), torch.ones(n - 1 + len(li), 6))
    drift = se3.exp(torch.outer(torch.arange(n, dtype=torch.float32),
                                torch.tensor([0.01, 0.005, 0, 0, 0, 0.002])))
    return se3.compose(gt, drift), edges


def test_pose_graph_sums_equal_index_put_and_ignore_edge_order():
    poses, edges = _ring(40)
    H, g, cost = PG._linearize_edges(poses, edges)
    # the dense form they replace: index_put_ with accumulate
    r, J = PG._linearize_sparse(poses, edges)
    Ji, Jj = J[:, :, :6], J[:, :, 6:]
    bi, bj = PG._blocks(edges.i), PG._blocks(edges.j)
    H0 = torch.zeros_like(H)
    for (ra, ca), blk in (((bi, bi), torch.einsum("eai,eaj->eij", Ji, Ji)),
                          ((bj, bj), torch.einsum("eai,eaj->eij", Jj, Jj)),
                          ((bi, bj), torch.einsum("eai,eaj->eij", Ji, Jj)),
                          ((bj, bi), torch.einsum("eai,eaj->eij", Jj, Ji))):
        H0.index_put_((ra[:, :, None], ca[:, None, :]), blk, accumulate=True)
    g0 = torch.zeros_like(g)
    g0.index_put_((bi,), torch.einsum("eai,ea->ei", Ji, r), accumulate=True)
    g0.index_put_((bj,), torch.einsum("eai,ea->ei", Jj, r), accumulate=True)
    sc = float(H0.abs().max())
    np.testing.assert_allclose(H.numpy(), H0.numpy(), atol=1e-6 * sc)
    np.testing.assert_allclose(g.numpy(), g0.numpy(), atol=1e-6 * float(g0.abs().max()))
    # the per-edge terms in another order: the same bits. (The edges
    # themselves are not permuted: the CPU's vectorised elementwise kernels
    # round a row by its position in a vector lane, so r and J of a permuted
    # edge list can differ in the last bit before any sum.)
    perm = torch.randperm(edges.i.shape[0], generator=torch.Generator().manual_seed(3))
    pe = PG.PoseGraphEdges(*(x[perm] for x in edges))
    real = PG._linearize_sparse
    try:
        PG._linearize_sparse = lambda p, e, dof4=False: (r[perm], J[perm])
        H2, g2, _ = PG._linearize_edges(poses, pe)
        a, _ = PG.pgo_step_cg(poses, pe, cg_iters=20)
        PG._linearize_sparse = lambda p, e, dof4=False: (r, J)
        b, _ = PG.pgo_step_cg(poses, edges, cg_iters=20)
    finally:
        PG._linearize_sparse = real
    assert torch.equal(H, H2) and torch.equal(g, g2)
    np.testing.assert_allclose(a.t.numpy(), b.t.numpy(), atol=1e-6)


def test_auto_rule_switches_after_the_threshold(monkeypatch):
    """``auto`` is dense at ``AUTO_DENSE_MAX_POSES`` poses and PCG one pose
    beyond (the solvers replaced by recorders: no solve runs)."""
    calls = []
    monkeypatch.setattr(PG, "pgo_step", lambda *a, **k: calls.append("dense") or (a[0], 0))
    monkeypatch.setattr(PG, "pgo_step_cg", lambda *a, **k: calls.append("cg") or (a[0], 0))
    t = PG.AUTO_DENSE_MAX_POSES
    for n in (t, t + 1):
        poses = Pose.identity((n,), device="cpu")
        edges = PG.PoseGraphEdges(torch.zeros(1, dtype=torch.int64),
                                  torch.ones(1, dtype=torch.int64), poses.q[:1],
                                  poses.t[:1], torch.ones(1, 6))
        PG.optimize_pose_graph(poses, edges, iters=1)
    assert calls == ["dense", "cg"]


def test_dense_and_cg_agree_on_either_side_of_the_threshold(monkeypatch):
    """With the threshold lowered to 40 poses, ``auto`` on 40 and on 41
    poses takes each solver in turn, and each agrees with the other solver
    forced on the same graph, to 1 mm / 1e-4 (observed 5e-6 m). PCG runs
    200 iterations here: the default n + n/4 leaves a 40-pose ring 2 cm short
    of the dense solve."""
    monkeypatch.setattr(PG, "AUTO_DENSE_MAX_POSES", 40)
    for n in (40, 41):
        poses, edges = _ring(n, seed=n)
        auto = PG.optimize_pose_graph(poses, edges, iters=3, cg_iters=200)
        other = PG.optimize_pose_graph(poses, edges, iters=3, cg_iters=200,
                                       solver="cg" if n <= 40 else "dense")
        assert float((auto.t - other.t).norm(dim=-1).max()) < 1e-3
        dq = torch.minimum((auto.q - other.q).abs().amax(-1), (auto.q + other.q).abs().amax(-1))
        assert float(dq.max()) < 1e-4
