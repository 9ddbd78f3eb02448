"""The pose graph's direct solve in a fill-reducing order, on the CPU.

A 300-pose drive (one closed turn of 260 poses, then 40 that revisit its
start; sequential edges to the 4 predecessors; 8 loop edges from the last
40 poses back to the first 40) and a star (every pose tied to pose 0, whose
every order leaves a wide band). Checked: the reverse Cuthill-McKee order
is a permutation that narrows the drive to a band of at most 15 poses; the
band assembled from the pair sums is the permuted dense H to the bit; the
plain band solve (``hopper_band_chol.band_solve_plain``) gives the dense
``cholesky_ex`` solve's step within float32 rounding (within 2e-5 of the
float64 solve in norm, no further than the dense solve's twice);
``pgo_step`` picks the band or the dense solve by the analysed
half-bandwidth, as the counters show; and the analysis runs once for the
solves of one graph. The kernel itself runs on
the card only (``chip_smoke.py``'s ``band_chol`` phase).
"""

import numpy as np
import pytest
import torch

from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.ops import hopper_band_chol as BC
from mloam_tpu_torch.parallel import sharded_pgo as PG
from mloam_tpu_torch.utils import pgo_ladder as LADDER


def drive(n=300, back=40, loops=8, seed=0):
    return LADDER.drive_graph(n, back, loops, "cpu", seed=seed)


def star(n=60):
    """Every pose tied to pose 0: any order leaves about n / 2 poses of band."""
    p = Pose.identity((n,), device="cpu")
    i = torch.zeros(n - 1, dtype=torch.int64)
    j = torch.arange(1, n)
    t = torch.zeros(n - 1, 3)
    t[:, 0] = 1.0
    return (Pose(p.q, torch.cat([torch.zeros(1, 3), t])),
            PG.PoseGraphEdges(i, j, p.q[1:], t, torch.ones(n - 1, 6)))


def permuted(H, perm):
    n = perm.shape[0]
    return H.reshape(n, 6, n, 6)[perm][:, :, perm].reshape(n * 6, n * 6)


def test_order_is_a_permutation_that_narrows_the_drive():
    _, e = drive()
    order = PG.edge_band_order(e, 300)
    assert sorted(order.perm.tolist()) == list(range(300))
    assert torch.equal(order.inv[order.perm], torch.arange(300))
    # a cycle of edges to 4 predecessors takes 4 · 4 - 1 poses under
    # Cuthill-McKee from any start (scipy's reverse_cuthill_mckee gives 15 too)
    assert order.half_bandwidth <= 15
    natural = int((e.i - e.j).abs().max())
    assert natural >= 250 and order.half_bandwidth == int(
        (order.inv[e.i] - order.inv[e.j]).abs().max())


def test_band_assembly_is_the_permuted_dense_hessian_to_the_bit():
    poses, e = drive()
    n = 300
    order = PG.edge_band_order(e, n)
    pairs, sums, g, _ = PG._pair_sums(poses, e)
    band = PG._band_from_pairs(pairs, sums, n, order)
    Hp = permuted(PG._linearize_edges(poses, e)[0], order.perm)
    b = BC.scalar_bandwidth(order.half_bandwidth)
    assert band.shape == (n * 6, b + 1)
    r = torch.arange(n * 6)[:, None]
    c = r - torch.arange(b + 1)
    inside = c >= 0
    assert torch.equal(band[inside], Hp[r.expand_as(c)[inside], c[inside]])
    assert not band[~inside].any()
    # nothing of H lies outside the band
    assert not Hp.tril(-b - 1).any() and not Hp.triu(b + 1).any()


def test_plain_band_solve_equals_the_dense_solve():
    poses, e = drive()
    n = 300
    order = PG.edge_band_order(e, n)
    pairs, sums, g, _ = PG._pair_sums(poses, e)
    band = PG._band_from_pairs(pairs, sums, n, order)
    H = PG._dense_from_pairs(pairs, sums, n)
    for m in (band[:, 0], H.diagonal()):
        m += 1e-3 * (m + 1e-3)
        m += 1e-8
    H.diagonal()[:6] += 1e3
    band[order.inv[0] * 6 + torch.arange(6), 0] += 1e3
    L, info = torch.linalg.cholesky_ex(H)
    want = torch.cholesky_solve(g[:, None], L)[:, 0]
    unfactored = band.clone()
    got, binfo = BC.band_solve_plain(band, g, order.perm)
    assert int(info) == 0 and int(binfo) == 0
    # two float32 Cholesky solves in two orders of a system whose condition
    # is 1.3e5: the band solve lies 5.8e-6-6.4e-6 from the float64 solve (in
    # norm), the dense one 9.3e-6-2.7e-5 and the two 1.3e-5-2.8e-5 apart,
    # by LAPACK's thread count (1 to 8 threads); held at 2e-5, no further
    # than twice the dense solve's, and 5e-5 apart
    exact = torch.linalg.solve(H.double(), g.double())

    def off(x):
        return float(torch.linalg.norm(x.double() - exact) / torch.linalg.norm(exact))

    assert off(got) <= 2e-5 and off(got) <= 2 * off(want)
    assert float(torch.linalg.norm(got - want)) <= 5e-5 * float(torch.linalg.norm(want))
    # the band holds its factor: L L^T is the band's matrix
    Lp = torch.linalg.cholesky(_dense(unfactored))
    assert torch.allclose(_dense(band), Lp, rtol=0, atol=1e-5 * float(Lp.abs().max()))


def _dense(band):
    """The lower triangle that a band holds, as a dense matrix."""
    N, w = band.shape
    r = torch.arange(N)[:, None].expand(N, w)
    c = r - torch.arange(w)
    inside = c >= 0
    A = torch.zeros(N, N)
    A[r[inside], c[inside]] = band[inside]
    return A


def test_the_step_takes_the_band_or_the_dense_solve_by_its_bandwidth(monkeypatch):
    poses, e = drive()
    band0, dense0 = PG.band_steps, PG.dense_steps
    out, cost = PG.pgo_step(poses, e)
    assert (PG.band_steps - band0, PG.dense_steps - dense0) == (1, 0)
    assert PG.last_half_bandwidth <= 15
    # the same step forced onto the dense solve: the same poses to 1e-4 (the
    # parity tests' tolerance; coordinates of 40 m round at 4e-6)
    monkeypatch.setattr(BC, "MAX_HALF_BANDWIDTH", -1)
    ref, ref_cost = PG.pgo_step(poses, e)
    assert (PG.band_steps - band0, PG.dense_steps - dense0) == (1, 1)
    assert torch.equal(cost, ref_cost)
    assert float((out.t - ref.t).abs().max()) < 1e-4
    assert float(torch.minimum((out.q - ref.q).abs(), (out.q + ref.q).abs()).max()) < 1e-4
    monkeypatch.undo()
    sp, se = star()
    PG.pgo_step(sp, se)
    assert PG.last_half_bandwidth > BC.MAX_HALF_BANDWIDTH
    assert (PG.band_steps - band0, PG.dense_steps - dense0) == (1, 2)


def test_a_graph_is_analysed_once_for_its_solves(monkeypatch):
    """The solves of a drive, whose loops change only their weights, share
    one analysis: the indices are compared, not analysed again."""
    poses, e = drive(seed=1)
    calls = []
    real = PG.rcm_order
    monkeypatch.setattr(PG, "rcm_order", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(PG, "_last_order", None)
    band0 = PG.band_steps
    PG.optimize_pose_graph(poses, e, iters=2)
    w = e.weight.clone()
    w[-3:] = 0.0
    PG.optimize_pose_graph(poses, e._replace(weight=w), iters=2)
    assert len(calls) == 1 and PG.band_steps - band0 == 4
    PG.optimize_pose_graph(*star(), iters=1)
    assert len(calls) == 2


@pytest.mark.parametrize("h", [0, 17, BC.MAX_HALF_BANDWIDTH])
def test_the_window_fits_the_block(h):
    """The kernel's shared memory at the widest band it takes fits the
    227 KB a block may hold on the H100, one band wider does not, and the
    drive's 17 poses fit."""
    b = BC.scalar_bandwidth(h)
    assert BC.smem_bytes(b) <= BC.SMEM_LIMIT and BC.PANEL + b + 1 <= BC.THREADS
    assert BC.MAX_HALF_BANDWIDTH >= 17
    assert not BC._fits(BC.MAX_HALF_BANDWIDTH + 1)


def test_the_kernel_wrapper_refuses_cpu_tensors_and_bad_shapes():
    band = torch.zeros(12, 12)
    g = torch.zeros(12)
    perm = torch.arange(2)
    with pytest.raises(ValueError, match="CUDA"):
        BC.band_solve(band, g, perm)
    with pytest.raises(ValueError, match="6 h"):
        BC.band_solve_plain(torch.zeros(12, 8), g, perm)
    with pytest.raises(TypeError, match="perm"):
        BC.band_solve_plain(band, g, perm.int())
    assert np.isnan(PG.pgo_step(*_non_pd())[0].t).all()


def _non_pd():
    poses, e = drive(n=60, back=20, loops=2)
    w = e.weight.clone()
    w[7] = float("nan")
    return poses, e._replace(weight=w)
