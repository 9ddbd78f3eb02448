"""The traffic generator and the plain reference on their own: the drive's
layout fixed by the configuration and its noise by the seed, the rotation
conversions, the reference's Jacobians against finite differences, and its
solve against the program's on a small graph."""

import numpy as np
import pytest
import torch

from portbench import gen, harness
from portbench.kinds import pgo_loops
from portbench.ref import pgo as ref
from portbench.tests.conftest import SMALL_GRAPH


def _conf(**kw):
    c = harness.load_json(harness.PKG / "configs" / "kitti00_graph.json")
    c.update(SMALL_GRAPH, **kw)
    return c


def test_the_layout_is_fixed_and_the_seed_draws_the_noise():
    c = _conf()
    a, b, a2 = gen.drive_graph(c, 2**40 + 1), gen.drive_graph(c, -5), gen.drive_graph(c, 2**40 + 1)
    for x, y in zip(a, a2):
        assert np.array_equal(x, y)
    assert np.array_equal(a.i, b.i) and np.array_equal(a.j, b.j)
    assert np.array_equal(a.loop, b.loop) and np.array_equal(a.gt_t, b.gt_t)
    assert not np.array_equal(a.start_t, b.start_t)
    lap, query, cand = gen.drive_layout(c)
    assert lap == c["n_poses"] - c["n_loops"] * c["loop_every"]
    assert len(query) == c["n_loops"] and query[-1] < c["n_poses"]
    near = np.linalg.norm(a.gt_t[query] - a.gt_t[cand], axis=-1)
    assert near.max() <= c["loop_offset_max"] * c["step_m"] + 1e-9
    assert a.i.shape[0] == sum(c["n_poses"] - s for s in range(1, c["neighbors"] + 1)) + len(query)


def test_each_solve_adds_one_loop():
    g = gen.drive_graph(_conf(), 3)
    w = pgo_loops.Inputs(_conf(), 3, "cpu").weights.numpy()
    assert w.shape == (_conf()["n_loops"], g.i.shape[0], 6)
    for s in (0, 3):
        live = (g.loop < 0) | (g.loop <= s)
        assert (w[s][live] == g.weight[live][:, None]).all() and (w[s][~live] == 0).all()


def test_rotation_conversions_round_trip():
    rng = np.random.default_rng(0)
    phi = rng.normal(0, 1.0, (200, 3))
    phi[:4] = [[np.pi - 1e-3, 0, 0], [0, np.pi - 1e-3, 0], [0, 0, np.pi - 1e-3], [0, 0, 0]]
    R = gen.so3_exp(phi)
    q = gen.matrix_to_quat(R)
    assert np.allclose(ref.quat_to_matrix(torch.from_numpy(q)).numpy(), R, atol=1e-12)
    p = torch.from_numpy(phi[4:] * 0.5)
    assert torch.allclose(ref.so3_log(ref.so3_exp(p)), p, atol=1e-12)


def test_edge_jacobians_match_finite_differences():
    g = torch.Generator().manual_seed(1)
    Rs = ref.so3_exp(0.3 * torch.randn(3, 3, generator=g, dtype=torch.float64))
    ts = torch.randn(3, 3, generator=g, dtype=torch.float64)
    args = (Rs[0], ts[0], Rs[1], ts[1], Rs[2], ts[2])
    J = torch.func.jacrev(ref.edge_residual)(torch.zeros(12, dtype=torch.float64), *args)
    eye, eps = torch.eye(12, dtype=torch.float64), 1e-6
    fd = torch.stack([(ref.edge_residual(eps * eye[k], *args)
                       - ref.edge_residual(-eps * eye[k], *args)) / (2 * eps)
                      for k in range(12)], -1)
    assert torch.allclose(J, fd, atol=1e-8)


@pytest.mark.parametrize("k", [0, 1])
def test_the_reference_solves_as_the_program_does(k):
    conf = _conf()
    traffic = harness.load_json(harness.PKG / "traffic" / "loop_closures.json")
    inp = pgo_loops.Inputs(conf, 2**33 + 9, "cpu")
    solve = pgo_loops.program_solver(conf, traffic, inp)
    (_, st, a), = pgo_loops.chain(solve, inp, k, 1, (inp.q0, inp.t0), lambda: None)
    start, ans = pgo_loops.as_matrices(*st), pgo_loops.as_matrices(*a)
    dt, dr = pgo_loops.gaps(inp, k, start, ans, int(traffic["gn_steps"]), "cpu")
    t_gap, r_gap = dt.max().item(), dr.max().item()
    moved, _ = ref.pose_gaps(*start, *ans)
    # float32 against float64, far inside what the solve moves the poses
    assert t_gap < 1e-4 and r_gap < 1e-5
    assert moved.max().item() > 100 * t_gap
    names = set(pgo_loops.numbers(inp, k, dt, dr))
    assert names == ({"start_t_med_m", "start_r_med_rad"} if k == 0 else {"pose_t_m", "pose_r_rad"})
