"""Pose-graph optimization, port vs JAX package, on one device.

A 40-pose ring (a circle of 6 m with roll / pitch wobble) whose initial
poses drift from the truth, with sequential edges (the truth's relative
poses plus noise), two loop edges closing the ring and zero-weight padding
edges (identity measurements on pose 0, as ``posegraph.build_edges`` pads
unused loop slots). The same numpy arrays go through ``pgo_step``,
``pgo_step_cg``, their 4-DoF forms and ``optimize_pose_graph`` (dense and
cg) of both packages: poses to 1e-4 (quaternion components and metres),
costs to 1e-4 relative. Also: the edge residuals and Jacobians, a non-PD
Hessian giving NaN (no silent regularisation), and the mesh form equal to
the one-device solve of the padded edges.
Costs are held to 1e-3 relative (1e-4 at the first linearization): after a
few steps they are sums of squares of residuals near f32 noise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mloam_tpu.core import se3 as jse3
from mloam_tpu.core.se3 import Pose as JPose
from mloam_tpu.parallel import sharded_pgo as JPG
from mloam_tpu_torch.core.se3 import Pose as TPose
from mloam_tpu_torch.parallel import sharded_pgo as TPG
from mloam_tpu_torch.parallel.mesh import make_mesh
from mloam_tpu_torch.utils import convert

N_POSES = 40
TOL = 1e-4
# a cost near convergence is a sum of squares of f32 residual noise
COST_RTOL = 1e-3


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def ring_problem(seed=0, n=N_POSES, pad=3):
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(n) / n
    xi_gt = np.zeros((n, 6), np.float32)
    xi_gt[:, 0], xi_gt[:, 1] = 6 * np.cos(ang), 6 * np.sin(ang)
    xi_gt[:, 3:5] = 0.05 * rng.standard_normal((n, 2))
    xi_gt[:, 5] = ang + np.pi / 2
    gt = jse3.exp(jnp.asarray(xi_gt))
    gt = JPose(gt.q, jnp.asarray(xi_gt[:, :3]))
    i = np.arange(n - 1)
    j = i + 1
    rel = jse3.relative(JPose(gt.q[i], gt.t[i]), JPose(gt.q[j], gt.t[j]))
    noise = jse3.exp(jnp.asarray(0.01 * rng.standard_normal((n - 1, 6)), jnp.float32))
    rel = jse3.compose(rel, noise)
    li, lj = np.array([0, 1]), np.array([n - 1, n - 2])
    lrel = jse3.relative(JPose(gt.q[li], gt.t[li]), JPose(gt.q[lj], gt.t[lj]))
    z_q = np.concatenate([np.asarray(rel.q), np.asarray(lrel.q),
                          np.tile([1.0, 0, 0, 0], (pad, 1))]).astype(np.float32)
    z_t = np.concatenate([np.asarray(rel.t), np.asarray(lrel.t),
                          np.zeros((pad, 3))]).astype(np.float32)
    w = np.concatenate([np.ones((n - 1, 6)), 5 * np.ones((2, 6)),
                        np.zeros((pad, 6))]).astype(np.float32)
    edges = (np.concatenate([i, li, np.zeros(pad)]).astype(np.int32),
             np.concatenate([j, lj, np.zeros(pad)]).astype(np.int32), z_q, z_t, w)
    # initial poses: the truth with a drift growing along the ring
    drift = jse3.exp(jnp.asarray(np.outer(np.arange(n), [0.02, 0.01, 0, 0, 0, 0.004]),
                                 jnp.float32))
    init = jse3.compose(gt, drift)
    return (np.asarray(init.q), np.asarray(init.t)), edges, xi_gt[:, :3]


def sides(problem):
    (q, t), e, _ = problem
    q, t = q.copy(), t.copy()
    jp, je = JPose(jnp.asarray(q), jnp.asarray(t)), JPG.PoseGraphEdges(*map(jnp.asarray, e))
    tp = TPose(torch.from_numpy(q), torch.from_numpy(t))
    return jp, je, tp, convert.pose_graph_edges_from_numpy(e)


def close(tp, jp):
    np.testing.assert_allclose(N(tp.t), N(jp.t), rtol=0, atol=TOL)
    # a quaternion and its negation are one rotation
    dq = np.minimum(np.abs(N(tp.q) - N(jp.q)).max(-1), np.abs(N(tp.q) + N(jp.q)).max(-1))
    assert dq.max() < TOL, dq.max()


@pytest.mark.parametrize("dof4", [False, True], ids=["dof6", "dof4"])
def test_linearization(dof4):
    jp, je, tp, te = sides(ring_problem())
    r, J = TPG._linearize_sparse(tp, te, dof4)
    jr, jJ = JPG._linearize_sparse(jp, je, dof4)
    np.testing.assert_allclose(N(r), N(jr), rtol=0, atol=1e-5)
    np.testing.assert_allclose(N(J), N(jJ), rtol=0, atol=1e-4)
    H, g, c = TPG._linearize_edges(tp, te, dof4)
    jH, jg, jc = JPG._linearize_edges(jp, je, 0, 1e3, dof4)
    np.testing.assert_allclose(N(H), N(jH), rtol=0, atol=1e-3)
    np.testing.assert_allclose(N(g), N(jg), rtol=0, atol=1e-4)
    assert float(c) == pytest.approx(float(jc), rel=TOL)


@pytest.mark.parametrize("dof4", [False, True], ids=["dof6", "dof4"])
def test_pgo_step_dense(dof4):
    jp, je, tp, te = sides(ring_problem())
    for _ in range(3):
        tp, tc = TPG.pgo_step(tp, te, dof4=dof4)
        jp, jc = JPG.pgo_step(jp, je, dof4=dof4)
        close(tp, jp)
        assert float(tc) == pytest.approx(float(jc), rel=COST_RTOL)


@pytest.mark.parametrize("dof4", [False, True], ids=["dof6", "dof4"])
def test_pgo_step_cg(dof4):
    jp, je, tp, te = sides(ring_problem(1))
    tp2, tc = TPG.pgo_step_cg(tp, te, cg_iters=50, dof4=dof4)
    jp2, jc = JPG.pgo_step_cg(jp, je, cg_iters=50, dof4=dof4)
    close(tp2, jp2)
    assert float(tc) == pytest.approx(float(jc), rel=COST_RTOL)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_optimize_pose_graph(solver):
    problem = ring_problem(2)
    jp, je, tp, te = sides(problem)
    out = TPG.optimize_pose_graph(tp, te, iters=3, solver=solver, cg_iters=30)
    jout = JPG.optimize_pose_graph(jp, je, iters=3, solver=solver, cg_iters=30)
    close(out, jout)
    # the loop edges pull the drifted end back to the truth
    gt_t = problem[2]
    err0 = np.linalg.norm(problem[0][1][-1] - gt_t[-1])
    assert np.linalg.norm(N(out.t[-1]) - gt_t[-1]) < 0.5 * err0


def test_auto_picks_dense_at_or_under_512_poses(monkeypatch):
    _, _, tp, te = sides(ring_problem())
    calls = []
    monkeypatch.setattr(TPG, "pgo_step", lambda *a, **k: calls.append("dense") or (a[0], 0))
    monkeypatch.setattr(TPG, "pgo_step_cg", lambda *a, **k: calls.append("cg") or (a[0], 0))
    TPG.optimize_pose_graph(tp, te, iters=2)
    assert calls == ["dense", "dense"]


def test_non_pd_hessian_gives_nan_not_a_regularised_step():
    """A NaN edge weight makes the damped H unfactorable: the step is NaN,
    as the JAX package's Cholesky gives it."""
    (q, t), (i, j, zq, zt, w), gt = ring_problem(3)
    w = w.copy()
    w[5] = np.nan
    _, _, tp, te = sides(((q, t), (i, j, zq, zt, w), gt))
    out, _ = TPG.pgo_step(tp, te)
    assert torch.isnan(out.t).all()


def test_mesh_is_refused():
    """The mesh form is no longer refused: edge-sharded over a stacked
    3-shard mesh it equals the one-device solve to the bit, dense and PCG
    (the 44 edges are padded to 45 = 3 x 15 either way)."""
    _, _, tp, te = sides(ring_problem())
    mesh = make_mesh(3, device="cpu")
    for solver in ("dense", "cg"):
        out = TPG.optimize_pose_graph(tp, te, iters=2, mesh=mesh, solver=solver, cg_iters=30)
        one = TPG.optimize_pose_graph(tp, TPG.pad_edges(te, 3), iters=2, solver=solver,
                                      cg_iters=30)
        assert torch.equal(out.t, one.t) and torch.equal(out.q, one.q)
