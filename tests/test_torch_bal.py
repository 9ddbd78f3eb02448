"""Bundle adjustment on a BAL file, port vs JAX package.

The test writes a small BAL problem (``models/realdata.synthetic_bal``: 7
cameras, 40 points, 170 observations, seed 1) and both packages read it:
the parsed arrays and the ordered pair list are equal; the Snavely residuals
(1e-4 px) and Jacobians (1e-4 of their largest entry); one ``lm_step`` at
damping 1e-2 (1e-4 relative to each parameter block's scale); five-iteration ``solve_bal``
histories with the trivial loss and with huber (1e-3 relative); the
observation-sharded assembly on 4 shards (1-D and 2x2) within 1e-5 of each
block's largest entry of the dense assembly, as the JAX package's sharded
one is of its own, and to the bit the one-device sums over the same padded
observations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from mloam_tpu.solver import bal as JBAL
from mloam_tpu_torch.models import realdata as RD
from mloam_tpu_torch.ops.segsum import index_sum
from mloam_tpu_torch.parallel import mesh as M
from mloam_tpu_torch.solver import bal as BAL
from mloam_tpu_torch.utils import convert


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bal") / "problem.txt")
    (cams, pts, ci, pi, obs), _ = RD.synthetic_bal(1, n_cams=7, n_pts=40, n_obs=170)
    BAL.write_bal(path, cams, pts, ci, pi, obs)
    return JBAL.load_bal(path), BAL.load_bal(path, device="cpu")


def _rel(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-12)
    np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=tol)


def test_load_bal_equals_the_jax_parse(problem):
    jp, tp = problem
    for f, a, b in zip(BAL.BalProblem._fields, jp, tp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f)
    conv = convert.bal_problem_from_numpy(jax.tree.map(np.asarray, jp))
    for f, a, b in zip(BAL.BalProblem._fields, conv, tp):
        assert torch.equal(a, b), f


def test_residuals_and_jacobians(problem):
    jp, tp = problem
    jr, jw, jJc, jJp = JBAL._linearize_obs(jp.cams, jp.pts, jp, "huber", 2.0, 1.0)
    r, w, Jc, Jp = BAL._linearize_obs(tp.cams, tp.pts, tp, "huber", 2.0, 1.0)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0, atol=1e-3)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-4, atol=1e-6)
    _rel(Jc, jJc, 1e-4)
    _rel(Jp, jJp, 1e-4)
    for loss in ("trivial", "huber", "gm", "gnc_gm"):
        assert float(BAL.bal_cost(tp.cams, tp.pts, tp, loss, 2.0, 3.0)) == pytest.approx(
            float(JBAL.bal_cost(jp.cams, jp.pts, jp, loss, 2.0, 3.0)), rel=1e-5)


def test_one_lm_step(problem):
    """At damping 1e-2: the problem's 7-dof gauge is held by the damping
    alone, and at 1e-4 the f32 step along it differs by 2e-3 between the
    packages' orders of summation."""
    jp, tp = problem
    jc, jx = JBAL.lm_step(jp.cams, jp.pts, jp, 1e-2)
    c, x = BAL.lm_step(tp.cams, tp.pts, tp, 1e-2)
    for block in (slice(0, 3), slice(3, 6), slice(6, 9)):
        _rel(c[:, block] - tp.cams[:, block], np.asarray(jc)[:, block] - tp.cams[:, block].numpy(),
             1e-4)
    _rel(x - tp.pts, np.asarray(jx) - tp.pts.numpy(), 1e-4)


@pytest.mark.parametrize("loss", ["trivial", "huber"])
def test_solve_bal_histories(problem, loss):
    jp, tp = problem
    _, _, jh = JBAL.solve_bal(jp, iters=5, loss=loss, loss_scale=2.0)
    _, _, h = BAL.solve_bal(tp, iters=5, loss=loss, loss_scale=2.0)
    np.testing.assert_allclose(h, jh, rtol=1e-3)
    assert h[-1] < 0.1 * h[0]


def test_sharded_assembly(problem):
    jp, tp = problem
    dense = BAL.dense_assemble(tp.cams, tp.pts, tp, "trivial", 1.0, 1.0)
    jmesh = Mesh(np.asarray(jax.devices()[:4]), ("obs",))
    jsh = JBAL.make_sharded_assemble(jmesh)(jp.cams, jp.pts, jp, "trivial", 1.0, 1.0)
    jdense = JBAL.dense_assemble(jp.cams, jp.pts, jp, "trivial", 1.0, 1.0)
    for mesh in (M.make_mesh(4, device="cpu"), M.make_multihost_mesh(2, 2, device="cpu")):
        sh = BAL.make_sharded_assemble(mesh)(tp.cams, tp.pts, tp, "trivial", 1.0, 1.0)
        # the padded observations' rows: the dense sums over the same rows
        pad = (-tp.obs.shape[0]) % 4
        assert pad > 0
        for a, b, ja, jb in zip(sh, dense, jsh, jdense):
            _rel(a, b, 1e-5)
            _rel(ja, jb, 1e-5)
            _rel(a, ja, 1e-4)
    z = torch.zeros
    ext = tp._replace(cam_idx=torch.cat([tp.cam_idx, z(pad, dtype=torch.int64)]),
                      pt_idx=torch.cat([tp.pt_idx, z(pad, dtype=torch.int64)]),
                      obs=torch.cat([tp.obs, z(pad, 2)]))
    r, w, Jc, Jp = BAL._linearize_obs(tp.cams, tp.pts, ext, "trivial", 1.0, 1.0)
    w = w * (torch.arange(w.shape[0]) < tp.obs.shape[0])
    cc, pp, A, gc, gp = BAL._blocks(r, w, Jc, Jp)
    want = (index_sum(cc, ext.cam_idx, 7), index_sum(pp, ext.pt_idx, 40), A[:tp.obs.shape[0]],
            index_sum(gc, ext.cam_idx, 7), index_sum(gp, ext.pt_idx, 40))
    for a, b in zip(sh, want):
        assert torch.equal(a, b)
    assert jnp.isfinite(jsh[0]).all()
