"""Port vs JAX package: the window's armed degeneracy gate
(``optimize_window`` with ``eig_threshold > 0``) and degeneracy-consistent
marginalization (``marginalize_pivot``), step by step on the corridor course
of ``tests/torch_corridor_case.py``.

The JAX pipeline runs the course; after each solved sweep its window state
is carried across (``utils/convert``) and both packages' ``optimize_window``
solve that same window again, then marginalize. Held per step:

  * the persistence count ``deg_count`` and ``engage`` exactly (engaged:
    the projector handed to the solve is not the identity);
  * the stored weak direction ``deg_dir`` to 1e-4 up to sign (LAPACK may
    return either);
  * the projector ``remap_P`` to 1e-5 and the frozen count exactly;
  * the support count ``support_neff`` to 1e-3 relative;
  * the poses to 1e-4 m and 1e-5 in the quaternion;
  * the projected prior (H, b) to 1e-4 of max|H| (b differs by up to
    1.1e-4 where max|b| is 0.6: the re-solved poses differ in their last
    bits and b = H·δ carries that).

A step whose weakest shared eigenvalue lies within 1e-3 relative of the
threshold would be decided by rounding: such a step is named and skipped
(none does at this width, where every one is 17-31 against 175).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mloam_tpu.core.rangeimage import RangeImage as JRangeImage
from mloam_tpu.models.pipeline import OdometryPipeline as JPipeline
from mloam_tpu.odometry import estimator as JE
from mloam_tpu_torch.odometry import estimator as TE
from mloam_tpu_torch.utils import convert
from torch_corridor_case import N, configs, render

N_SWEEPS = 10


@pytest.fixture(scope="module")
def steps():
    jcfg, tcfg = configs()
    imgs, _ = render(jcfg, N_SWEEPS)
    jpipe = JPipeline(jcfg)
    opt = jax.jit(JE.optimize_window, static_argnames=("cfg", "calibrate_ext", "lidars",
                                                        "analytic"))
    marg = jax.jit(JE.marginalize_pivot, static_argnames=("cfg", "calibrate_ext"))
    out = []
    for i in range(N_SWEEPS):
        o = jpipe.process([JRangeImage(*(f[i] for f in imgs))])
        if o.win_frozen is None:      # warm-up sweeps: no window solve
            continue
        state = jax.tree.map(np.asarray, jpipe.window)
        jst, jsol = opt(jax.tree.map(jnp.asarray, state), cfg=jcfg)
        jprior = marg(jst, jsol, cfg=jcfg)
        tst, tsol = TE.optimize_window(convert.window_state_from_numpy(state), tcfg)
        tprior = TE.marginalize_pivot(tst, tsol, tcfg)
        out.append((i, jcfg, (jst, jsol, jprior), (tst, tsol, tprior)))
    return out


def _engaged(P):
    return not np.allclose(N(P), np.eye(6)[None], atol=1e-6)


def _near_threshold(jsol, thr):
    return abs(float(jsol.eig_shared[0]) - thr) < 1e-3 * thr


def test_gate_matches_reference_step_by_step(steps):
    seen = set()
    for i, jcfg, (jst, jsol, _), (tst, tsol, _) in steps:
        oc = jcfg.odometry
        if _near_threshold(jsol, oc.eig_threshold):
            print(f"sweep {i}: weakest eigenvalue within 1e-3 of the threshold, skipped")
            continue
        assert int(tst.deg_count) == int(jst.deg_count), f"sweep {i}"
        dd, jd = N(tst.deg_dir), N(jst.deg_dir)
        assert min(np.abs(dd - jd).max(), np.abs(dd + jd).max()) < 1e-4, f"sweep {i}"
        engaged = _engaged(jsol.remap_P)
        assert _engaged(tsol.remap_P) == engaged, f"sweep {i}"
        np.testing.assert_allclose(N(tsol.remap_P), N(jsol.remap_P), atol=1e-5)
        np.testing.assert_array_equal(N(tsol.frozen), N(jsol.frozen))
        np.testing.assert_allclose(float(tsol.support_neff), float(jsol.support_neff),
                                   rtol=1e-3)
        np.testing.assert_allclose(N(tst.poses.t), N(jst.poses.t), atol=1e-4)
        np.testing.assert_allclose(N(tst.poses.q), N(jst.poses.q), atol=1e-5)
        below = float(jsol.eig_shared[0]) < oc.eig_threshold
        seen.add((below, engaged, int(jst.deg_count) >= oc.eig_persist_k))
    # below the threshold but not yet persistent (off), and engaged
    assert (True, False, False) in seen
    assert (True, True, True) in seen


def test_engaged_projector_freezes_one_snapped_axis(steps):
    """Engaged, the projector removes exactly one direction: the canonical
    tangent axis that dominates the stored weak direction (snapped, since
    its share passes ``eig_snap_purity``). On this 8-ring sensor that axis
    is z (the tunnel's vertical extent is seen by few rings); at full width
    the corridor starves x."""
    engaged = [(i, st, sol) for i, _, _, (st, sol, _) in steps if _engaged(sol.remap_P)]
    assert engaged
    for i, tst, tsol in engaged:
        P = N(tsol.remap_P)
        axis = int(np.argmax(np.abs(N(tst.deg_dir))))
        want = np.eye(6)
        want[axis, axis] = 0.0
        np.testing.assert_array_equal(P, np.broadcast_to(want, P.shape), err_msg=f"sweep {i}")
        np.testing.assert_array_equal(N(tsol.frozen), 1.0)


def test_projected_prior_matches_reference(steps):
    for i, _, (_, _, jprior), (_, _, tprior) in steps:
        sc = np.abs(N(jprior.prior.H)).max()
        np.testing.assert_allclose(N(tprior.prior.H), N(jprior.prior.H), atol=1e-4 * sc,
                                   err_msg=f"sweep {i}")
        np.testing.assert_allclose(N(tprior.prior.b), N(jprior.prior.b), atol=1e-4 * sc,
                                   err_msg=f"sweep {i}")
    assert any(_engaged(t.remap_P) for _, _, _, (_, t, _) in steps)


def test_marginalize_without_a_gate_projector_builds_its_own(steps):
    """``remap_P`` None (the autodiff path, where the gate does not run):
    the measurement part is projected with ``block_projector`` of it, as in
    the JAX package."""
    _, jcfg, (jst, jsol, _), (tst, tsol, _) = steps[-1]
    tcfg = configs()[1]
    jm = JE.marginalize_pivot(jst, jsol._replace(remap_P=None), jcfg)
    tm = TE.marginalize_pivot(tst, tsol._replace(remap_P=None), tcfg)
    sc = np.abs(N(jm.prior.H)).max()
    np.testing.assert_allclose(N(tm.prior.H), N(jm.prior.H), atol=1e-4 * sc)
    # and the projection changes the prior
    plain = TE.marginalize_pivot(tst, tsol, dataclasses.replace(
        tcfg, odometry=dataclasses.replace(tcfg.odometry, remap_project_prior=False)))
    assert not torch.allclose(plain.prior.H, tm.prior.H)


def test_later_outer_iterations_report_their_own_spectra(steps):
    """``outer_iters`` 2 on an engaged window: the second solve keeps the
    gate's projector but reads eig0, eig_shared and weak_dir off its own
    linearization, as the JAX package does (the first solve's would differ
    by more than the tolerance)."""
    _, jcfg, (jst, _, _), _ = steps[-1]
    tcfg = configs()[1]
    state = jax.tree.map(np.asarray, jst)
    # move the newest pose off the solved one, so that the first solve moves
    # and the second linearizes elsewhere
    t = state.poses.t.copy()
    t[-1] += np.array([0.05, 0.02, 0.03], np.float32)
    state = state._replace(poses=state.poses._replace(t=t))

    def solve(iters):
        jc = dataclasses.replace(jcfg, odometry=dataclasses.replace(jcfg.odometry,
                                                                    outer_iters=iters))
        tc = dataclasses.replace(tcfg, odometry=dataclasses.replace(tcfg.odometry,
                                                                    outer_iters=iters))
        _, jsol = JE.optimize_window(jax.tree.map(jnp.asarray, state), jc)
        _, tsol = TE.optimize_window(convert.window_state_from_numpy(state), tc)
        return jsol, tsol

    jsol, tsol = solve(2)
    assert _engaged(jsol.remap_P) and _engaged(tsol.remap_P)
    # the second linearization point differs in its last bits: 1e-3 relative
    np.testing.assert_allclose(N(tsol.eig_blocks), N(jsol.eig_blocks), rtol=1e-3)
    np.testing.assert_allclose(N(tsol.eig_shared), N(jsol.eig_shared), rtol=1e-3)
    jd, td = N(jsol.weak_dir), N(tsol.weak_dir)
    assert min(np.abs(td - jd).max(), np.abs(td + jd).max()) < 1e-3
    first, _ = solve(1)
    assert np.abs(N(first.eig_shared) / N(jsol.eig_shared) - 1.0).max() > 1e-2
