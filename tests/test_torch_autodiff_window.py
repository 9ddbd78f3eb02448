"""Port vs JAX package: ``optimize_window(analytic=False)``, the window
solve linearized by forward-mode AD over the stacked residuals (the
``residual_fn`` handed to ``gauss_newton`` with no ``linearize_fn``), held
against the JAX package's ``analytic=False`` and against the port's own
closed-form ``analytic=True``, on the windows and to the tolerances of the
JAX package's ``tests/test_window_linearize.py``: poses to 1e-4 m / 1e-5,
cost to 1e-4 relative, H to 2e-4 of max|H|, g to 2e-3 of
max(max|g|, 1e-3); one lidar, and two in calibration mode (one
Gauss-Newton step, as that test explains).
"""

import dataclasses

import jax
import numpy as np
import pytest

from mloam_tpu.odometry import estimator as JE
from mloam_tpu_torch.odometry import estimator as TE
from mloam_tpu_torch.utils import convert
from test_torch_odometry import N
from test_window_linearize import _make_window, _small_cfg


def np_(x):
    return jax.tree.map(np.asarray, x)


def _linearize_cfgs(n_lidars):
    j = _small_cfg(n_lidars)
    return j, convert.config_from_reference(dataclasses.asdict(j))


@pytest.mark.parametrize("calibrate_ext,n_lidars", [(False, 1), (True, 2)],
                         ids=["pure_odometry_single_lidar", "calibration_mode_dual_lidar"])
def test_autodiff_window_matches_reference_and_analytic(calibrate_ext, n_lidars):
    jcfg, tcfg = _linearize_cfgs(n_lidars)
    state = _make_window(jcfg, n_lidars)
    if calibrate_ext:
        state = JE.reset_prior(state, jcfg, calibrate_ext=True)
    run = jax.jit(JE.optimize_window, static_argnames=("cfg", "calibrate_ext", "analytic"))
    jst, jsol = run(state, cfg=jcfg, calibrate_ext=calibrate_ext, analytic=False)
    tstate = convert.window_state_from_numpy(np_(state))
    tb = TE.optimize_window(tstate, tcfg, calibrate_ext=calibrate_ext, analytic=False)
    ta = TE.optimize_window(tstate, tcfg, calibrate_ext=calibrate_ext, analytic=True)
    assert int(tb[1].n_surf) > 30 and int(tb[1].n_corner) > 5
    for (st_a, sol_a), (st_b, sol_b) in (((tb[0], tb[1]), (jst, jsol)), (ta, tb)):
        np.testing.assert_allclose(N(st_a.poses.t), N(st_b.poses.t), atol=1e-4)
        np.testing.assert_allclose(N(st_a.poses.q), N(st_b.poses.q), atol=1e-5)
        np.testing.assert_allclose(N(st_a.ext.q), N(st_b.ext.q), atol=1e-5)
        np.testing.assert_allclose(float(sol_a.cost), float(sol_b.cost), rtol=1e-4)
        scale = np.abs(N(sol_b.H)).max()
        np.testing.assert_allclose(N(sol_a.H) / scale, N(sol_b.H) / scale, atol=2e-4)
        gs = max(np.abs(N(sol_b.g)).max(), 1e-3)
        np.testing.assert_allclose(N(sol_a.g) / gs, N(sol_b.g) / gs, atol=2e-3)
