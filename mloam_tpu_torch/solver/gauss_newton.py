"""Gauss-Newton / Levenberg-Marquardt on product manifolds, dense form.

Counterpart of ``mloam_tpu/solver/gauss_newton.py``:

  * The state is any nest of tuples/NamedTuples/lists/dicts of tensors with a
    user ``retract(x, dx)`` taking a flat tangent vector dx [D]. SLAM states
    here are tiny (window poses + extrinsics: D <= ~60), so the normal
    equations are assembled densely and solved directly.
  * Jacobians come from one ``torch.func.jacfwd`` of the residual at dx = 0,
    or from the caller's closed-form ``linearize_fn``.
  * Robust IRLS weights are recomputed each iteration from the current
    residuals (see robust.py).
  * A fixed iteration count; LM damping adapts multiplicatively on cost
    increase. Accept/reject is a ``torch.where`` on device values — no
    ``.item()``, no Python branch on a tensor — so the host never waits on
    the device inside a solve.
  * Degeneracy solution-remapping (``remap_threshold``) builds the per-block
    eigenprojector ONCE from the initial measurement Hessian and applies it
    to every update.
  * A marginalization prior enters as a quadratic form (``quad_prior``):
    H += Hp, g += b + Hp·δ(x).

A damped Hessian that is not positive definite makes ``solve_normal`` return
NaN (``cholesky_ex`` reports instead of raising); the trial cost is then NaN,
``cost <= st.cost`` is False and the step is rejected — the same outcome as
the JAX package's NaN-propagating Cholesky.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from mloam_tpu_torch.solver import degeneracy
from mloam_tpu_torch.solver.marginalization import QuadPrior

# residual_fn(x) -> (r [N], w [N]); w already folds validity mask and any
# per-residual sqrt-information. Robust reweighting happens there too.
ResidualFn = Callable[[Any], tuple[torch.Tensor, torch.Tensor]]
RetractFn = Callable[[Any, torch.Tensor], Any]
# linearize_fn(x) -> (H [D,D], g [D], cost): closed-form normal equations.
LinearizeFn = Callable[[Any], tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
# quad_prior = (delta_fn, QuadPrior): delta_fn(x) -> [D] boxminus of the
# optimized states against the prior's linearization points.
QuadPriorSpec = tuple[Callable[[Any], torch.Tensor], QuadPrior]


class GNState(NamedTuple):
    x: Any
    cost: torch.Tensor
    lm_lambda: torch.Tensor
    H: torch.Tensor   # damping-free JᵀWJ (+prior) of the *last* linearization
    g: torch.Tensor
    eig0: torch.Tensor  # [D/6, 6] ascending eigvals of H0's diagonal blocks
    #                     (zeros unless remap_threshold was given)
    frozen: torch.Tensor  # [D/6] directions actually frozen per block =
    #                       trace deficit of the applied projector
    eig_shared: torch.Tensor  # [6] ascending spectrum of the mean
    #                           non-anchored block (zeros when no remap)
    weak_dir: torch.Tensor  # [6] weakest eigvector of the shared-mean block
    #                         (zeros when no remap)


def tree_where(cond: torch.Tensor, a, b):
    """Leafwise ``torch.where(cond, a, b)`` over matching nests."""
    if isinstance(a, torch.Tensor):
        return torch.where(cond, a, b)
    if isinstance(a, dict):
        return {k: tree_where(cond, a[k], b[k]) for k in a}
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(tree_where(cond, x, y) for x, y in zip(a, b)))
    if isinstance(a, (tuple, list)):
        return type(a)(tree_where(cond, x, y) for x, y in zip(a, b))
    return a


def _linearize(residual_fn: ResidualFn, retract: RetractFn, x, dim: int,
               quad_prior: QuadPriorSpec | None = None,
               linearize_fn: LinearizeFn | None = None,
               mu=None):
    """Build (H, g, cost, H_meas) at x. One jacfwd over the flat tangent, or
    the caller's closed-form ``linearize_fn`` when given.

    IRLS robust weights belong *inside* residual_fn (computed from the
    detached current residuals): the weight w is taken from the evaluation
    at dx=0 and the Jacobian only differentiates the raw residual, which is
    exactly the IRLS linearization.
    """
    if linearize_fn is not None:
        H, g, cost = (linearize_fn(x) if mu is None
                      else linearize_fn(x, mu))
    else:
        rf = residual_fn if mu is None else (lambda xx: residual_fn(xx, mu))

        def res_at(dx):
            r, _ = rf(retract(x, dx))
            return r

        r, w = rf(x)
        zero = torch.zeros((dim,), dtype=torch.float32, device=r.device)
        J = torch.func.jacfwd(res_at)(zero)     # [N, D]
        Jw = J * w[:, None]
        H = J.T @ Jw                             # [D, D]
        g = Jw.T @ r                             # [D]
        cost = 0.5 * torch.sum(w * r * r)
    H_meas = H
    if quad_prior is not None:
        delta_fn, qp = quad_prior
        val = qp.valid.to(H.dtype)
        delta = delta_fn(x)
        Hq = qp.H * val
        Hqd = Hq @ delta
        H = H + Hq
        g = g + val * qp.b + Hqd
        cost = cost + 0.5 * torch.dot(delta, Hqd) + val * torch.dot(qp.b, delta)
    return H, g, cost, H_meas


def solve_normal(H: torch.Tensor, g: torch.Tensor, lm_lambda) -> torch.Tensor:
    """Marquardt-scaled damped solve: Hd = H + λ (diag(H) + ε I).

    Scaling by diag(H) (not plain λI) matters for gauge-deficient SLAM
    windows: in a pure-relative problem the Hessian has an exact nullspace,
    and with λI damping the step along it is g_noise/λ — f32 reduction noise
    over thousands of residuals divided by a tiny λ produces meter-scale
    coherent window jumps. diag-scaled damping keeps the effective curvature
    in every direction proportional to the problem's own scale.

    Returns NaN when the damped matrix is not positive definite.
    """
    d = H.shape[0]
    eye = torch.eye(d, dtype=H.dtype, device=H.device)
    damp = torch.diag(torch.diagonal(H)) + 1e-3 * eye
    Hd = H + lm_lambda * damp
    L, info = torch.linalg.cholesky_ex(Hd + 1e-8 * eye)
    dx = torch.cholesky_solve(g[:, None], L)[:, 0]
    return torch.where(info == 0, -dx, torch.nan)


def gauss_newton(
    residual_fn: ResidualFn,
    x0: Any,
    retract: RetractFn,
    dim: int,
    iters: int,
    init_lambda: float = 1e-4,
    remap_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
    remap_threshold: float | None = None,
    remap_max_freeze: int | None = 1,
    remap_shared: bool = False,
    remap_rel_gap: float | None = None,
    remap_snap_purity: float | None = None,
    remap_P: torch.Tensor | None = None,
    remap_spectra: tuple | None = None,
    init_linearization=None,
    quad_prior: QuadPriorSpec | None = None,
    linearize_fn: LinearizeFn | None = None,
    iteration_hook: Callable[[int, GNState], GNState] | None = None,
    mu_schedule: Callable[[int], float] | None = None,
) -> GNState:
    """Run ``iters`` damped GN steps.

    ``linearize_fn(x) -> (H, g, cost)`` supplies closed-form normal
    equations (analytic factor Jacobians) instead of the jacfwd default;
    ``residual_fn`` may then be ``None``. The quadratic prior is applied on
    top either way.

    ``remap_threshold``: build the per-6-dof-block degeneracy projector once
    from the initial measurement-only Hessian (the marginalization prior's
    accumulated memory would otherwise mask directions the current sweep
    cannot observe) and apply it to every update; block eigenvalues are
    returned in ``GNState.eig0``. ``remap_max_freeze`` caps the number of
    frozen directions per block. ``remap_P`` is an externally built
    projector; ``remap_spectra`` = (eig0 [n, 6], eig_shared [6], weak_dir
    [6]) of the initial measurement Hessian, when the caller computed them
    with it (then no ``eigh`` runs here: each waits for the device).
    ``remap_fn(H, dx) -> dx`` is the fully general per-iteration form.

    ``init_linearization``: (H, g, cost, H_meas) at x0 when the caller has
    already linearized there.

    ``iteration_hook(i, state) -> state`` is applied after every step.

    ``mu_schedule(i) -> μ`` enables graduated non-convexity: residual_fn /
    linearize_fn are then called as ``fn(x, μ_i)`` with the scheduled
    convexity at each (re-)linearization — see robust.gnc_mu_schedule."""
    mu0 = mu_schedule(0) if mu_schedule is not None else None
    if init_linearization is not None:
        H0, g0, c0, Hm0 = init_linearization
    else:
        H0, g0, c0, Hm0 = _linearize(residual_fn, retract, x0, dim,
                                     quad_prior, linearize_fn, mu0)
    n_bl = dim // 6 if dim % 6 == 0 else 0
    dev, dt = H0.device, H0.dtype
    eig_sh = wdir = None
    if remap_P is not None:
        P0 = remap_P
        if remap_spectra is not None:
            eig0, eig_sh, wdir = remap_spectra
        else:
            eig0 = torch.linalg.eigvalsh(degeneracy.diag_blocks(Hm0, n_bl))
    elif remap_threshold is not None:
        P0, eig0 = degeneracy.block_projector(
            Hm0, remap_threshold, remap_max_freeze, shared=remap_shared,
            rel_gap=remap_rel_gap, snap_purity=remap_snap_purity)
    else:
        P0 = None
    if P0 is not None:
        frozen0 = 6.0 - torch.diagonal(P0, dim1=-2, dim2=-1).sum(-1)
        if eig_sh is None:
            eig_sh, wdir = degeneracy.shared_weak_direction(Hm0)
    else:
        eig0 = torch.zeros((n_bl, 6), dtype=dt, device=dev)
        frozen0 = torch.zeros((n_bl,), dtype=dt, device=dev)
        eig_sh = torch.zeros((6,), dtype=dt, device=dev)
        wdir = torch.zeros((6,), dtype=dt, device=dev)
    st = GNState(x0, c0, torch.full((), init_lambda, dtype=torch.float32, device=dev),
                 H0, g0, eig0, frozen0, eig_sh, wdir)

    for i in range(iters):
        if mu_schedule is not None:
            # GNC annealing: costs under different convexity μ are not
            # comparable. Re-linearize the current iterate under this
            # iteration's μ so the step, the reference cost, and the trial
            # cost all share one μ.
            mu_i = mu_schedule(i + 1)
            H_r, g_r, c_r, _ = _linearize(residual_fn, retract, st.x, dim,
                                          quad_prior, linearize_fn, mu_i)
            st = st._replace(H=H_r, g=g_r, cost=c_r)
        else:
            mu_i = None
        dx = solve_normal(st.H, st.g, st.lm_lambda)
        if P0 is not None:
            dx = degeneracy.apply_block_projector(P0, dx)
        if remap_fn is not None:
            dx = remap_fn(st.H, dx)
        x_new = retract(st.x, dx)
        H, g, cost, _ = _linearize(residual_fn, retract, x_new, dim,
                                   quad_prior, linearize_fn, mu_i)
        accept = cost <= st.cost
        lam = torch.where(accept, st.lm_lambda * 0.5, st.lm_lambda * 4.0)
        lam = torch.clamp(lam, 1e-5, 1e2)
        # branch-free accept/reject
        st = GNState(
            tree_where(accept, x_new, st.x),
            torch.where(accept, cost, st.cost),
            lam,
            torch.where(accept, H, st.H),
            torch.where(accept, g, st.g),
            st.eig0,
            st.frozen,
            st.eig_shared,
            st.weak_dir,
        )
        if iteration_hook is not None:
            st = iteration_hook(i, st)
    return st
