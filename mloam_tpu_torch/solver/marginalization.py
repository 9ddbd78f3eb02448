"""Schur-complement marginalization prior (VINS-style).

The solver already produces dense (H, g) on the device, so marginalization
is three calls: partition, Schur, eigh. The prior is replayed as
r(x) = r0 + J · Δ(x, x_lin), Δ being the stacked boxminus against the
linearization point. Counterpart of ``mloam_tpu/solver/marginalization.py``.

All products here are full f32 (the package switches TF32 off at import):
Hrr − Hrm·Hmm⁻¹·Hmr subtracts large nearly-equal products.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def _flag(value: bool, device) -> torch.Tensor:
    """A device bool by a fill (a tensor from a host value is a copy from
    pageable memory, which waits for the device)."""
    return torch.full((), value, dtype=torch.bool, device=device)


class MargPrior(NamedTuple):
    """Linearized prior over the *kept* tangent (dimension K)."""

    J: torch.Tensor    # [K, K] sqrt-information
    r0: torch.Tensor   # [K]
    valid: torch.Tensor  # scalar bool — inactive prior contributes nothing

    @staticmethod
    def empty(k: int, dtype=torch.float32, device=None) -> "MargPrior":
        return MargPrior(torch.zeros((k, k), dtype=dtype, device=device),
                         torch.zeros((k,), dtype=dtype, device=device),
                         _flag(False, device))

    def residual(self, delta: torch.Tensor) -> torch.Tensor:
        """delta [K] = boxminus(current kept states, linearization states)."""
        r = self.r0 + self.J @ delta
        return torch.where(self.valid, r, 0.0)


class QuadPrior(NamedTuple):
    """Marginalization prior kept in quadratic (information) form.

    cost(δ) = 0.5 δᵀ H δ + bᵀ δ (+const), δ [K] = boxminus(current kept
    states, linearization states). It contributes H to the normal equations
    and b + Hδ to the gradient — the same first-order replay semantics as
    the sqrt-info form (``MargPrior``) without the eigendecomposition needed
    to recover J. The odometry path uses this form.
    """

    H: torch.Tensor    # [K, K]
    b: torch.Tensor    # [K]
    valid: torch.Tensor  # scalar bool

    @staticmethod
    def empty(k: int, dtype=torch.float32, device=None) -> "QuadPrior":
        return QuadPrior(torch.zeros((k, k), dtype=dtype, device=device),
                         torch.zeros((k,), dtype=dtype, device=device),
                         _flag(False, device))


def _schur_core(H: torch.Tensor, g: torch.Tensor, n_drop: int, eps: float):
    """Schur complement onto the retained block: (Hp, gp). Pseudo-inverts the
    dropped block via eigh."""
    m = n_drop
    Hmm = 0.5 * (H[:m, :m] + H[:m, :m].T)
    Hmr = H[:m, m:]
    Hrm = H[m:, :m]
    Hrr = H[m:, m:]

    vals, vecs = torch.linalg.eigh(Hmm)
    inv_vals = torch.where(vals > eps, 1.0 / torch.clamp(vals, min=eps), 0.0)
    Hmm_inv = (vecs * inv_vals[None, :]) @ vecs.T

    Hp = Hrr - Hrm @ Hmm_inv @ Hmr
    gp = g[m:] - Hrm @ Hmm_inv @ g[:m]
    return Hp, gp


def schur_marginalize_quad(H: torch.Tensor, g: torch.Tensor, n_drop: int,
                           eps: float = 1e-8) -> QuadPrior:
    """Eliminate the first ``n_drop`` tangent coordinates of (H, g) into a
    quadratic-form prior on the remaining coordinates.

    The result is PSD-PROJECTED: eigenvalues clamped at zero and the
    gradient projected onto the positive-curvature range — what a sqrt-info
    recovery does implicitly. Without it, Schur pseudo-inverse noise makes
    the prior slightly indefinite, and because the prior is re-marginalized
    recursively every frame the indefiniteness compounds until the window
    solve rides the negative-curvature directions into a divergence."""
    Hp, gp = _schur_core(H, g, n_drop, eps)
    vals, vecs = torch.linalg.eigh(0.5 * (Hp + Hp.T))
    pos = vals > eps
    H_psd = (vecs * torch.where(pos, vals, 0.0)[None, :]) @ vecs.T
    g_proj = vecs @ (pos * (vecs.T @ gp))
    return QuadPrior(H=H_psd, b=g_proj, valid=_flag(True, H.device))


def schur_marginalize(H: torch.Tensor, g: torch.Tensor, n_drop: int,
                      eps: float = 1e-8) -> MargPrior:
    """Eliminate the first ``n_drop`` tangent coordinates of (H, g).

    Returns the linearized prior on the remaining coordinates in sqrt-info
    (residual-row) form, recovered by eigendecomposition.
    """
    Hp, gp = _schur_core(H, g, n_drop, eps)

    # recover sqrt-information J and r0 with Jᵀ J = Hp, Jᵀ r0 = gp
    vals2, vecs2 = torch.linalg.eigh(0.5 * (Hp + Hp.T))
    s = torch.sqrt(torch.clamp(vals2, min=0.0))
    s_inv = torch.where(vals2 > eps, 1.0 / torch.clamp(s, min=eps), 0.0)
    J = s[:, None] * vecs2.T
    r0 = (s_inv[:, None] * vecs2.T) @ gp
    return MargPrior(J=J, r0=r0, valid=_flag(True, H.device))
