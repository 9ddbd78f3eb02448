"""Closed-form eigendecomposition of batched symmetric 3x3 matrices.

The map correspondence builders need the extremal eigenpair of ten to twenty
thousand 3x3 covariances per sweep; a batched LAPACK/cuSOLVER ``eigh`` is an
iterative routine per matrix. This module computes eigenvalues by the
trigonometric (Cardano) method and eigenvectors by cross-products of
(A - λI) rows — elementwise math, fully vectorized, no data-dependent
control flow. Counterpart of ``mloam_tpu/ops/sym3x3.py``.

Accuracy: eigenvalues to ~1e-6 relative; eigenvectors degrade gracefully for
near-degenerate pairs (the callers only branch on eigenvalue *ratios* and
use the extremal eigenvectors, which are well-separated exactly when the
geometric tests pass).
"""

from __future__ import annotations

import math

import torch

from mloam_tpu_torch.core.rotations import _cross

_EPS = 1e-12


def eigvalsh3(A: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues of symmetric [..., 3, 3] -> [..., 3]."""
    a00 = A[..., 0, 0]
    a11 = A[..., 1, 1]
    a22 = A[..., 2, 2]
    a01 = A[..., 0, 1]
    a02 = A[..., 0, 2]
    a12 = A[..., 1, 2]

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=_EPS))
    # det(B)/2 with B = (A - qI)
    detB = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = detB / (2.0 * torch.clamp(p * p * p, min=_EPS))
    r = torch.clamp(r, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    return torch.stack([e_lo, e_mid, e_hi], dim=-1)


def _eigvec_for(A: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of symmetric [..., 3, 3] for eigenvalue lam [...].

    Rows of (A - λI) span the plane orthogonal to the eigenvector; the
    largest cross product of row pairs is the most numerically reliable
    estimate.
    """
    B = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    c01 = _cross(r0, r1)
    c02 = _cross(r0, r2)
    c12 = _cross(r1, r2)
    n01 = torch.sum(c01 * c01, -1)
    n02 = torch.sum(c02 * c02, -1)
    n12 = torch.sum(c12 * c12, -1)
    best = torch.argmax(torch.stack([n01, n02, n12], -1), dim=-1)
    cand = torch.stack([c01, c02, c12], dim=-2)
    idx = best[..., None, None].expand(best.shape + (1, 3))
    v = torch.gather(cand, -2, idx)[..., 0, :]
    norm = torch.linalg.norm(v, dim=-1, keepdim=True)
    # fully degenerate (isotropic) fallback: any unit vector
    fallback = torch.zeros((3,), dtype=A.dtype, device=A.device)
    fallback[:1].fill_(1.0)   # filled on the device, not copied from the host
    return torch.where(norm > 1e-10, v / torch.clamp(norm, min=_EPS), fallback)


def smallest_eigvec3(A: torch.Tensor):
    """(eigenvalues [..., 3] ascending, unit eigenvector of the smallest)."""
    vals = eigvalsh3(A)
    return vals, _eigvec_for(A, vals[..., 0])


def largest_eigvec3(A: torch.Tensor):
    """(eigenvalues [..., 3] ascending, unit eigenvector of the largest)."""
    vals = eigvalsh3(A)
    return vals, _eigvec_for(A, vals[..., 2])
