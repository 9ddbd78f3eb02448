"""Degeneracy detection + solution remapping (Zhang, "On Degeneracy of
Optimization-based State Estimation").

The projector P = V diag(λ_i >= thr) Vᵀ is applied to each 6-dof block of
the GN update. Counterpart of ``mloam_tpu/solver/degeneracy.py``.

Eigenvector signs (and the basis inside a repeated eigenvalue) differ between
LAPACK, cuSOLVER and the JAX package's backend; everything built here —
projectors, spectra — is sign-invariant, and ``shared_weak_direction``'s
vector is defined up to sign.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DegeneracyInfo(NamedTuple):
    eigvals: torch.Tensor   # [B, 6] ascending per block
    factor: torch.Tensor    # [B] smallest eigenvalue
    degenerate: torch.Tensor  # [B] bool — any direction below threshold


def diag_blocks(H: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """[n, 6, 6] diagonal blocks of H [D, D]."""
    if n is None:
        assert H.shape[0] % 6 == 0
        n = H.shape[0] // 6
    return torch.stack([H[i * 6:(i + 1) * 6, i * 6:(i + 1) * 6]
                        for i in range(n)])


def _mean_free_block(H: torch.Tensor) -> torch.Tensor:
    """Mean of the non-anchored diagonal blocks (blocks 1..n-1; block 0
    carries the gauge anchor)."""
    blocks = diag_blocks(H)
    return torch.mean(blocks[1:], dim=0) if blocks.shape[0] > 1 else blocks[0]


def analyze_blocks(H: torch.Tensor, n_blocks: int, threshold: float) -> DegeneracyInfo:
    """Eigen-analysis of the 6x6 diagonal blocks of H [D, D]."""
    vals = torch.linalg.eigvalsh(diag_blocks(H, n_blocks))
    return DegeneracyInfo(
        eigvals=vals,
        factor=vals[:, 0],
        degenerate=torch.any(vals < threshold, dim=-1),
    )


def remap_update(H: torch.Tensor, dx: torch.Tensor, threshold: float) -> torch.Tensor:
    """Project each 6-dof block of dx onto the non-degenerate eigendirections
    of its corresponding 6x6 diagonal block of H."""
    P, _ = block_projector(H, threshold)
    return apply_block_projector(P, dx)


def _spectral_keep(vals: torch.Tensor, threshold: float,
                   rel_gap: float | None) -> torch.Tensor:
    """Keep mask [..., 6] over ascending eigenvalues.

    A direction is degenerate iff (a) its eigenvalue is below the absolute
    ceiling ``threshold`` AND (b) — when ``rel_gap`` is given — it sits
    below a SPECTRAL GAP: the largest index m with e_m < rel_gap * e_{m+1}
    marks the degenerate subspace 0..m.
    """
    below = vals < threshold
    if rel_gap is None:
        return ~below
    gap = vals[..., :-1] < rel_gap * vals[..., 1:]          # [..., 5]
    # degenerate_k = any gap at j >= k  (reversed cumulative-or)
    deg = torch.flip(torch.cumsum(torch.flip(gap.to(torch.int64), (-1,)), -1), (-1,)) > 0
    deg = torch.cat([deg, torch.zeros_like(deg[..., :1])], -1)
    return ~(below & deg)


def _projector_from(vecs: torch.Tensor, keep: torch.Tensor,
                    snap_purity: float | None) -> torch.Tensor:
    """P = I − Σ_frozen u uᵀ from eigvectors [..., 6, 6] (columns) and a
    keep mask [..., 6].

    ``snap_purity``: purify each FROZEN eigenvector by snapping it to the
    canonical tangent axis it dominates when that component's magnitude
    exceeds the bound (the impurity is estimation noise in the eigvector;
    projecting with it couples the frozen error into observable axes).
    """
    if snap_purity is not None:
        mag = torch.abs(vecs)                                # [..., 6, 6]
        dommag, dom = torch.max(mag, dim=-2)                 # [..., 6]
        onehot = torch.nn.functional.one_hot(dom, 6).to(vecs.dtype)
        snapped = onehot.transpose(-1, -2)                   # columns
        use = (dommag >= snap_purity)[..., None, :]
        vecs = torch.where(use, snapped, vecs)
    frozen = 1.0 - keep.to(vecs.dtype)
    sub = torch.einsum("...ik,...k,...jk->...ij", vecs, frozen, vecs)
    return torch.eye(6, dtype=vecs.dtype, device=vecs.device) - sub


def block_spectra(H: torch.Tensor):
    """Both eigendecompositions the gate and the projector need, one
    ``eigh`` each: (per-block eigvals [n, 6] ascending, eigvectors
    [n, 6, 6]; the mean non-anchored block's eigvals [6], eigvectors
    [6, 6])."""
    blocks = diag_blocks(H)
    vals, vecs = torch.linalg.eigh(blocks)
    vals_s, vecs_s = torch.linalg.eigh(_mean_free_block(H))
    return vals, vecs, vals_s, vecs_s


def projector_from_spectra(vals, vecs, vals_s, vecs_s, threshold: float,
                           max_freeze: int | None = None, shared: bool = False,
                           rel_gap: float | None = None,
                           snap_purity: float | None = None) -> torch.Tensor:
    """``block_projector``'s P [n, 6, 6] from spectra already computed
    (``vals_s`` / ``vecs_s`` are read only when ``shared`` and n > 1)."""
    n = vals.shape[0]
    rank = torch.arange(6, device=vals.device)[None, :]  # ascending eig order
    if shared and n > 1:
        keep = _spectral_keep(vals_s[None, :], threshold, rel_gap)
        if max_freeze is not None:
            keep = keep | (rank >= max_freeze)
        return _projector_from(vecs_s, keep[0], snap_purity).expand(n, 6, 6)
    keep = _spectral_keep(vals, threshold, rel_gap)
    if max_freeze is not None:
        keep = keep | (rank >= max_freeze)
    return _projector_from(vecs, keep, snap_purity)


def block_projector(H: torch.Tensor, threshold: float,
                    max_freeze: int | None = None,
                    shared: bool = False,
                    rel_gap: float | None = None,
                    snap_purity: float | None = None,
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-6-dof-block solution-remapping projectors from H's diagonal
    blocks: P_i = I − Σ_frozen u uᵀ (= V diag(keep) Vᵀ when not snapping).
    Computed ONCE per solve.

    ``max_freeze``: freeze at most this many (ascending) directions per
    block; None = freeze all below the threshold.
    ``rel_gap``: spectral-gap gate (see _spectral_keep).
    ``snap_purity``: frozen-direction purification (see _projector_from).
    ``shared``: build ONE projector from the mean of the non-anchored
    blocks and apply it identically to every block, so frozen directions
    stay consistent across the window.

    Returns (P [n, 6, 6], eigvals [n, 6] ascending — per-block spectra
    either way, for diagnostics/threshold calibration).
    """
    blocks = diag_blocks(H)
    vals, vecs = torch.linalg.eigh(blocks)          # [n, 6], [n, 6, 6]
    vals_s = vecs_s = None
    if shared and blocks.shape[0] > 1:
        vals_s, vecs_s = torch.linalg.eigh(torch.mean(blocks[1:], dim=0))
    return projector_from_spectra(vals, vecs, vals_s, vecs_s, threshold,
                                  max_freeze, shared, rel_gap, snap_purity), vals


def shared_spectrum(H: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues [6] of the MEAN non-anchored 6x6 diagonal
    block — the spectrum the shared projector's gate actually sees."""
    return torch.linalg.eigvalsh(_mean_free_block(H))


def shared_weak_direction(H: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(eigvals [6] ascending, weakest eigvector [6], defined up to sign) of
    the mean non-anchored block — the candidate frozen direction."""
    vals, vecs = torch.linalg.eigh(_mean_free_block(H))
    return vals, vecs[:, 0]


def apply_block_projector(P: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """Apply per-block projectors [n, 6, 6] to a flat update [n*6]."""
    n = P.shape[0]
    proj = torch.einsum("nij,nj->ni", P, dx.reshape(n, 6))
    return proj.reshape(n * 6)
