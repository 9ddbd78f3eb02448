"""Good-feature selection: information-aware correspondence subsetting.

Counterpart of ``mloam_tpu/solver/feature_selection.py`` (the reference's
``Estimator::goodFeatureMatching`` and the mapper's ``ActiveFeatureSelection``
methods wo_gf / rnd / fps / gd_fix / gd_float).

The greedy method runs a fixed number of *rounds*; each round scores every
remaining candidate by its log-det gain against the running 6x6 information
matrix through the matrix determinant lemma,
    Δ_i = log det(I_r + J_i H⁻¹ J_iᵀ)
(rank 1 for plane factors, rank 3 for edges), and admits the top
(target / rounds) scorers jointly.

The ``rnd`` method draws from a ``torch.Generator``: the port cannot
reproduce the JAX package's ``jax.random`` bits, so its masks are the same
distribution, not the same draw. ``fps_select`` runs ``n_keep - 1``
dependent steps as a host loop of small device ops (no host read).
"""

from __future__ import annotations

import math

import torch

from mloam_tpu_torch.core import rotations as rot
from mloam_tpu_torch.core.rotations import _cross
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.ops import select
from mloam_tpu_torch.solver.factors import EdgeCorr, PlaneCorr


def plane_jacobian_blocks(corr: PlaneCorr, pose: Pose) -> torch.Tensor:
    """[N, 6] Jacobian of n·(T p)+d wrt the right-perturbation tangent of T:
    J = [Rᵀn | p x Rᵀn]."""
    Rn = rot.quat_rotate(rot.quat_conjugate(pose.q)[None], corr.normal)
    return torch.cat([Rn, _cross(corr.p, Rn)], dim=-1)


def edge_jacobian_blocks(corr: EdgeCorr, pose: Pose) -> torch.Tensor:
    """[N, 3, 6] Jacobian of the cross-product edge residual:
    dr/dy = -[u]ₓ, dy/dξ = R [I | [p]ₓᵀ]."""
    ab = corr.pa - corr.pb
    u = ab / torch.clamp(torch.linalg.norm(ab, dim=-1, keepdim=True), min=1e-9)
    R = rot.quat_to_matrix(pose.q)
    dy = torch.cat([R.expand(corr.p.shape[:1] + (3, 3)), -R @ rot.skew(corr.p)],
                   dim=-1)
    return -rot.skew(u) @ dy


def logdet_gain_select(Jp: torch.Tensor, wp: torch.Tensor, Je: torch.Tensor,
                       we: torch.Tensor, ratio, rounds: int = 8,
                       jitter: float = 1e-3, max_ratio: float = 1.0):
    """Joint selection over plane (rank-1) and edge (rank-3) candidates.

    Returns (keep_p [Np] bool, keep_e [Ne] bool); total kept ≈ ratio * valid.
    ``ratio`` may be a device tensor (the gd_float budget-adaptive path);
    ``max_ratio`` is a host upper bound on it that sizes the per-round top-k
    width so every round can admit its full quota.
    """
    n_p, n_e = Jp.shape[0], Je.shape[0]
    dev, dt = Jp.device, Jp.dtype
    valid_p, valid_e = wp > 0, we > 0
    n_valid = torch.sum(valid_p) + torch.sum(valid_e)
    target = torch.ceil(torch.as_tensor(ratio, dtype=dt, device=dev) * n_valid) \
        .to(torch.int64)
    per_round = torch.clamp(target // rounds, min=1)
    n_total = max(n_p + n_e, 1)
    # host width >= the worst-case per-round quota
    k = min(n_total, max(int(math.ceil(max_ratio * n_total / rounds)), 1))
    rank = torch.arange(k, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)

    H = jitter * torch.eye(6, dtype=dt, device=dev)
    keep_p = torch.zeros((n_p,), dtype=torch.bool, device=dev)
    keep_e = torch.zeros((n_e,), dtype=torch.bool, device=dev)
    remaining = target
    for _ in range(rounds):
        Hinv = torch.linalg.inv_ex(H).inverse
        q_p = torch.einsum("ni,ij,nj->n", Jp, Hinv, Jp)
        gain_p = torch.log1p(torch.clamp(q_p, min=0.0))
        gain_p = torch.where(valid_p & ~keep_p, gain_p, -torch.inf)
        M = torch.einsum("nai,ij,nbj->nab", Je, Hinv, Je)
        sign, ld = torch.linalg.slogdet(eye3[None] + M)
        gain_e = torch.where(sign > 0, ld, -torch.inf)
        gain_e = torch.where(valid_e & ~keep_e, gain_e, -torch.inf)

        vals, idx = select.top_k_lowest_index(torch.cat([gain_p, gain_e]), k)
        admit = (rank < torch.minimum(per_round, remaining)) & torch.isfinite(vals)
        sel = torch.zeros((n_p + n_e,), dtype=torch.bool, device=dev) \
            .index_put_((idx,), admit)
        sel_p, sel_e = sel[:n_p], sel[n_p:]
        H = (H + torch.einsum("n,ni,nj->ij", sel_p.to(dt), Jp, Jp)
             + torch.einsum("n,nai,naj->ij", sel_e.to(dt), Je, Je))
        keep_p, keep_e = keep_p | sel_p, keep_e | sel_e
        remaining = remaining - torch.sum(sel.to(torch.int64))
    return keep_p, keep_e


def random_select(w: torch.Tensor, ratio: float,
                  generator: torch.Generator) -> torch.Tensor:
    """Bernoulli(ratio) mask over valid entries (method 'rnd')."""
    u = torch.rand(w.shape, generator=generator, device=w.device, dtype=w.dtype)
    return (w > 0) & (u < ratio)


def fps_select(xyz: torch.Tensor, w: torch.Tensor, n_keep: int) -> torch.Tensor:
    """Farthest-point sampling over valid points (method 'fps'): ``n_keep``
    rounds of argmax-of-min-distance, O(n_keep * N)."""
    n = xyz.shape[0]
    ar = torch.arange(n, device=xyz.device)
    valid = w > 0
    start = torch.argmax(valid.to(torch.int8)).reshape(1)   # first valid point
    min_d = torch.where(valid, torch.sum((xyz - xyz.index_select(0, start)) ** 2, -1),
                        -torch.inf)
    keep = (ar == start) & valid.index_select(0, start)
    for _ in range(n_keep - 1):
        nxt = torch.argmax(min_d).reshape(1)
        best = min_d.index_select(0, nxt)
        ok = torch.isfinite(best) & (best > 0)
        keep = keep | ((ar == nxt) & ok)
        d_new = torch.sum((xyz - xyz.index_select(0, nxt)) ** 2, -1)
        min_d = torch.where(valid & ~keep, torch.minimum(min_d, d_new), -torch.inf)
    return keep


def apply_masks(plane: PlaneCorr, edge: EdgeCorr, keep_p: torch.Tensor,
                keep_e: torch.Tensor):
    """(plane, edge) with weights zeroed outside the kept subsets."""
    return (plane._replace(w=plane.w * keep_p.to(plane.w.dtype)),
            edge._replace(w=edge.w * keep_e.to(edge.w.dtype)))


def apply_selection(plane: PlaneCorr, edge: EdgeCorr, pose: Pose, method: str,
                    ratio: float, generator: torch.Generator | None = None,
                    rounds: int = 8):
    """Return (plane, edge) with weights zeroed outside the selected subset.

    method ∈ {full, rnd, fps, gd} mirroring wo_gf / rnd / fps / gd_fix;
    ``rnd`` draws the plane mask, then the edge mask, from ``generator``.
    """
    if method == "full" or ratio >= 1.0:
        return plane, edge
    if method == "rnd":
        if generator is None:
            raise ValueError("gf method 'rnd' needs a generator")
        keep_p = random_select(plane.w, ratio, generator)
        keep_e = random_select(edge.w, ratio, generator)
    elif method == "fps":
        keep_p = fps_select(plane.p, plane.w, int(plane.w.shape[0] * ratio))
        keep_e = fps_select(edge.p, edge.w, max(int(edge.w.shape[0] * ratio), 1))
    elif method == "gd":
        keep_p, keep_e = logdet_gain_select(
            plane_jacobian_blocks(plane, pose), plane.w,
            edge_jacobian_blocks(edge, pose), edge.w, ratio, rounds)
    else:
        raise ValueError(f"unknown gf method {method}")
    return apply_masks(plane, edge, keep_p, keep_e)
