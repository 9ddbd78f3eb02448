"""Scan Context place recognition, batched.

Counterpart of ``mloam_tpu/loop/scancontext.py`` (the reference's
``SCManager``): a polar-grid max-height descriptor, ring-key preselection of
candidates, and the column-shift cosine distance with yaw recovery.

The descriptor is one ``scatter_reduce`` (amax); the candidate search is one
ring-key distance over the whole database, cut by a top-k whose ties go to
the lowest index (``ops/select.top_k_lowest_index``, the order ``lax.top_k``
keeps); the column-shift distance evaluates all S rotations of all
candidates in one ``einsum``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mloam_tpu_torch.config import LoopConfig
from mloam_tpu_torch.mapping.keyframes import write_slot
from mloam_tpu_torch.ops import select


class ScanContextDB(NamedTuple):
    desc: torch.Tensor      # [K, R, S] descriptors
    ring_key: torch.Tensor  # [K, R]
    valid: torch.Tensor     # [K]
    head: torch.Tensor      # scalar int32


def empty_db(capacity: int, cfg: LoopConfig, device=None) -> ScanContextDB:
    return ScanContextDB(
        desc=torch.zeros((capacity, cfg.sc_num_rings, cfg.sc_num_sectors), device=device),
        ring_key=torch.zeros((capacity, cfg.sc_num_rings), device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        head=torch.zeros((), dtype=torch.int32, device=device),
    )


def make_descriptor(xyz: torch.Tensor, mask: torch.Tensor,
                    cfg: LoopConfig) -> torch.Tensor:
    """[N, 3] sensor/base-frame points -> [R, S] max-height polar grid.

    Height is z + 2.0 (the lidar mount offset, so heights stay positive);
    empty cells hold 0."""
    r_bins, s_bins = cfg.sc_num_rings, cfg.sc_num_sectors
    rho = torch.linalg.norm(xyz[:, :2], dim=-1)
    theta = torch.atan2(xyz[:, 1], xyz[:, 0])  # [-pi, pi)
    ring = torch.floor(rho / cfg.sc_max_radius * r_bins).to(torch.int64)
    sector = torch.floor((theta + math.pi) / (2 * math.pi) * s_bins).to(torch.int64)
    ok = mask & (rho < cfg.sc_max_radius)
    flat = torch.clamp(ring, 0, r_bins - 1) * s_bins + torch.clamp(sector, 0, s_bins - 1)
    z = torch.where(ok, xyz[:, 2] + 2.0, -torch.inf)
    grid = torch.full((r_bins * s_bins,), -torch.inf, dtype=xyz.dtype,
                      device=xyz.device).scatter_reduce(0, flat, z, "amax")
    grid = torch.where(torch.isfinite(grid), grid, 0.0)
    return grid.reshape(r_bins, s_bins)


def ring_key(desc: torch.Tensor) -> torch.Tensor:
    """Rotation-invariant ring key: per-ring occupancy mean ([..., R])."""
    return torch.mean((desc != 0.0).to(desc.dtype), dim=-1)


def add(db: ScanContextDB, desc: torch.Tensor,
        where: torch.Tensor | None = None) -> ScanContextDB:
    """Ring-insert one descriptor at ``head % K``; with ``where`` (a device
    bool) only where it holds. The slot is written in place (the
    keyframe ring's rule, ``mapping/keyframes.insert``)."""
    k = db.valid.shape[0]
    i = torch.remainder(db.head, k).to(torch.int64).reshape(1)
    write_slot(db.desc, i, desc, where)
    write_slot(db.ring_key, i, ring_key(desc), where)
    write_slot(db.valid, i, torch.ones((), dtype=torch.bool, device=i.device), where)
    step = 1 if where is None else where.to(torch.int32)
    return db._replace(head=db.head + step)


def _shifted_cosine_dist(q: torch.Tensor, cands: torch.Tensor):
    """Min-over-column-shift scan-context distance.

    q [R, S]; cands [N, R, S]. Returns (dist [N], shift [N]): distance =
    1 - mean_j cos(q_col_{j+shift}, cand_col_j) over column pairs that are
    both non-empty; the first of equal shifts wins."""
    s = q.shape[1]
    j = torch.arange(s, device=q.device)
    # all S rotations of the query columns: rolled[k, :, j] = q[:, (j+k) % S]
    rolled = q[:, (j[None, :] + j[:, None]) % s].permute(1, 0, 2)  # [S, R, S]
    qn = torch.linalg.norm(rolled, dim=1)                          # [S, S]
    cn = torch.linalg.norm(cands, dim=1)                           # [N, S]
    dots = torch.einsum("krs,nrs->nks", rolled, cands)             # [N, S, S]
    denom = qn[None, :, :] * cn[:, None, :]
    cos = torch.where(denom > 1e-9, dots / torch.clamp(denom, min=1e-9), 0.0)
    both = (qn[None, :, :] > 1e-9) & (cn[:, None, :] > 1e-9)
    n_valid = torch.clamp(torch.sum(both, dim=-1), min=1)
    sim = torch.sum(torch.where(both, cos, 0.0), dim=-1) / n_valid  # [N, S]
    dist = 1.0 - sim
    best = torch.argmin(dist, dim=-1)
    return torch.gather(dist, 1, best[:, None])[:, 0], best


class LoopCandidate(NamedTuple):
    index: torch.Tensor   # scalar int64 db index (into the ring)
    dist: torch.Tensor    # scan-context distance
    yaw: torch.Tensor     # recovered yaw offset (radians)
    found: torch.Tensor   # bool


def detect(db: ScanContextDB, desc: torch.Tensor, cfg: LoopConfig,
           exclude_after: torch.Tensor | None = None) -> LoopCandidate:
    """Query the database with one descriptor.

    ``exclude_after``: entries with insertion id >= this are skipped (the
    reference's NUM_EXCLUDE_RECENT; recency is the caller's insertion
    order). Returns the best candidate, ``found`` when its distance is under
    ``sc_dist_threshold``. Candidates that are not valid keep an infinite
    distance through the column-shift stage."""
    k = db.valid.shape[0]
    ids = torch.arange(k, device=desc.device)
    # insertion id of slot i under a ring cursor: head - 1 - ((head - 1 - i) % k)
    last = db.head.to(torch.int64) - 1
    ins_id = last - torch.remainder(last - ids, k)
    ok = db.valid
    if exclude_after is not None:
        ok = ok & (ins_id < exclude_after)

    qk = ring_key(desc)
    d_rk = torch.sum((db.ring_key - qk[None, :]) ** 2, dim=-1)
    d_rk = torch.where(ok, d_rk, torch.inf)
    neg, cand_idx = select.top_k_lowest_index(-d_rk, min(cfg.num_candidates, k))
    cand_ok = torch.isfinite(neg)

    dist, shift = _shifted_cosine_dist(desc, db.desc[cand_idx])
    dist = torch.where(cand_ok, dist, torch.inf)
    best = torch.argmin(dist).reshape(1)
    best_dist = dist.index_select(0, best)[0]
    yaw = shift.index_select(0, best)[0].to(torch.float32) / cfg.sc_num_sectors * 2 * math.pi
    yaw = torch.where(yaw > math.pi, yaw - 2 * math.pi, yaw)  # shifts past pi turn negative
    return LoopCandidate(
        index=cand_idx.index_select(0, best)[0],
        dist=best_dist,
        yaw=yaw,
        found=best_dist < cfg.sc_dist_threshold,
    )
