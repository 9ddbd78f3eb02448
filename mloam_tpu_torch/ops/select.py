"""Masked selection primitives: top-k under masks, sort-free compaction.

These back the feature-extraction picking rules (per-ring sectors, bounded
picks by curvature) and the fixed-capacity compaction of sparse stacks.
Counterpart of ``mloam_tpu/ops/select.py``.
"""

from __future__ import annotations

import math

import torch

NEG_BIG = -1e30
BIG = 1e30


def top_k_lowest_index(scores: torch.Tensor, k: int):
    """Largest-k along the last axis with ties broken by LOWEST index (the
    order ``lax.top_k`` promises and ``torch.topk`` does not): a stable
    descending sort, cut at k. The rows this is used on are short (one
    sector of one ring)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def masked_top_k(scores: torch.Tensor, mask: torch.Tensor, k: int):
    """Largest-k scores among masked entries.

    Returns (values [.., k], idx [.., k], valid [.., k]). Invalid slots carry
    NEG_BIG values.
    """
    s = torch.where(mask, scores, NEG_BIG)
    vals, idx = top_k_lowest_index(s, k)
    return vals, idx, vals > NEG_BIG / 2


def masked_bottom_k(scores: torch.Tensor, mask: torch.Tensor, k: int):
    vals, idx, valid = masked_top_k(-scores, mask, k)
    return -vals, idx, valid


def _even_stride(ar: torch.Tensor, num: torch.Tensor, cap: int) -> torch.Tensor:
    """floor(ar * num / cap) in exact integer arithmetic (int64: the product
    stays far below 2^63 for any capacity in use)."""
    return (ar * num) // cap


def _compaction_plan(mask: torch.Tensor, cap: int):
    """(dest [..., N] scatter slot per row with N as the sink, sel [..., cap]
    rows of the compacted order to keep, out_mask [..., cap]) along the last
    axis."""
    n = mask.shape[-1]
    m = mask.to(torch.int64)
    rank = torch.cumsum(m, -1) - 1
    dest = torch.where(mask, rank, n)  # slot n is a sink, sliced off below
    num = torch.sum(m, -1, keepdim=True)
    ar = torch.arange(cap, dtype=torch.int64, device=mask.device)
    sel = torch.where(num <= cap, ar, _even_stride(ar, num, cap))
    out_mask = ar < torch.clamp(num, max=cap)
    if mask.ndim == 1:
        sel, out_mask = sel.reshape(cap), out_mask.reshape(cap)
    return dest, sel, out_mask


def take_rows(values: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Rows ``rows`` [..., K] of ``values`` [..., N, *tail], each leading
    index from its own rows (``values[rows]`` for one cloud). A ``gather``,
    one device op as the indexing is: ``take_along_dim`` adds a
    ``remainder`` pass over the indices."""
    tail = values.shape[rows.ndim:]
    idx = rows.reshape(rows.shape + (1,) * len(tail)).expand(rows.shape + tail)
    return values.gather(rows.ndim - 1, idx)


def compact_stride(values: torch.Tensor, mask: torch.Tensor, cap: int,
                   fill=0.0):
    """[N, ...] -> ([cap, ...], mask [cap]) without any sort; with leading
    axes, values [*B, N, ...] and mask [*B, N] give [*B, cap, ...], each
    leading index (a lidar) compacted on its own.

    Valid rows are scattered to the front by their cumsum rank (stable), and
    when more than ``cap`` are valid an even stride over the compacted rows
    is taken. Invalid rows go to a sink slot one past the end (an ``n+1``
    buffer whose last slot is never read): a CUDA scatter must stay in range.
    """
    lead = mask.shape[:-1]
    n = mask.shape[-1]
    tail = values.shape[mask.ndim:]
    rows = math.prod(lead)
    dest, sel, out_mask = _compaction_plan(mask, cap)
    sel = torch.clamp(sel, max=n - 1)
    if rows > 1:
        # each leading index's rows in one flat buffer of (n + 1)-row blocks
        base = (torch.arange(rows, dtype=torch.int64, device=mask.device)
                * (n + 1)).reshape(lead + (1,))
        dest, sel = dest + base, sel + base
    buf = torch.full((rows * (n + 1),) + tail, fill, dtype=values.dtype,
                     device=values.device)
    buf[dest.reshape(-1)] = values.reshape((-1,) + tail)
    shape = lead + (cap,) + (1,) * len(tail)
    return torch.where(out_mask.reshape(shape), buf[sel], fill), out_mask


def compact_gather_indices(mask: torch.Tensor, cap: int):
    """Gather plan for compaction along the last axis of ``mask`` [..., N]:
    (src_idx [..., cap] int64, out_mask [..., cap]).

    Gathering any [..., N, ...] tensor with ``src_idx`` (and masking rows by
    ``out_mask``) yields the first-``cap`` valid rows front-compacted by
    rank; when more than ``cap`` rows are valid, an even stride over the
    compacted order is taken (same semantics as :func:`compact_stride`).
    Leading axes are independent groups (the JAX package vmaps the 1-D
    form over them).
    """
    n = mask.shape[-1]
    dest, sel, out_mask = _compaction_plan(mask, cap)
    src = torch.zeros(mask.shape[:-1] + (n + 1,), dtype=torch.int64,
                      device=mask.device)
    ar = torch.arange(n, dtype=torch.int64, device=mask.device)
    src.scatter_(-1, dest, ar.expand(mask.shape))
    return torch.gather(src[..., :n], -1, torch.clamp(sel, 0, n - 1)), out_mask


def compact_by_mask(values: torch.Tensor, mask: torch.Tensor, fill=0.0):
    """Stable-compact masked rows to the front; returns (values, new_mask)."""
    n = mask.shape[0]
    ar = torch.arange(n, dtype=torch.int64, device=mask.device)
    order = torch.argsort(torch.where(mask, ar, n + ar), stable=True)
    out = values[order]
    new_mask = mask[order]
    shape = (n,) + (1,) * (values.ndim - 1)
    return torch.where(new_mask.reshape(shape), out, fill), new_mask
