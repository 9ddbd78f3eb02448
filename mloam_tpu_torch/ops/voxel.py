"""Voxel-grid ops as sort + segment reductions (exact, statically shaped).

Replacements for PCL voxel filters: plain centroid downsampling, used in
feature extraction and local-map assembly, and the uncertainty-weighted
filter of the mapper's surround map. Counterpart of
``mloam_tpu/ops/voxel.py``.

Design: no kd-trees, no dynamic shapes. Points are keyed by their integer
voxel coordinate, sorted (stable, so the order inside a voxel is the input
order), reduced with segment heads, and compacted into a fixed-capacity
output with a validity mask. Invalid points sort to the tail via a
valid-first sort key.

The segment sums are ``segsum.index_sum``: fixed-point integer adds, so a
centroid has the same bits on every run and on any device, whatever order
the device adds its members in.

``voxel_reduce`` (packed), ``segment_mean``, ``segment_sum`` and
``voxel_downsample`` (packed) also take a batch of clouds, points [L, N, 3] with masks [L, N] (the lidars
of a rig): each row is sorted on its own, which is a sort whose key leads
with the lidar index, so no voxel spans two lidars, and each row's sums take
their own fixed-point scale (the batch form of ``index_sum``). Each row's
result is the one it gets alone, to the bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mloam_tpu_torch.ops.segsum import index_sum
from mloam_tpu_torch.ops.select import take_rows

_SENTINEL = 2 ** 30


def voxel_coords(xyz: torch.Tensor, leaf: float) -> torch.Tensor:
    """Integer voxel coordinate per point, [N, 3] int64."""
    return torch.floor(xyz / leaf).to(torch.int64)


class VoxelReduction(NamedTuple):
    """Result of a voxel reduction, compacted to the input capacity.

    ``order`` and ``seg_id`` allow callers to push extra per-point payloads
    through the same reduction (segment-sum with the same ids).
    """

    num_voxels: torch.Tensor      # scalar int64
    mask: torch.Tensor            # [N] True for the first num_voxels slots
    order: torch.Tensor           # [N] permutation sorting points by key
    seg_id: torch.Tensor          # [N] voxel slot id per *sorted* point
    sorted_valid: torch.Tensor    # [N] validity per sorted point


def _rel_coords(ijk: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Coordinates re-based to the valid minimum, clamped to 10 bits/axis."""
    base = torch.min(torch.where(valid[..., None], ijk, _SENTINEL), dim=-2).values
    return torch.clamp(ijk - base[..., None, :], 0, 1023)


def _reduction_from_sorted(order, valid, differs) -> VoxelReduction:
    head = torch.cat([valid[..., :1], differs & valid[..., 1:]], -1)
    h = head.to(torch.int64)
    seg_id = torch.clamp(torch.cumsum(h, -1) - 1, min=0)
    num = torch.sum(h, -1)
    n = order.shape[-1]
    out_mask = torch.arange(n, dtype=torch.int64, device=order.device) < num[..., None]
    return VoxelReduction(num, out_mask, order, seg_id, valid)


def voxel_reduce(ijk: torch.Tensor, valid_in: torch.Tensor,
                 packed: bool = False) -> VoxelReduction:
    """Group points by integer voxel coordinate; all shapes static. ``ijk``
    [N, 3], ``valid_in`` [N]; with ``packed``, leading axes may hold
    separate clouds ([..., N, 3], [..., N]).

    ``packed=False``: exact lexicographic sort (4 stable sort passes) —
    unbounded coordinate range, used for map-scale reductions.
    ``packed=True``: coordinates are re-based to their minimum and packed
    into one key (10 bits/axis, grid up to 1024³ cells) — a single sort
    pass. Out-of-grid cells clamp to the boundary (only relevant beyond
    1024 cells span, i.e. >200 m at 0.2 m leaf).
    """
    if packed:
        rel = _rel_coords(ijk, valid_in)
        key = (rel[..., 0] << 20) | (rel[..., 1] << 10) | rel[..., 2]
        key = torch.where(valid_in, key, _SENTINEL)
        order = torch.argsort(key, dim=-1, stable=True)
        sorted_key = key.gather(-1, order)
        valid = valid_in.gather(-1, order)
        differs = sorted_key[..., 1:] != sorted_key[..., :-1]
    else:
        # lexsort, least-significant key first, each pass stable
        order = torch.arange(ijk.shape[0], dtype=torch.int64, device=ijk.device)
        for k in (ijk[:, 2], ijk[:, 1], ijk[:, 0], (~valid_in).to(torch.int64)):
            order = order[torch.argsort(k[order], stable=True)]
        sk = ijk[order]
        valid = valid_in[order]
        differs = torch.any(sk[1:] != sk[:-1], dim=-1)
    return _reduction_from_sorted(order, valid, differs)


def _tail(values: torch.Tensor):
    return (values.shape[0],) + (1,) * (values.ndim - 1)


def segment_mean(values: torch.Tensor, red: VoxelReduction,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted mean of per-point payload over voxels.

    values: [..., N, ...] in *original* order; returns [..., N, ...]
    compacted (valid in the first num_voxels rows).
    """
    lead, n = red.order.shape[:-1], red.order.shape[-1]
    v = take_rows(values, red.order).reshape(lead + (n, -1))
    w = (torch.ones(red.order.shape, dtype=values.dtype, device=values.device)
         if weights is None else take_rows(weights, red.order))
    w = torch.where(red.sorted_valid, w, 0.0)
    wv = torch.where(red.sorted_valid[..., None], v * w[..., None], 0.0)
    # the weighted payload and the weights in one order-independent sum
    sums = index_sum(torch.cat([wv, w[..., None]], -1), red.seg_id, n)
    mean = sums[..., :-1] / torch.clamp(sums[..., -1:], min=1e-12)
    return mean.reshape(values.shape)


def segment_sum(values: torch.Tensor, red: VoxelReduction) -> torch.Tensor:
    v = take_rows(values, red.order)
    valid = red.sorted_valid.reshape(
        red.sorted_valid.shape + (1,) * (values.ndim - red.order.ndim))
    return index_sum(torch.where(valid, v, 0.0), red.seg_id, red.order.shape[-1])


def voxel_downsample(xyz: torch.Tensor, mask: torch.Tensor, leaf: float,
                     payload: torch.Tensor | None = None,
                     packed: bool = False):
    """Centroid voxel filter. Returns (xyz_ds [..., N, 3], mask_ds [..., N],
    payload_ds)."""
    red = voxel_reduce(voxel_coords(xyz, leaf), mask, packed=packed)
    out_xyz = segment_mean(xyz, red)
    out_payload = None if payload is None else segment_mean(payload, red)
    return out_xyz, red.mask, out_payload


def voxel_downsample_two_class(
    xyz_a: torch.Tensor, mask_a: torch.Tensor, leaf_a: float,
    xyz_b: torch.Tensor, mask_b: torch.Tensor, leaf_b: float,
):
    """Fused centroid filter over two point classes with ONE sort pass.

    The window local map needs corner and surf clouds filtered at different
    leaves; sorting them together (class in the key's high bit, 10 bits/axis
    re-based per class) halves the number of sorts per sweep. Class-a voxels
    sort first, so class-b output is a slice starting at a's voxel count —
    taken as a gather, so the count never leaves the device.

    Returns (xyz_a_ds, mask_a_ds, xyz_b_ds, mask_b_ds), each input-capacity.
    """
    na, nb = xyz_a.shape[0], xyz_b.shape[0]
    dev = xyz_a.device
    ra = _rel_coords(voxel_coords(xyz_a, leaf_a), mask_a)
    rb = _rel_coords(voxel_coords(xyz_b, leaf_b), mask_b)
    rel = torch.cat([ra, rb])
    cls = torch.cat([
        torch.zeros((na,), dtype=torch.int64, device=dev),
        torch.ones((nb,), dtype=torch.int64, device=dev),
    ])
    valid_in = torch.cat([mask_a, mask_b])
    key = (cls << 30) | (rel[:, 0] << 20) | (rel[:, 1] << 10) | rel[:, 2]
    key = torch.where(valid_in, key, 0x7FFFFFFF)
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    valid = valid_in[order]
    differs = sorted_key[1:] != sorted_key[:-1]
    red = _reduction_from_sorted(order, valid, differs)
    out = segment_mean(torch.cat([xyz_a, xyz_b]), red)
    head = torch.cat([valid[:1], differs & valid[1:]])
    n_a = torch.sum((head & (sorted_key < (1 << 30))).to(torch.int64))
    n_b = red.num_voxels - n_a
    xyz_a_ds = out[:na]
    mask_a_ds = torch.arange(na, dtype=torch.int64, device=dev) < n_a
    ar_b = torch.arange(nb, dtype=torch.int64, device=dev)
    xyz_b_ds = out[n_a + ar_b]  # n_a <= na, so always in range
    mask_b_ds = ar_b < n_b
    return xyz_a_ds, mask_a_ds, xyz_b_ds, mask_b_ds


def voxel_downsample_with_cov(
    xyz: torch.Tensor,
    cov: torch.Tensor,
    mask: torch.Tensor,
    leaf: float,
    trace_threshold: float,
    payload: torch.Tensor | None = None,
    packed: bool = False,
):
    """Uncertainty-weighted voxel filter (VoxelGridCovarianceMLOAM semantics).

    Points with tr(Σ) >= trace_threshold are dropped; within a voxel,
    w_i = trace_threshold - tr(Σ_i), μ = Σ w_i x_i / Σ w_i,
    Σ_out = Σ w_i² Σ_i / (Σ w_i)², payload taken from the heaviest point
    (the largest payload among equally heavy ones). cov: [N, 3, 3].
    Returns (xyz, cov, mask, payload), compacted to the input capacity.
    """
    tr = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1)
    ok = mask & (tr < trace_threshold)
    w = torch.clamp(trace_threshold - tr, min=0.0)
    red = voxel_reduce(voxel_coords(xyz, leaf), ok, packed=packed)
    n = xyz.shape[0]

    ws = torch.where(red.sorted_valid, w[red.order], 0.0)
    ok_s = red.sorted_valid[:, None]
    # Σw, Σw·x and Σw²·Σ in one order-independent sum
    sums = index_sum(torch.cat([
        ws[:, None],
        torch.where(ok_s, ws[:, None] * xyz[red.order], 0.0),
        torch.where(ok_s, (ws * ws)[:, None] * cov[red.order].reshape(n, 9), 0.0),
    ], 1), red.seg_id, n)
    wsum_safe = torch.clamp(sums[:, 0], min=1e-12)
    out_xyz = sums[:, 1:4] / wsum_safe[:, None]
    out_cov = sums[:, 4:].reshape(n, 3, 3) / (wsum_safe * wsum_safe)[:, None, None]
    out_payload = None
    if payload is not None:
        # the heaviest member's payload: a segment max of the weights, then a
        # segment max of the payloads of the members that reach it
        wk = torch.where(red.sorted_valid, ws, -1.0)
        best = torch.full((n,), -torch.inf, dtype=xyz.dtype, device=xyz.device) \
            .index_reduce_(0, red.seg_id, wk, "amax")
        is_best = (wk == best[red.seg_id]) & red.sorted_valid
        contrib = torch.where(is_best.reshape(_tail(payload)), payload[red.order],
                              -torch.inf)
        out_payload = torch.full_like(payload, -torch.inf).index_reduce_(
            0, red.seg_id, contrib, "amax")
        out_payload = torch.where(red.mask.reshape(_tail(payload)), out_payload, 0.0)
    return out_xyz, out_cov, red.mask, out_payload
