"""Curvature-based LOAM feature extraction, fully batched.

11-point curvature, per-ring sector partition with bounded picks (≤2 sharp /
≤20 less-sharp edges with curvature>0.1, ≤4 flat planar <0.1, remainder
less-flat voxel-downsampled), neighbor suppression. Counterpart of
``mloam_tpu/frontend/features.py``.

Curvature is a sliding-window sum along the (circular) column axis of the
range image; the greedy pick-and-suppress loops become non-max/min
suppression masks followed by per-(ring, sector) masked top-k — fixed shapes,
no data-dependent control flow. Per-point relative sweep time is the column
coordinate of the range image, carried as a feature channel for de-skew.

Every function also takes the images of L lidars as one batch: images
``[L, R, C]`` (points ``[L, R, C, 3]``) and clouds ``[L, N]`` (points
``[L, N, 3]``), for the batched frontend of a uniform rig. Column windows
wrap at the seam of each image, never across images; a voxel never spans two
lidars, and each lidar's voxel sums keep their own fixed-point scale. Each
lidar's result is the one it gets alone, to the bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mloam_tpu_torch.config import FeatureConfig
from mloam_tpu_torch.core.rangeimage import RangeImage
from mloam_tpu_torch.ops import select, voxel


class FeatCloud(NamedTuple):
    """Padded feature cloud: sensor-frame points + sweep time + ring id."""

    xyz: torch.Tensor   # [N, 3]
    mask: torch.Tensor  # [N]
    time: torch.Tensor  # [N] relative sweep time in [0, 1)
    ring: torch.Tensor  # [N] int32

    @staticmethod
    def zeros(n: int, dtype=torch.float32, device=None) -> "FeatCloud":
        return FeatCloud(
            torch.zeros((n, 3), dtype=dtype, device=device),
            torch.zeros((n,), dtype=torch.bool, device=device),
            torch.zeros((n,), dtype=dtype, device=device),
            torch.zeros((n,), dtype=torch.int32, device=device),
        )

    def concat(self, other: "FeatCloud") -> "FeatCloud":
        return FeatCloud(*(torch.cat([a, b]) for a, b in zip(self, other)))


class FeatureFrame(NamedTuple):
    """The named feature bundle of one sweep."""

    sharp: FeatCloud
    less_sharp: FeatCloud
    flat: FeatCloud
    less_flat: FeatCloud


def _circ_pad_cols(x: torch.Tensor, lo: int, hi: int, dim: int = -1) -> torch.Tensor:
    """Circular padding along the column axis ``dim`` (-1 for an image
    [..., R, C], -2 for its points [..., R, C, 3]): ``lo`` columns from the
    right edge prepended, ``hi`` from the left appended — the sweep is a full
    360° loop, so windows must wrap at the seam."""
    c = x.shape[dim]
    parts = []
    if lo > 0:
        parts.append(x.narrow(dim, c - lo, lo))
    parts.append(x)
    if hi > 0:
        parts.append(x.narrow(dim, 0, hi))
    return torch.cat(parts, dim=dim) if len(parts) > 1 else x


def _window_reduce_cols(x: torch.Tensor, lo: int, hi: int, kind: str, dim: int = -1):
    """Reduction of x over the circular column window [j-lo, j+hi] for every
    column j of the column axis ``dim``: an ``unfold`` view of the circularly
    padded image, reduced over the window axis (exact f32 arithmetic — no
    convolution, so no TF32)."""
    is_bool = x.dtype == torch.bool
    if is_bool:
        x = x.to(torch.uint8)
    win = _circ_pad_cols(x, lo, hi, dim).unfold(dim, lo + hi + 1, 1)  # [..., C, ..., w]
    if kind == "add":
        out = win.sum(-1)
    elif kind == "max":
        out = win.amax(-1)
    elif kind == "min":
        out = win.amin(-1)
    else:
        raise ValueError(kind)
    return out.to(torch.bool) if is_bool else out


def curvature(img: RangeImage, valid: torch.Tensor, half: int = 5):
    """LOAM curvature per cell: || Σ_{d=-half..half} (p_{j+d} - p_j) ||² over
    the ring (column) direction. Cells whose full window isn't valid are
    flagged unusable. Returns (curv [R,C], usable [R,C]).

    Σ_{d≠0} p_{j+d} − 2·half·p_j = (window sum) − (2·half+1)·p_j."""
    xyz = img.xyz
    s = _window_reduce_cols(xyz, half, half, "add", dim=-2)
    acc = s - (2.0 * half + 1.0) * xyz
    win_ok = _window_reduce_cols(valid, half, half, "min")
    curv = torch.sum(acc * acc, dim=-1)
    return curv, win_ok


def reliability_mask(img: RangeImage, valid: torch.Tensor, half: int = 5,
                     occl_jump: float = 0.3, parallel_frac: float = 0.02):
    """Mask out LOAM's two unreliable classes: (a) points on the *far* side
    of an occlusion boundary (range jump > occl_jump between adjacent
    columns, far side masked ``half`` columns deep), (b) near-parallel beams
    (both column-neighbor range diffs > parallel_frac * range)."""
    d = img.rng
    nxt_v = torch.roll(valid, -1, dims=-1)
    prv_v = torch.roll(valid, 1, dims=-1)
    d_nxt = torch.roll(d, -1, dims=-1)
    d_prv = torch.roll(d, 1, dims=-1)
    jump_right = valid & nxt_v & (d - d_nxt > occl_jump)  # j far, j+1 near
    jump_left = valid & prv_v & (d - d_prv > occl_jump)   # j far, j-1 near
    occl = (_window_reduce_cols(jump_right, 0, half, "max")
            | _window_reduce_cols(jump_left, half, 0, "max"))
    parallel = valid & (torch.abs(d_nxt - d) > parallel_frac * d) & (
        torch.abs(d_prv - d) > parallel_frac * d
    )
    return valid & ~occl & ~parallel


def _local_extreme(curv: torch.Tensor, usable: torch.Tensor, radius: int,
                   mode: str) -> torch.Tensor:
    """True where curv is the max (or min) of its ±radius column window among
    usable cells — the batched stand-in for greedy pick-then-suppress."""
    sign = 1.0 if mode == "max" else -1.0
    v = torch.where(usable, sign * curv, -torch.inf)
    best = _window_reduce_cols(v, radius, radius, "max")
    return usable & (v >= best) & torch.isfinite(v)


def _pick_per_sector_multi(
    img: RangeImage,
    score: torch.Tensor,
    classes: list[tuple[torch.Tensor, int, bool]],
    n_sectors: int,
) -> list[FeatCloud]:
    """Masked top-k (or bottom-k) per (ring, sector) for several feature
    classes in one selection: the class score planes stack on a leading axis
    and share a single k = max(k_i). ``classes`` is a list of
    (eligible_mask, k, largest); returns one fixed-size FeatCloud of capacity
    R * n_sectors * k_i per class (per image of a batch [L, R, C]). Ties go
    to the lowest column."""
    *lead, r, c = score.shape
    s = n_sectors
    w = c // s
    assert w * s == c, "n_cols must divide by n_sectors"
    k_max = max(k for _, k, _ in classes)
    planes = [
        torch.where(eligible, score if largest else -score, -torch.inf)
        for eligible, _, largest in classes
    ]
    sc = torch.stack(planes).reshape(len(classes), *lead, r, s, w)
    vals, idx = select.top_k_lowest_index(sc, k_max)       # [B, (L,) R, S, k_max]
    ok = torch.isfinite(vals)
    dev = score.device
    cols = idx + (torch.arange(s, device=dev) * w)[:, None]
    rows = torch.arange(r, device=dev)[:, None, None].expand(cols.shape)
    # a batch's picks gather from their own image
    image = (torch.arange(lead[0], device=dev)[:, None, None, None],) if lead else ()
    outs = []
    for b, (_, k, _) in enumerate(classes):
        cb, rb, okb = cols[b, ..., :k], rows[b, ..., :k], ok[b, ..., :k]
        xyz = img.xyz[image + (rb, cb)]
        time = img.time[image + (rb, cb)]
        n = r * s * k
        outs.append(FeatCloud(
            xyz=torch.where(okb[..., None], xyz, 0.0).reshape(*lead, n, 3),
            mask=okb.reshape(*lead, n),
            time=time.reshape(*lead, n),
            ring=rb.reshape(*lead, n).to(torch.int32),
        ))
    return outs


def _pick_per_sector(
    img: RangeImage,
    score: torch.Tensor,
    eligible: torch.Tensor,
    n_sectors: int,
    k: int,
    largest: bool,
) -> FeatCloud:
    """Single-class form of ``_pick_per_sector_multi``."""
    return _pick_per_sector_multi(
        img, score, [(eligible, k, largest)], n_sectors
    )[0]


def _stride_to_cap(xyz, mask, payload, cap: int) -> FeatCloud:
    """Compacted voxel arrays [..., N] -> a FeatCloud of fixed capacity:
    identity when it fits, else an even stride over the compacted voxels
    (avoids the spatial bias of a plain truncation, since voxels are ordered
    by coordinate). ``payload`` columns are (time, ring). Each leading index
    (a lidar) strides over its own voxel count."""
    n = xyz.shape[-2]
    num = torch.sum(mask.to(torch.int64), -1, keepdim=True)
    ar = torch.arange(cap, dtype=torch.int64, device=xyz.device)
    # the f32 product of the JAX package, kept so both sides stride alike
    strided = torch.floor(ar.to(torch.float32) * num / cap).to(torch.int64)
    sel = torch.clamp(torch.where(num <= cap, ar, strided), max=n - 1)
    m = ar < torch.clamp(num, max=cap)
    pl = select.take_rows(payload, sel)
    return FeatCloud(
        xyz=torch.where(m[..., None], select.take_rows(xyz, sel), 0.0),
        mask=m,
        time=torch.where(m, pl[..., 0], 0.0),
        ring=torch.round(pl[..., 1]).to(torch.int32),
    )


def _voxel_to_cap(xyz, mask, time, ring, leaf: float, cap: int,
                  precap: int | None) -> FeatCloud:
    """Sort-free compaction to ``precap`` rows, voxel filter, stride to
    ``cap``; along the last point axis, each leading index on its own."""
    payload = torch.stack([time, ring.to(time.dtype)], -1)
    if precap is not None and precap < xyz.shape[-2]:
        packed_pts = torch.cat([xyz, payload], -1)
        packed_pts, mask = select.compact_stride(packed_pts, mask, precap)
        xyz, payload = packed_pts[..., :3], packed_pts[..., 3:]
    ds_xyz, ds_mask, ds_payload = voxel.voxel_downsample(
        xyz, mask, leaf, payload, packed=True)
    return _stride_to_cap(ds_xyz, ds_mask, ds_payload, cap)


def downsample_featcloud(f: FeatCloud, leaf: float, cap: int,
                         precap: int | None = None) -> FeatCloud:
    """Voxel-downsample a feature cloud [N] (or the clouds of L lidars,
    [L, N]) to a fixed capacity (used when pushing sweeps into window/map
    stacks).

    ``precap``: sort-free compaction bound applied BEFORE the voxel sort.
    Identical output whenever the valid count fits precap (the normal case);
    an even-stride subsample feeds the filter otherwise.
    """
    return _voxel_to_cap(f.xyz, f.mask, f.time, f.ring, leaf, cap, precap)


def extract(img: RangeImage, segmented: torch.Tensor,
            cfg: FeatureConfig) -> FeatureFrame:
    """Extract the four feature sets from one segmented sweep [R, C] (or
    from L lidars' sweeps [L, R, C]: clouds [L, N])."""
    valid = img.valid & segmented
    curv, usable = curvature(img, valid, cfg.curvature_half_window)
    usable = usable & reliability_mask(img, valid, cfg.curvature_half_window)

    edge_cand = usable & (curv > cfg.edge_threshold)
    surf_cand = usable & (curv < cfg.edge_threshold)

    sharp_elig = edge_cand & _local_extreme(curv, edge_cand, cfg.curvature_half_window, "max")
    less_sharp_elig = edge_cand & _local_extreme(curv, edge_cand, 2, "max")
    flat_elig = surf_cand & _local_extreme(curv, surf_cand, cfg.curvature_half_window, "min")

    sharp, less_sharp, flat = _pick_per_sector_multi(
        img, curv,
        [(sharp_elig, cfg.max_sharp, True),
         (less_sharp_elig, cfg.max_less_sharp, True),
         (flat_elig, cfg.max_flat, False)],
        cfg.n_sectors,
    )

    # less-flat: every surf candidate, voxel-downsampled to a fixed capacity,
    # after a sort-free compaction to 2*cap rows (exact in the typical case,
    # near-uniform otherwise)
    *lead, r, c = curv.shape
    ring = torch.arange(r, device=curv.device)[:, None].expand(curv.shape).reshape(*lead, -1)
    lf = _voxel_to_cap(
        img.xyz.reshape(*lead, -1, 3), surf_cand.reshape(*lead, -1),
        img.time.reshape(*lead, -1), ring, cfg.less_flat_leaf, cfg.cap_less_flat,
        2 * cfg.cap_less_flat)
    return FeatureFrame(sharp=sharp, less_sharp=less_sharp, flat=flat, less_flat=lf)
