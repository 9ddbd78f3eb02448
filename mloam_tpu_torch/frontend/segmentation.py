"""Range-image segmentation: ground labeling + cluster filtering.

LeGO-LOAM-style segmenter: ground by consecutive-ring slope, clusters by the
adjacent-beam angle test ``atan2(d2 sin a, d1 - d2 cos a) > theta``, small
clusters dropped unless they span enough rings. Counterpart of
``mloam_tpu/frontend/segmentation.py``.

The BFS of the original becomes connected-component labeling by alternating
segmented min-scans along rows and columns — each round propagates labels
through entire connected runs, so a handful of rounds converges for real
cluster shapes (no data-dependent loop). The propagation itself is
``ops/hopper_labels.propagate_labels``: the hand-written CUDA kernel on a CUDA
tensor, its plain version on the CPU. Both follow the kernel's round structure
(row, seam stitch, row, column), which agrees with the JAX package's CPU
branch (row, half-rolled row, column) at convergence. Cluster statistics
(size, ring span) are scatter reductions keyed by the component label, which
is a linear pixel index.

Every function also takes the images of L lidars that share one sensor model
as one batch, ``[L, R, C]`` (``[L, R, C, 3]`` for points): one label launch
for the rig, labels in each image's own index space, cluster statistics keyed
per image. Each image's result is the one it gets alone, to the bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mloam_tpu_torch.config import SegmenterConfig
from mloam_tpu_torch.core.rangeimage import LidarModel, RangeImage
from mloam_tpu_torch.ops import hopper_labels


class Segmentation(NamedTuple):
    ground: torch.Tensor    # [R, C] bool — ground points
    segmented: torch.Tensor  # [R, C] bool — kept (ground or valid cluster)
    outlier: torch.Tensor   # [R, C] bool — dropped cluster points
    label: torch.Tensor     # [R, C] int32 component label (linear index space)


def _beam_angle_connected(rng_a, rng_b, alpha: float, theta_rad: float):
    """LeGO adjacency test between two beams separated by angle alpha."""
    d1 = torch.maximum(rng_a, rng_b)
    d2 = torch.minimum(rng_a, rng_b)
    beta = torch.atan2(d2 * math.sin(alpha), d1 - d2 * math.cos(alpha))
    return beta > theta_rad


def connectivity(img: RangeImage, model: LidarModel, cfg: SegmenterConfig):
    """(ground, clusterable, conn_h, conn_v), all bool [..., R, C].
    ``conn_h[..., 0]`` holds the azimuth wrap flag (col C-1 <-> col 0), the
    layout ``propagate_labels`` takes."""
    r = img.valid.shape[-2]
    dev = img.valid.device
    rng = torch.where(img.valid, img.rng, 0.0)

    # --- ground: slope between vertically adjacent returns in bottom rows
    d = img.xyz[..., 1:, :, :] - img.xyz[..., :-1, :, :]
    slope = torch.abs(torch.atan2(
        d[..., 2], torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])))
    pair_ok = img.valid[..., 1:, :] & img.valid[..., :-1, :] & (
        slope < math.radians(cfg.ground_angle_deg))
    ground = torch.zeros_like(img.valid)
    ground[..., :-1, :] = pair_ok
    ground[..., 1:, :] |= pair_ok
    row_idx = torch.arange(r, device=dev)[:, None]
    ground = ground & (row_idx < cfg.ground_rows) & img.valid

    # --- adjacency of non-ground valid points
    clusterable = img.valid & ~ground
    theta = math.radians(cfg.segment_theta_deg)
    alpha_h = 2 * math.pi / model.n_cols
    alpha_v = math.radians(
        (model.fov_up_deg - model.fov_down_deg) / max(model.n_rings - 1, 1))

    conn_h = torch.zeros_like(img.valid)
    conn_h[..., 1:] = (
        clusterable[..., 1:] & clusterable[..., :-1]
        & _beam_angle_connected(rng[..., 1:], rng[..., :-1], alpha_h, theta))
    # wrap-around adjacency col C-1 <-> col 0
    conn_h[..., 0] = (
        clusterable[..., 0] & clusterable[..., -1]
        & _beam_angle_connected(rng[..., 0], rng[..., -1], alpha_h, theta))
    conn_v = torch.zeros_like(img.valid)
    conn_v[..., 1:, :] = (
        clusterable[..., 1:, :] & clusterable[..., :-1, :]
        & _beam_angle_connected(rng[..., 1:, :], rng[..., :-1, :], alpha_v, theta))
    return ground, clusterable, conn_h, conn_v


def segment(img: RangeImage, model: LidarModel, cfg: SegmenterConfig) -> Segmentation:
    """Segment one image [R, C] or a batch [L, R, C] in one label launch."""
    shape = img.valid.shape
    r, c = shape[-2:]
    dev = img.valid.device
    ground, clusterable, conn_h, conn_v = connectivity(img, model, cfg)

    labels = torch.arange(r * c, dtype=torch.int32, device=dev).reshape(r, c)
    labels = torch.where(clusterable, labels, r * c)
    n_rounds = max(cfg.label_iters // 4, 3)
    labels = hopper_labels.propagate_labels(labels, conn_h, conn_v,
                                            rounds=n_rounds)

    # --- cluster stats via scatter keyed on label (slot r*c is the sink of
    # non-clusterable cells: in range, hence the +1), image l's slots offset
    # by l*(r*c+1)
    n_img = labels.numel() // (r * c)
    flat = labels.reshape(-1).to(torch.int64)
    if n_img > 1:
        base = (torch.arange(n_img, device=dev) * (r * c + 1))[:, None]
        flat = (flat.reshape(n_img, r * c) + base).reshape(-1)
    n_slots = n_img * (r * c + 1)
    is_c = clusterable.reshape(-1)
    ones = is_c.to(torch.int64)
    size = torch.zeros(n_slots, dtype=torch.int64, device=dev).index_add_(0, flat, ones)
    rows2d = torch.arange(r, device=dev)[:, None].expand(shape).reshape(-1)
    rmin = torch.full((n_slots,), r, dtype=torch.int64, device=dev).scatter_reduce_(
        0, flat, torch.where(is_c, rows2d, r), "amin", include_self=True)
    rmax = torch.full((n_slots,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
        0, flat, torch.where(is_c, rows2d, -1), "amax", include_self=True)
    span = rmax - rmin + 1

    big = size >= cfg.min_cluster_size
    liney = (size >= cfg.segment_valid_point_num) & (span >= cfg.min_line_num)
    keep_label = big | liney
    keep = clusterable & keep_label[flat].reshape(shape)
    outlier = clusterable & ~keep

    return Segmentation(
        ground=ground,
        segmented=keep | ground,
        outlier=outlier,
        label=labels,
    )
