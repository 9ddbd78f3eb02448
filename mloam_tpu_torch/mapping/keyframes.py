"""Keyframe database: fixed-capacity ring of posed feature clouds.

Counterpart of ``mloam_tpu/mapping/keyframes.py`` (the reference mapper's
``saveKeyframe`` and surrounding-keyframe extraction): kd-tree radius search
over keyframe positions becomes a masked distance test + top-M gather.

Clouds are stored in each keyframe's own base frame together with the 6x6
pose covariance; projection into the map frame (with covariance pushforward)
happens at extraction.

Insertion writes the one slot ``head % K`` of the ring in place, under a
device-side condition, and returns the database with the new cursor: at the
mapper's default caps the ring is tens of MB, and a functional update would
copy all of it per mapped sweep. A ``KeyframeDB`` handed to ``insert`` is
therefore updated, not kept.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mloam_tpu_torch.core import se3
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.frontend.features import FeatCloud
from mloam_tpu_torch.ops import select


class KeyframeDB(NamedTuple):
    poses: Pose          # [K] world(map) <- base
    cov: torch.Tensor    # [K, 6, 6] pose covariance
    corner: FeatCloud    # [K, Nc] base-frame corner features
    surf: FeatCloud      # [K, Ns]
    outlier: FeatCloud   # [K, No] segmentation rejects (map completeness,
    #                      reference /laser_cloud_outlier; not matched)
    valid: torch.Tensor  # [K]
    head: torch.Tensor   # scalar int32 ring cursor


def empty_db(k: int, cap_corner: int, cap_surf: int, cap_outlier: int = 0,
             device=None) -> KeyframeDB:
    def stack(cap):
        return FeatCloud(*(x.expand((k,) + x.shape).clone()
                           for x in FeatCloud.zeros(max(cap, 1), device=device)))

    return KeyframeDB(
        poses=Pose.identity((k,), device=device),
        cov=torch.zeros((k, 6, 6), device=device),
        corner=stack(cap_corner),
        surf=stack(cap_surf),
        outlier=stack(cap_outlier),
        valid=torch.zeros((k,), dtype=torch.bool, device=device),
        head=torch.tensor(0, dtype=torch.int32, device=device),
    )


def write_slot(ring: torch.Tensor, i: torch.Tensor, new: torch.Tensor,
                cond: torch.Tensor | None):
    """ring[i] = cond ? new : ring[i], for a one-element index tensor ``i``
    (a 0-dim index would be read on the host)."""
    new = new.to(ring.dtype)[None]
    if cond is not None:
        new = torch.where(cond, new, ring.index_select(0, i))
    ring.index_copy_(0, i, new)


def insert(db: KeyframeDB, pose: Pose, cov: torch.Tensor, corner: FeatCloud,
           surf: FeatCloud, outlier: FeatCloud | None = None,
           where: torch.Tensor | None = None) -> KeyframeDB:
    """Ring-insert one keyframe (overwrites the oldest at capacity). With
    ``where`` (a device bool) the slot is written and the cursor advanced
    only where it holds; the write happens in place either way (see the
    module note). Without ``outlier`` the slot's outlier cloud is kept."""
    k = db.valid.shape[0]
    i = torch.remainder(db.head, k).to(torch.int64).reshape(1)
    pairs = [(db.poses.q, pose.q), (db.poses.t, pose.t), (db.cov, cov)]
    pairs += list(zip(db.corner, corner)) + list(zip(db.surf, surf))
    if outlier is not None:
        pairs += list(zip(db.outlier, outlier))
    for ring, new in pairs:
        write_slot(ring, i, new, where)
    write_slot(db.valid, i, torch.ones((), dtype=torch.bool, device=i.device), where)
    step = 1 if where is None else where.to(torch.int32)
    return db._replace(head=db.head + step)


def should_insert(pose: Pose, last_kf: Pose, dist_gate: float,
                  angle_gate_deg: float) -> torch.Tensor:
    """Keyframe gating on relative motion (saveKeyframe :649-656)."""
    rel = se3.relative(last_kf, pose)
    d = torch.linalg.norm(rel.t)
    ang = torch.linalg.norm(se3.log(rel)[3:])
    return (d > dist_gate) | (ang > math.radians(angle_gate_deg))


def surrounding(db: KeyframeDB, center: torch.Tensor, radius: float, m: int):
    """Indices + mask of up to ``m`` keyframes within ``radius`` of
    ``center`` (closest first, ties to the lowest slot as ``lax.top_k``
    orders them). ``m`` is clamped to the ring capacity. A ring with
    leading axes (a sharded one, ``parallel/sharded_map``) is searched per
    leading index."""
    d2 = torch.sum((db.poses.t - center) ** 2, dim=-1)
    d2 = torch.where(db.valid, d2, torch.inf)
    m = min(m, int(d2.shape[-1]))
    neg, idx = select.top_k_lowest_index(-d2, m)
    sel_d2 = -neg
    ok = torch.isfinite(sel_d2) & (sel_d2 < radius * radius)
    return idx, ok
