"""Keyframe-sharded map assembly: the distributed mapping backend path.

Counterpart of ``mloam_tpu/parallel/sharded_map.py``. The keyframe ring
(``mapping/keyframes.KeyframeDB``) is sharded on its keyframe axis over a
mesh (``parallel/mesh.py``), and the surround-map query runs per shard:

  * every shard radius-tests and top-M-selects within its own keyframes,
  * projects the selected keyframes' clouds to the map frame with the
    Barfoot covariance pushforward (the single-device mapper's math),
  * an ``all_gather`` over every mesh axis assembles the full cloud.
"""

from __future__ import annotations

import torch

from mloam_tpu_torch.core import se3, uncertainty
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.frontend.features import FeatCloud
from mloam_tpu_torch.mapping import keyframes as KF
from mloam_tpu_torch.parallel.mesh import data_axes


def shard_db(db: KF.KeyframeDB, mesh) -> KF.KeyframeDB:
    """Lay the keyframe axis out over all mesh axes in contiguous blocks
    (K must divide by ``mesh.size``): every per-keyframe leaf becomes
    [*mesh.local_shape, K / size, ...]; the ring cursor stays as it is."""
    def place(x):
        return x.to(mesh.device) if x.ndim == 0 else mesh.shard(x)

    return KF.KeyframeDB(
        poses=Pose(place(db.poses.q), place(db.poses.t)), cov=place(db.cov),
        corner=FeatCloud(*(place(x) for x in db.corner)),
        surf=FeatCloud(*(place(x) for x in db.surf)),
        outlier=FeatCloud(*(place(x) for x in db.outlier)),
        valid=place(db.valid), head=place(db.head))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [*lead, K, ...] at idx [*lead, m] -> [*lead, m, ...]."""
    i = idx.reshape(idx.shape + (1,) * (x.ndim - idx.ndim))
    return torch.take_along_dim(x, i, dim=idx.ndim - 1)


def sharded_surround_map(db: KF.KeyframeDB, center: torch.Tensor, radius: float,
                         m_per_shard: int, ext_cov: torch.Tensor,
                         cov_meas: torch.Tensor, mesh, use_corner: bool = False):
    """Assemble the world-frame surround cov-cloud from a sharded DB.

    Returns (xyz [size · m_per_shard · N, 3], cov [..., 3, 3], mask): fixed
    shapes, in mesh order, the same on every shard."""
    axes = data_axes(mesh)
    idx, ok = KF.surrounding(db, center, radius, m_per_shard)   # [*lead, m]
    stack: FeatCloud = db.corner if use_corner else db.surf
    xyz = _take(stack.xyz, idx)
    mask = _take(stack.mask, idx) & ok[..., None]
    pose = Pose(_take(db.poses.q, idx), _take(db.poses.t, idx))
    y = se3.transform_points(pose, xyz)
    cov_pt = uncertainty.point_cov_pushforward(xyz, pose, _take(db.cov, idx) + ext_cov,
                                               cov_meas)

    def gather(a):
        # [*lead, m, N, ...] -> every shard's, concatenated
        flat = a.reshape(a.shape[:mesh.ndim] + (-1,) + a.shape[mesh.ndim + 2:])
        return mesh.replicated(mesh.all_gather(flat, axes))

    return gather(y), gather(cov_pt), gather(mask)
