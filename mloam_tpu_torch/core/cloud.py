"""Point-cloud tensor schema: fixed-capacity padded clouds + masks.

Counterpart of ``mloam_tpu/core/cloud.py``. Every cloud is a set of
statically-shaped tensors; invalid slots are masked, never trimmed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mloam_tpu_torch.core import rotations as rot
from mloam_tpu_torch.core import se3
from mloam_tpu_torch.core.se3 import Pose


class Cloud(NamedTuple):
    """Flat padded cloud. xyz [N,3]; mask [N] bool; attr [N] (intensity or
    relative sweep time, feature-dependent)."""

    xyz: torch.Tensor
    mask: torch.Tensor
    attr: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @staticmethod
    def zeros(n: int, dtype=torch.float32, device=None) -> "Cloud":
        return Cloud(torch.zeros((n, 3), dtype=dtype, device=device),
                     torch.zeros((n,), dtype=torch.bool, device=device),
                     torch.zeros((n,), dtype=dtype, device=device))


class CovCloud(NamedTuple):
    """Cloud with per-point 3x3 covariance (reference ``PointXYZIWithCov``)."""

    xyz: torch.Tensor   # [N, 3]
    cov: torch.Tensor   # [N, 3, 3]
    mask: torch.Tensor  # [N]
    attr: torch.Tensor  # [N]

    @staticmethod
    def zeros(n: int, dtype=torch.float32, device=None) -> "CovCloud":
        return CovCloud(torch.zeros((n, 3), dtype=dtype, device=device),
                        torch.zeros((n, 3, 3), dtype=dtype, device=device),
                        torch.zeros((n,), dtype=torch.bool, device=device),
                        torch.zeros((n,), dtype=dtype, device=device))


def transform_cloud(pose: Pose, c: Cloud) -> Cloud:
    return c._replace(xyz=se3.transform_points(pose, c.xyz))


def deskew(xyz: torch.Tensor, s: torch.Tensor, motion: Pose) -> torch.Tensor:
    """Motion-compensate points to sweep start.

    ``motion`` is the full-sweep relative pose (T such that
    p_start = scale(T, s) · p); ``s`` [N] the per-point relative sweep time
    in [0, 1] (the reference's ``TransformToStart`` slerp semantics).
    """
    frac = se3.scale(motion, s)
    return rot.quat_rotate(frac.q, xyz) + frac.t


def merge_clouds(a: Cloud, b: Cloud) -> Cloud:
    return Cloud(torch.cat([a.xyz, b.xyz]), torch.cat([a.mask, b.mask]),
                 torch.cat([a.attr, b.attr]))
