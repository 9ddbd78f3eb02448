"""Loop-closure registration: coarse align + LOAM-factor fine refinement.

Counterpart of ``mloam_tpu/loop/registration.py`` (the reference's
``LoopRegistration``: a global registration, then rounds of map-factor
refinement seeded by it). The coarse transform is the scan-context yaw and
a masked-centroid translation; the fine stage is the map edge / plane
Gauss-Newton used everywhere else, each outer iteration re-matching through
``factors.match_map_*`` (two k-NN calls, kernel K2 on the GPU).

The Gauss-Newton normal equations are closed form
(``factors.pose_normal_equations``) where the JAX package takes a
``jacfwd`` of the stacked residuals: the same H, g and cost.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mloam_tpu_torch.config import MloamConfig
from mloam_tpu_torch.core import rotations as rot
from mloam_tpu_torch.core import se3
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.frontend.features import FeatCloud
from mloam_tpu_torch.solver import factors
from mloam_tpu_torch.solver.gauss_newton import gauss_newton


class RegistrationResult(NamedTuple):
    pose: Pose                   # target <- query
    cost: torch.Tensor           # mean squared residual of matched surf points
    inlier_frac: torch.Tensor
    ok: torch.Tensor             # bool acceptance


def yaw_quat(yaw: torch.Tensor) -> torch.Tensor:
    """[..., 4] rotation by ``yaw`` about z."""
    zero = torch.zeros_like(yaw)
    return rot.so3_exp_quat(torch.stack([zero, zero, yaw], -1))


def coarse_align(q_xyz, q_mask, t_xyz, t_mask, yaw: torch.Tensor) -> Pose:
    """Yaw from scan context + masked-centroid translation."""
    q_yaw = yaw_quat(yaw)
    wq = q_mask.to(q_xyz.dtype)
    wt = t_mask.to(t_xyz.dtype)
    cq = torch.sum(q_xyz * wq[:, None], 0) / torch.clamp(torch.sum(wq), min=1)
    ct = torch.sum(t_xyz * wt[:, None], 0) / torch.clamp(torch.sum(wt), min=1)
    return Pose(q_yaw, ct - rot.quat_rotate(q_yaw, cq))


def fine_register(
    query_corner: FeatCloud,
    query_surf: FeatCloud,
    target_corner_xyz, target_corner_mask,
    target_surf_xyz, target_surf_mask,
    T_init: Pose,
    cfg: MloamConfig,
    outer_iters: int = 3,
    gn_iters: int = 8,
    accept_cost: float = 0.06,
    accept_inlier_frac: float = 0.5,
) -> RegistrationResult:
    """LOAM-factor ICP-style refinement of target <- query: ``outer_iters``
    rounds of (edge and plane matching, ``gn_iters`` damped Gauss-Newton
    steps). Accepted when the share of query surf points matched with a
    plane residual under 0.3 m exceeds ``accept_inlier_frac`` and the mean
    squared residual of the matched ones is under ``accept_cost``."""
    T = T_init
    pc = None
    for _ in range(outer_iters):
        pc = factors.match_map_plane(
            query_surf, se3.transform_points(T, query_surf.xyz),
            target_surf_xyz, target_surf_mask, dist_sq_threshold=2.0)
        ec = factors.match_map_edge(
            query_corner, se3.transform_points(T, query_corner.xyz),
            target_corner_xyz, target_corner_mask, dist_sq_threshold=2.0)
        st = gauss_newton(None, T, se3.boxplus, dim=6, iters=gn_iters,
                          linearize_fn=factors.pose_normal_equations(ec, pc, "huber", 0.2))
        T = st.x

    rp = factors.plane_residual(se3.transform_points(T, pc.p), pc)
    matched = pc.w > 0
    n_match = torch.sum(matched)
    n_query = torch.clamp(torch.sum(query_surf.mask), min=1)
    inlier = torch.sum(matched & (torch.abs(rp) < 0.3))
    mean_sq = torch.sum(torch.where(matched, rp * rp, 0.0)) / torch.clamp(n_match, min=1)
    frac = inlier / n_query
    return RegistrationResult(
        pose=T, cost=mean_sq, inlier_frac=frac,
        ok=(frac > accept_inlier_frac) & (mean_sq < accept_cost))
