"""SE(3) uncertainty algebra (Barfoot-style covariance compounding).

Counterpart of ``mloam_tpu/core/uncertainty.py`` (itself a re-derivation of
the reference's ``estimator/src/lidarMapper/associate_uct.hpp``). All
functions are batched matrix algebra over leading dims: the per-point
pushforward is applied to whole clouds at once.

Tangent/covariance block order is [rho (trans); phi (rot)], the layout of
``core/se3.adjoint``.
"""

from __future__ import annotations

import torch

from mloam_tpu_torch.core import rotations as rot
from mloam_tpu_torch.core import se3
from mloam_tpu_torch.core.se3 import Pose


def _covop1(B: torch.Tensor) -> torch.Tensor:
    """A = -tr(B) I + B  (the <<.>> operator of Barfoot eq. 44)."""
    tr = torch.diagonal(B, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(3, dtype=B.dtype, device=B.device)
    return -tr * eye + B


def _covop2(B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """A = <<B>><<C>> + <<CB>>  (Barfoot eq. 45)."""
    return _covop1(B) @ _covop1(C) + _covop1(C @ B)


def _T(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def compound_pose_cov(pose_1: Pose, cov_1: torch.Tensor, pose_2: Pose,
                      cov_2: torch.Tensor, fourth_order: bool = True):
    """Compose T = T1 ∘ T2 and propagate 6x6 covariances.

    Second-order: Σ = Σ1 + Ad(T1) Σ2 Ad(T1)ᵀ. With ``fourth_order`` the
    Barfoot 4th-order correction terms (A1/A2/B) are added.
    """
    pose_cp = se3.compose(pose_1, pose_2)
    AdT1 = se3.adjoint(pose_1)
    cov_2p = AdT1 @ cov_2 @ _T(AdT1)
    cov = cov_1 + cov_2p
    if fourth_order:
        def blocks(C):
            return C[..., :3, :3], C[..., :3, 3:], C[..., 3:, 3:]

        c1_rr, c1_rp, c1_pp = blocks(cov_1)
        c2_rr, c2_rp, c2_pp = blocks(cov_2p)

        def build_A(c_rp, c_pp):
            Z = torch.zeros_like(c_pp)
            top = torch.cat([_covop1(c_pp), _covop1(c_rp + _T(c_rp))], dim=-1)
            bot = torch.cat([Z, _covop1(c_pp)], dim=-1)
            return torch.cat([top, bot], dim=-2)

        A1 = build_A(c1_rp, c1_pp)
        A2 = build_A(c2_rp, c2_pp)
        c1_rpT, c2_rpT = _T(c1_rp), _T(c2_rp)
        Brr = (_covop2(c1_pp, c2_rr) + _covop2(c1_rpT, c2_rp)
               + _covop2(c1_rp, c2_rpT) + _covop2(c1_rr, c2_pp))
        Brp = _covop2(c1_pp, c2_rpT) + _covop2(c1_rpT, c2_pp)
        Bpp = _covop2(c1_pp, c2_pp)
        B = torch.cat([torch.cat([Brr, Brp], dim=-1),
                       torch.cat([_T(Brp), Bpp], dim=-1)], dim=-2)
        cov = cov + (A1 @ cov_2p + cov_2p @ _T(A1)
                     + A2 @ cov_1 + cov_1 @ _T(A2)) / 12.0 + B / 4.0
    return pose_cp, cov


def point_cov_pushforward(points: torch.Tensor, pose: Pose,
                          cov_pose: torch.Tensor, cov_meas: torch.Tensor,
                          cov_points: torch.Tensor | None = None) -> torch.Tensor:
    """Per-point 3x3 covariance of transformed points y = T p.

    Σ_y = G diag(Σ_pose, Σ_z) Gᵀ with G = [pointToFS(Tp) | R], where
    pointToFS(x) = [I | -[x]ₓ] on the xyz rows. ``points`` [..., N, 3] with
    ``pose`` and ``cov_pose`` [..., 6, 6] of batch shape [...] (one pose
    per cloud); ``cov_meas`` the 3x3 measurement covariance; ``cov_points``
    an optional per-point covariance [..., N, 3, 3] to accumulate. Returns
    [..., N, 3, 3].
    """
    R = rot.quat_to_matrix(pose.q)[..., None, :, :]
    y = se3.transform_points(pose, points)
    # [I|-S] [[Σrr, Σrp],[Σpr, Σpp]] [I|-S]ᵀ = Σrr - S Σpr - Σrp Sᵀ + S Σpp Sᵀ
    S = rot.skew(y)
    c = cov_pose[..., None, :, :]
    c_rr, c_rp, c_pp = c[..., :3, :3], c[..., :3, 3:], c[..., 3:, 3:]
    ST = _T(S)
    pose_term = c_rr - S @ _T(c_rp) - c_rp @ ST + S @ c_pp @ ST
    meas = cov_meas if cov_points is None else cov_meas + cov_points
    return pose_term + R @ meas @ _T(R)
