"""Factor library: correspondence construction + batched residuals.

  * scan-to-scan edge / plane matching
  * map edge (eigendirection line) / map plane (PCA fit) matching
  * point-to-plane and point-to-line residuals with slerp-scaled de-skew
  * closed-form point Jacobians for the window's analytic linearization
  * extrinsic prior residual

Correspondences are *data* (fixed-size padded tensors built once per outer
iteration with batched k-NN), residuals are *pure functions* of poses.
Counterpart of ``mloam_tpu/solver/factors.py``. The k-NN of all four matchers
is ``ops/knn.knn_auto``: the hand-written CUDA kernel on CUDA tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mloam_tpu_torch.core import rotations as rot
from mloam_tpu_torch.core import se3
from mloam_tpu_torch.core.rotations import _cross
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.frontend.features import FeatCloud
from mloam_tpu_torch.ops import knn as knn_ops
from mloam_tpu_torch.ops import sym3x3
from mloam_tpu_torch.solver import robust



class PlaneCorr(NamedTuple):
    """Point-to-plane correspondences: n·(T p) + d ≈ 0 in the target frame."""

    p: torch.Tensor       # [N, 3] source point (source sensor frame)
    s: torch.Tensor       # [N] de-skew fraction of the source point
    normal: torch.Tensor  # [N, 3] target-frame plane normal (unit)
    d: torch.Tensor       # [N] plane offset
    w: torch.Tensor       # [N] weight (0 = invalid)


class EdgeCorr(NamedTuple):
    """Point-to-line correspondences via two target-frame points."""

    p: torch.Tensor   # [N, 3]
    s: torch.Tensor   # [N]
    pa: torch.Tensor  # [N, 3]
    pb: torch.Tensor  # [N, 3]
    w: torch.Tensor   # [N]


# ---------------------------------------------------------------------------
# residuals (pure functions of the transformed point)
# ---------------------------------------------------------------------------

def transform_deskew(pose: Pose, p: torch.Tensor, s: torch.Tensor,
                     deskew: bool) -> torch.Tensor:
    """Apply pose to points, slerp-scaled by per-point fraction s when
    de-skewing."""
    if deskew:
        frac = se3.scale(pose, s)
        return rot.quat_rotate(frac.q, p) + frac.t
    return se3.transform_points(pose, p)


def plane_residual(p_t: torch.Tensor, corr: PlaneCorr) -> torch.Tensor:
    """[N] signed point-to-plane distance of transformed points p_t."""
    return torch.sum(corr.normal * p_t, dim=-1) + corr.d


def edge_residual(p_t: torch.Tensor, corr: EdgeCorr) -> torch.Tensor:
    """[N, 3] cross-product point-to-line residual (vector form)."""
    ab = corr.pa - corr.pb
    denom = torch.clamp(torch.linalg.norm(ab, dim=-1, keepdim=True), min=1e-9)
    cr = _cross(p_t - corr.pa, p_t - corr.pb)
    return cr / denom


def plane_point_jacobian(q: torch.Tensor, corr: PlaneCorr) -> torch.Tensor:
    """[N, 6] analytic d(plane residual)/d(right tangent of the point pose).

    For g = T·Exp(δ)·p and r = n·g + d (tangent order [rho, phi]):
    dr/dδ = [ (Rᵀn)ᵀ , (p × Rᵀn)ᵀ ].
    """
    m = rot.quat_rotate(rot.quat_conjugate(q), corr.normal)   # Rᵀ n
    return torch.cat([m, _cross(corr.p, m)], dim=-1)


def edge_point_jacobian(q: torch.Tensor, corr: EdgeCorr) -> torch.Tensor:
    """[N, 3, 6] analytic d(edge residual)/d(right tangent).

    r = (g−pa)×(g−pb)/‖pa−pb‖ has constant dr/dg = skew(pb−pa)/‖pa−pb‖, and
    dg/dδ = R [I | −skew(p)], so dr/dδ = [S·R | −S·R·skew(p)] with
    S = skew(pb−pa)/‖pa−pb‖.
    """
    ab = corr.pa - corr.pb
    denom = torch.clamp(
        torch.linalg.norm(ab, dim=-1, keepdim=True), min=1e-9)[..., None]
    S = rot.skew(-ab) / denom                      # [N, 3, 3]
    SR = S @ rot.quat_to_matrix(q)                 # [N, 3, 3]
    return torch.cat([SR, -SR @ rot.skew(corr.p)], dim=-1)


def robust_weights(r2: torch.Tensor, base_w: torch.Tensor, kind: str,
                   delta: float, gm_c: float = 1.0,
                   gnc_mu=1.0) -> torch.Tensor:
    """IRLS weight per correspondence; detached so GN linearization treats
    it as constant."""
    w = robust.loss_weight(r2.detach(), kind, delta, gm_c=gm_c, gnc_mu=gnc_mu)
    return base_w * w


def pose_normal_equations(ec: EdgeCorr, pc: PlaneCorr, loss_mode: str,
                          delta: float, gm_c: float = 1.0):
    """Closed-form single-pose normal equations of map edge and plane
    factors (the analytic point Jacobians, batched): ``linearize_fn(T, mu)``
    -> (H [6, 6], g [6], cost) for the Gauss-Newton solver, with IRLS robust
    weights from the current residuals. The same H, g and cost as a
    forward-mode Jacobian of the stacked residuals."""

    def linearize_fn(T: Pose, mu=1.0):
        re = edge_residual(se3.transform_points(T, ec.p), ec)
        we = robust_weights(torch.sum(re * re, -1), ec.w, loss_mode, delta,
                            gm_c=gm_c, gnc_mu=mu)
        rp = plane_residual(se3.transform_points(T, pc.p), pc)
        wp = robust_weights(rp * rp, pc.w, loss_mode, delta, gm_c=gm_c,
                            gnc_mu=mu)
        Je = edge_point_jacobian(T.q.expand(ec.p.shape[0], 4), ec)  # [N, 3, 6]
        Jp = plane_point_jacobian(T.q.expand(pc.p.shape[0], 4), pc)  # [N, 6]
        Jew = Je * we[:, None, None]
        Jpw = Jp * wp[:, None]
        H = Jew.reshape(-1, 6).T @ Je.reshape(-1, 6) + Jpw.T @ Jp
        g = Jew.reshape(-1, 6).T @ re.reshape(-1) + Jpw.T @ rp
        cost = 0.5 * (torch.sum(we * torch.sum(re * re, -1)) + torch.sum(wp * rp * rp))
        return H, g, cost

    return linearize_fn


# ---------------------------------------------------------------------------
# scan-to-scan correspondence construction
# ---------------------------------------------------------------------------

def _first_true(cond: torch.Tensor):
    """(index of the first True along axis 1 — 0 when none, any True)."""
    return torch.argmax(cond.to(torch.int8), dim=1), torch.any(cond, dim=1)


def match_scan_edge(
    q: FeatCloud,
    q_in_target: torch.Tensor,
    target: FeatCloud,
    dist_sq_threshold: float = 25.0,
    nearby_scan: float = 2.5,
    k: int = 8,
) -> EdgeCorr:
    """Edge correspondence against the previous sweep's less-sharp cloud:
    nearest neighbor j plus the nearest point l on a *different but nearby*
    ring — the two defining a 3D line.

    ``q_in_target``: query points already de-skewed/predicted into the target
    frame (association uses the current motion estimate).
    """
    d, idx = knn_ops.knn_auto(q_in_target, target.xyz, target.mask, k)
    ring_n = target.ring[idx]                      # [N, k]
    j_ring = ring_n[:, 0]
    diff = torch.abs(ring_n - j_ring[:, None])
    cand_ok = (
        (diff > 0)
        & (diff <= nearby_scan)
        & (d < dist_sq_threshold)
        & (torch.arange(k, device=d.device)[None, :] > 0)
    )
    first, has_l = _first_true(cand_ok)
    l_idx = torch.gather(idx, 1, first[:, None])[:, 0]
    valid = q.mask & has_l & (d[:, 0] < dist_sq_threshold)
    return EdgeCorr(
        p=q.xyz,
        s=q.time,
        pa=target.xyz[idx[:, 0]],
        pb=target.xyz[l_idx],
        w=valid.to(q.xyz.dtype),
    )


def match_scan_plane(
    q: FeatCloud,
    q_in_target: torch.Tensor,
    target: FeatCloud,
    dist_sq_threshold: float = 25.0,
    nearby_scan: float = 2.5,
    k: int = 8,
) -> PlaneCorr:
    """Plane correspondence against the previous sweep's less-flat cloud:
    nearest j, nearest l on the same ring, nearest m on a nearby different
    ring — the three defining a plane."""
    d, idx = knn_ops.knn_auto(q_in_target, target.xyz, target.mask, k)
    ring_n = target.ring[idx]
    j_ring = ring_n[:, 0]
    diff = ring_n - j_ring[:, None]
    pos = torch.arange(k, device=d.device)[None, :]
    in_range = d < dist_sq_threshold
    same = (diff == 0) & (pos > 0) & in_range
    other = (torch.abs(diff) > 0) & (torch.abs(diff) <= nearby_scan) & in_range
    l_first, has_l = _first_true(same)
    m_first, has_m = _first_true(other)
    l_idx = torch.gather(idx, 1, l_first[:, None])[:, 0]
    m_idx = torch.gather(idx, 1, m_first[:, None])[:, 0]

    pj = target.xyz[idx[:, 0]]
    pl = target.xyz[l_idx]
    pm = target.xyz[m_idx]
    n = _cross(pj - pl, pj - pm)
    n_norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n_unit = n / torch.clamp(n_norm, min=1e-9)
    dcoef = -torch.sum(n_unit * pj, dim=-1)
    valid = (
        q.mask
        & has_l
        & has_m
        & (d[:, 0] < dist_sq_threshold)
        & (n_norm[:, 0] > 1e-6)
    )
    return PlaneCorr(
        p=q.xyz, s=q.time, normal=n_unit, d=dcoef,
        w=valid.to(q.xyz.dtype),
    )


# ---------------------------------------------------------------------------
# map correspondence construction (kNN + local fits)
# ---------------------------------------------------------------------------

def match_map_edge(
    q: FeatCloud,
    q_in_map: torch.Tensor,
    map_xyz: torch.Tensor,
    map_mask: torch.Tensor,
    dist_sq_threshold: float = 1.0,
    k: int = 5,
    line_axis_len: float = 0.1,
) -> EdgeCorr:
    """kNN → 3x3 scatter eigendecomposition; accept if strongly linear
    (λ_max > 3 λ_mid); line = centroid ± eigvec."""
    d, idx = knn_ops.knn_auto(q_in_map, map_xyz, map_mask, k)
    nn = map_xyz[idx]                              # [N, k, 3]
    ok_all = d[:, k - 1] < dist_sq_threshold
    centroid = torch.mean(nn, dim=1)
    rel = nn - centroid[:, None, :]
    cov = torch.einsum("nki,nkj->nij", rel, rel) / k
    vals, axis = sym3x3.largest_eigvec3(cov)       # ascending vals
    lin = vals[:, 2] > 3.0 * vals[:, 1]
    pa = centroid + line_axis_len * axis
    pb = centroid - line_axis_len * axis
    valid = q.mask & ok_all & lin
    return EdgeCorr(p=q.xyz, s=q.time, pa=pa, pb=pb,
                    w=valid.to(q.xyz.dtype))


def match_map_plane(
    q: FeatCloud,
    q_in_map: torch.Tensor,
    map_xyz: torch.Tensor,
    map_mask: torch.Tensor,
    dist_sq_threshold: float = 1.0,
    k: int = 5,
    min_plane_dis: float = 0.2,
) -> PlaneCorr:
    """kNN → PCA plane fit (centroid + smallest-scatter eigenvector); accept
    if all neighbors lie within min_plane_dis.

    The PCA form is well-posed for every plane position (an LSQ fit of
    n·p = -1 degenerates for planes passing near the origin) and costs one
    batched closed-form 3x3 eigendecomposition.
    """
    d, idx = knn_ops.knn_auto(q_in_map, map_xyz, map_mask, k)
    nn = map_xyz[idx]
    ok_all = d[:, k - 1] < dist_sq_threshold
    centroid = torch.mean(nn, dim=1)
    rel = nn - centroid[:, None, :]
    scatter = torch.einsum("nki,nkj->nij", rel, rel)
    _, n_unit = sym3x3.smallest_eigvec3(scatter)  # plane normal
    dcoef = -torch.sum(n_unit * centroid, dim=-1)
    fit = torch.abs(torch.einsum("nki,ni->nk", nn, n_unit) + dcoef[:, None])
    planar = torch.all(fit < min_plane_dis, dim=1)
    # LOAM weight: downweight correspondences far relative to range
    res0 = torch.abs(torch.sum(n_unit * q_in_map, -1) + dcoef)
    rng = torch.linalg.norm(q.xyz, dim=-1)
    quality = torch.clamp(
        1.0 - 0.9 * res0 / torch.clamp(torch.sqrt(rng), min=1e-3), 0.1, 1.0)
    valid = q.mask & ok_all & planar
    return PlaneCorr(
        p=q.xyz, s=q.time, normal=n_unit, d=dcoef,
        w=valid.to(q.xyz.dtype) * quality,
    )


# ---------------------------------------------------------------------------
# extrinsic prior
# ---------------------------------------------------------------------------

def prior_residual(ext: Pose, ext_prior: Pose, pos_w: float, rot_w: float) -> torch.Tensor:
    """[6] weighted tangent error between extrinsic estimate and prior."""
    xi = se3.boxminus(ext, ext_prior)
    w = torch.cat([torch.full((3,), pos_w, dtype=xi.dtype, device=xi.device),
                   torch.full((3,), rot_w, dtype=xi.dtype, device=xi.device)])
    return w * xi
