"""Scan-to-scan LiDAR odometry tracker.

Rounds of {rebuild edge/plane correspondences against the previous sweep,
damped GN over one relative pose with a robust loss}, with constant-velocity
de-skew. Counterpart of ``mloam_tpu/odometry/tracker.py``.

Conventions:
  * The tracked state T is the pose of the *current sweep start* in the
    *previous sweep start* frame (prev <- curr).
  * Under constant velocity, the sensor pose at sweep fraction s is
    curr_start ∘ scale(T, s); a point p measured at s maps into the previous
    frame as  T ∘ scale(T, s) · p.  The previous sweep's features are stored
    already de-skewed to their own sweep start, so both sides live in
    consistent frames.
  * After convergence, the current features are de-skewed to the current
    sweep start with scale(T, s) and returned for the next call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mloam_tpu_torch.config import TrackerConfig
from mloam_tpu_torch.core import rotations as rot
from mloam_tpu_torch.core import se3
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.frontend.features import FeatCloud, FeatureFrame
from mloam_tpu_torch.solver import factors, robust
from mloam_tpu_torch.solver.gauss_newton import gauss_newton


class TrackResult(NamedTuple):
    pose: Pose               # prev <- curr
    cost: torch.Tensor
    H: torch.Tensor          # [6, 6] final GN Hessian (degeneracy/cov input)
    n_edge: torch.Tensor
    n_plane: torch.Tensor
    # [6] ascending eigenvalues of the initial measurement Hessian when
    # cfg.eig_threshold > 0; zeros when remapping is disabled
    eig: torch.Tensor | None = None


def _project_to_prev(T: Pose, p: torch.Tensor, s: torch.Tensor,
                     deskew: bool) -> torch.Tensor:
    if deskew:
        frac = se3.scale(T, s)
        p0 = rot.quat_rotate(frac.q, p) + frac.t
    else:
        p0 = p
    return rot.quat_rotate(T.q[None, :], p0) + T.t[None, :]


def deskew_features(T: Pose, f: FeatCloud) -> FeatCloud:
    """De-skew a feature cloud to its sweep start using per-sweep motion T."""
    frac = se3.scale(T, f.time)
    xyz = rot.quat_rotate(frac.q, f.xyz) + frac.t
    return f._replace(xyz=torch.where(f.mask[:, None], xyz, 0.0))


def track(
    prev: FeatureFrame,
    curr: FeatureFrame,
    T_init: Pose,
    cfg: TrackerConfig,
) -> tuple[TrackResult, FeatureFrame]:
    """Estimate prev <- curr. ``prev`` must hold de-skewed features.

    Returns the result plus ``curr`` de-skewed for use as the next target.
    """
    T = T_init

    gnc = cfg.loss_mode == "gnc_gm"

    def make_residual_fn(edge_corr, plane_corr):
        def residual_fn(Tx: Pose, mu=1.0):
            pe = _project_to_prev(Tx, edge_corr.p, edge_corr.s, cfg.deskew)
            re = factors.edge_residual(pe, edge_corr)          # [Ne, 3]
            pp = _project_to_prev(Tx, plane_corr.p, plane_corr.s, cfg.deskew)
            rp = factors.plane_residual(pp, plane_corr)        # [Np]
            we = factors.robust_weights(
                torch.sum(re * re, -1), edge_corr.w, cfg.loss_mode,
                cfg.huber_delta, gm_c=cfg.gm_c, gnc_mu=mu,
            )
            wp = factors.robust_weights(
                rp * rp, plane_corr.w, cfg.loss_mode,
                cfg.huber_delta, gm_c=cfg.gm_c, gnc_mu=mu,
            )
            r = torch.cat([re.reshape(-1), rp])
            w = torch.cat([torch.repeat_interleave(we, 3), wp])
            return r, w

        if not gnc:
            return lambda Tx: residual_fn(Tx)
        return residual_fn

    def retract(Tx: Pose, dx: torch.Tensor) -> Pose:
        return se3.boxplus(Tx, dx)

    result = None
    for _ in range(cfg.outer_iters):
        q_edge = curr.sharp
        q_plane = curr.flat
        pe = _project_to_prev(T, q_edge.xyz, q_edge.time, cfg.deskew)
        pp = _project_to_prev(T, q_plane.xyz, q_plane.time, cfg.deskew)
        edge_corr = factors.match_scan_edge(
            q_edge, pe, prev.less_sharp, cfg.dist_sq_threshold, cfg.nearby_scan
        )
        plane_corr = factors.match_scan_plane(
            q_plane, pp, prev.less_flat, cfg.dist_sq_threshold, cfg.nearby_scan
        )
        st = gauss_newton(
            make_residual_fn(edge_corr, plane_corr),
            T,
            retract,
            dim=6,
            # GNC needs iterations to anneal; the gnc mode gets a full
            # anneal budget, opt-in with the loss mode
            iters=max(cfg.gn_iters, 8) if gnc else cfg.gn_iters,
            # solution remapping in the scan-to-scan solve: freeze update
            # directions whose measurement eigenvalue sits below the floor
            remap_threshold=(cfg.eig_threshold
                             if cfg.eig_threshold > 0 else None),
            remap_snap_purity=cfg.eig_snap_purity,
            mu_schedule=(robust.gnc_mu_schedule(
                cfg.gnc_mu_init, max(cfg.gn_iters, 8) + 1)
                         if gnc else None),
        )
        T = st.x
        result = TrackResult(
            pose=T,
            cost=st.cost,
            H=st.H,
            n_edge=torch.sum(edge_corr.w > 0),
            n_plane=torch.sum(plane_corr.w > 0),
            eig=st.eig0[0],
        )

    if cfg.deskew:
        curr = FeatureFrame(*(deskew_features(T, f) for f in curr))
    return result, curr
