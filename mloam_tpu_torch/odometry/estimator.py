"""Sliding-window odometry backend.

Window feature stacks, local-map construction by re-projecting window sweeps
into the pivot frame, the windowed Gauss-Newton over (pivot..newest) poses,
and VINS-style marginalization of the pivot pose. Counterpart of
``mloam_tpu/odometry/estimator.py``.

Design decisions:
  * The window is a fixed-shape NamedTuple (stacked poses + stacked per-frame
    feature tensors); sliding is a roll, pushing a slice write.
  * The local map is rebuilt per step as a voxel reduction over the stacked
    window clouds — no persistent kd-tree, no incremental state.
  * The solve optimizes poses pivot..newest (opt_window + 1 blocks): normal
    equations assembled densely from closed-form point Jacobians chained
    through the pose graph, solved directly.
  * Marginalizing the pivot = dense Schur on the final (H, g); the resulting
    prior (with its linearization poses) rides in the window state and is
    replayed with first-order correction.

  * Online extrinsic calibration (``calibrate_ext=True``, ESTIMATE_EXTRINSIC
    1): the extrinsics of lidars 1..L-1 join the tangent after the poses,
    with a weak prior toward their running estimates, and the local map is
    formed by the reference lidar only.

  * Good-feature selection (``gf_ratio < 1``): ``gf_method="gd"`` zeroes the
    weight of all but the top logdet-gain correspondences; with
    ``gf_compact`` every query frame group's correspondences are then
    compacted into a host-sized buffer of
    ``min(n, max(ceil(n · gf_ratio · 1.25), 32))`` rows, so the Gauss-Newton
    shapes shrink (any other method is the compaction alone, an even stride
    over the matched rows). The k-NN runs before the selection, so its shapes
    do not change.

  * Degeneracy (``eig_threshold > 0``, the ``indoor_degenerate`` operating
    point): the window is linearized once at its start and the armed gate
    reads the measurement Hessian there — the shared weakest direction, a
    leaky count of consecutive consistent sub-threshold sweeps, purity of the
    direction, the support count along it — and hands the solve a projector
    that is the identity unless the gate engages. The gate is tensors only:
    it adds no host read. ``marginalize_pivot`` projects the measurement part
    of the prior with the same projector.

  * Robust losses: huber, ``gm`` (Geman-McClure) and ``gnc_gm`` (its
    graduated surrogate, ``max(gn_iters, 8)`` iterations under
    ``robust.gnc_mu_schedule``).

  * ``analytic=False`` differentiates the stacked residuals by forward-mode
    AD instead of the closed-form normal equations (the reference oracle of
    the analytic path).

Feature stacks carry a lidar axis; all lidars' features are projected through
their extrinsics into the pivot frame.
"""

from __future__ import annotations

from typing import NamedTuple

import math

import torch

from mloam_tpu_torch.config import MloamConfig
from mloam_tpu_torch.core import rotations as rot
from mloam_tpu_torch.core import se3
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.frontend.features import FeatCloud
from mloam_tpu_torch.ops import select, voxel
from mloam_tpu_torch.solver import degeneracy, factors, robust
from mloam_tpu_torch.solver import feature_selection as FS
from mloam_tpu_torch.solver.gauss_newton import _linearize as GN_linearize
from mloam_tpu_torch.solver.gauss_newton import gauss_newton
from mloam_tpu_torch.solver.marginalization import QuadPrior, schur_marginalize_quad


class WindowState(NamedTuple):
    """Fixed-shape sliding window. S = window_size + 1 slots, L lidars.

    The marginalization prior spans [opt poses | non-ref extrinsics] in
    calibration mode and [opt poses] otherwise; mode transitions
    re-initialize it (``reset_prior``).
    """

    poses: Pose            # [S] world <- base_i
    corner: FeatCloud      # [S, L, Nc] per-slot per-lidar corner features
    surf: FeatCloud        # [S, L, Ns] surf features
    ext: Pose              # [L] base <- lidar
    count: torch.Tensor    # scalar int32: frames currently in window
    prior: QuadPrior
    prior_poses: Pose      # [S] linearization poses for the prior
    prior_ext: Pose        # [L] linearization extrinsics for the prior
    # degeneracy persistence state of the armed gate: the weak direction of
    # the last sub-threshold solve and the leaky count of consistent
    # sub-threshold sweeps (the remap engages at eig_persist_k)
    deg_dir: torch.Tensor   # [6]
    deg_count: torch.Tensor  # scalar int32


def _tmap(fn, *trees):
    """Map ``fn`` over the tensors of matching NamedTuples."""
    return type(trees[0])(*(fn(*leaves) for leaves in zip(*trees)))


def init_window(cfg: MloamConfig, cap_corner: int, cap_surf: int,
                device=None) -> WindowState:
    s = cfg.odometry.window_size + 1
    L = cfg.rig.n_lidars

    def stack(n):
        return _tmap(lambda x: x.expand((s, L) + x.shape).clone(),
                     FeatCloud.zeros(n, device=device))

    opt_dim = prior_dim(cfg, calibrate_ext=False)
    return WindowState(
        poses=Pose.identity((s,), device=device),
        corner=stack(cap_corner),
        surf=stack(cap_surf),
        ext=Pose.identity((L,), device=device),
        count=torch.tensor(0, dtype=torch.int32, device=device),
        prior=QuadPrior.empty(opt_dim, device=device),
        prior_poses=Pose.identity((s,), device=device),
        prior_ext=Pose.identity((L,), device=device),
        deg_dir=torch.zeros((6,), device=device),
        deg_count=torch.tensor(0, dtype=torch.int32, device=device),
    )


def prior_dim(cfg: MloamConfig, calibrate_ext: bool) -> int:
    d = (cfg.odometry.opt_window_size + 1) * 6
    if calibrate_ext:
        d += (cfg.rig.n_lidars - 1) * 6
    return d


def reset_prior(state: WindowState, cfg: MloamConfig,
                calibrate_ext: bool) -> WindowState:
    """Re-initialize the prior to the shape of the given mode. The
    linearization points are *copies* of the current poses/extrinsics: the
    window is rolled and written in place, so they must not alias it."""
    dev = state.poses.q.device
    return state._replace(
        prior=QuadPrior.empty(prior_dim(cfg, calibrate_ext), device=dev),
        prior_poses=_tmap(torch.clone, state.poses),
        prior_ext=_tmap(torch.clone, state.ext),
    )


def set_extrinsics(state: WindowState, ext: Pose) -> WindowState:
    return state._replace(ext=ext)


def push_frame(
    state: WindowState,
    pose: Pose,
    corner: FeatCloud,  # [L, Nc]
    surf: FeatCloud,    # [L, Ns]
    cfg: MloamConfig,
) -> WindowState:
    """Slide the window by one and write the new frame into the last slot."""
    s = cfg.odometry.window_size + 1

    def roll_set(stack, new):
        def one(x, n):
            rolled = torch.roll(x, -1, dims=0)  # a fresh tensor: no aliasing
            rolled[s - 1] = n
            return rolled
        return _tmap(one, stack, new)

    return state._replace(
        poses=roll_set(state.poses, pose),
        corner=roll_set(state.corner, corner),
        surf=roll_set(state.surf, surf),
        prior_poses=roll_set(state.prior_poses, pose),
        count=torch.clamp(state.count + 1, max=s),
    )


def build_local_map(state: WindowState, cfg: MloamConfig,
                    map_lidars: tuple[int, ...] | None = None):
    """Project window sweeps' features into the pivot frame and voxel-filter.

    ``map_lidars`` restricts which lidars' clouds FORM the map. During online
    calibration it is the reference lidar only: if a non-reference lidar's
    own points entered the map, its factors would match them against
    themselves, self-consistent at ANY extrinsic, and the extrinsic would
    never refine. None = all lidars (pure odometry).
    """
    s = cfg.odometry.window_size + 1
    pivot = s - 1 - cfg.odometry.opt_window_size
    dev = state.poses.q.device
    piv_pose = Pose(state.poses.q[pivot], state.poses.t[pivot])
    L = cfg.rig.n_lidars
    lidar_ok = torch.ones((L,), dtype=torch.bool, device=dev)
    if map_lidars is not None:
        lidar_ok = torch.zeros((L,), dtype=torch.bool, device=dev)
        lidar_ok[list(map_lidars)] = True

    s_idx = torch.arange(s, device=dev)
    # only slots holding real frames; the NEWEST frame is excluded from its
    # own map so it is never pinned to its prediction by self-matching.
    filled = (s_idx >= (s - state.count)) & (s_idx < s - 1)
    rel = se3.compose(se3.inverse(Pose(piv_pose.q[None], piv_pose.t[None])),
                      state.poses)                                   # [S]
    T = se3.compose(Pose(rel.q[:, None], rel.t[:, None]),
                    Pose(state.ext.q[None], state.ext.t[None]))      # [S, L]

    def project(stack: FeatCloud):
        xyz = se3.transform_points(T, stack.xyz)                     # [S,L,N,3]
        mask = stack.mask & filled[:, None, None] & lidar_ok[None, :, None]
        return xyz.reshape(-1, 3), mask.reshape(-1)

    c_xyz, c_mask = project(state.corner)
    s_xyz, s_mask = project(state.surf)
    # sort-free compaction first: the stacks are mostly padding (per-frame
    # caps are worst-case), and the voxel sort cost scales with row count,
    # not valid count. Exact whenever the valid points fit the bound.
    pc, ps = cfg.odometry.localmap_precap_corner, cfg.odometry.localmap_precap_surf
    if pc is not None and pc * L < c_xyz.shape[0]:
        c_xyz, c_mask = select.compact_stride(c_xyz, c_mask, pc * L)
    if ps is not None and ps * L < s_xyz.shape[0]:
        s_xyz, s_mask = select.compact_stride(s_xyz, s_mask, ps * L)
    # fused packed single-key sort over both feature classes (the window
    # local map spans well under the 1024-cell grid at these leaves)
    return voxel.voxel_downsample_two_class(
        c_xyz, c_mask, cfg.odometry.corner_map_leaf,
        s_xyz, s_mask, cfg.odometry.surf_map_leaf,
    )


class WindowSolveResult(NamedTuple):
    H: torch.Tensor
    g: torch.Tensor
    cost: torch.Tensor
    n_corner: torch.Tensor
    n_surf: torch.Tensor
    eig_min: torch.Tensor  # [n_blocks] per-block smallest Hessian eigenvalue
    # (opt poses, then the extrinsics in calibration mode)
    # contribution of the per-solve gauge anchor (+ calibration extrinsic
    # priors) to (H, g) at the final linearization point. These rows are
    # re-added fresh every solve, so they must be EXCLUDED from the
    # marginalized Hessian: leaving them in re-bakes absolute-pose
    # information into the prior every frame (double counting that grows
    # without bound).
    H_anchor: torch.Tensor
    g_anchor: torch.Tensor
    # [n_blocks, 6] full ascending per-block measurement eigenvalues
    eig_blocks: torch.Tensor | None = None
    # the marginalization prior's (H, g) contribution at the final
    # linearization point
    H_prior: torch.Tensor | None = None
    g_prior: torch.Tensor | None = None
    # [n_blocks] directions ACTUALLY frozen per block (trace deficit of the
    # applied projector)
    frozen: torch.Tensor | None = None
    # [6] the shared-mean block spectrum the gate sees
    eig_shared: torch.Tensor | None = None
    # [6] its weakest eigvector (candidate frozen direction, up to sign)
    weak_dir: torch.Tensor | None = None
    # [n, 6, 6] the projector the armed gate handed the solve (the identity
    # while it keeps the remap disengaged); None when the gate is disarmed
    remap_P: torch.Tensor | None = None
    # effective support count (Σa)²/Σa² of the curvature along the weak
    # direction, a_i = w_i (J_i·v0)² (armed gate only)
    support_neff: torch.Tensor | None = None


def gf_caps(n: int, ratio: float) -> int:
    """Rows a query group keeps under compaction: the selected share with
    1.25x slack for uneven selection across groups, at least 32 (a host
    integer: the Gauss-Newton shapes follow it)."""
    return min(n, max(int(math.ceil(n * ratio * 1.25)), 32))


def _compact_groups(corr, nq: int, n_per: int, cap: int):
    """Compact each of the ``nq`` query groups' correspondences (``n_per``
    rows each, kept where ``w > 0``) into ``cap`` rows, front-compacted by
    rank (an even stride over the kept rows when more than ``cap`` are
    kept); the emptied rows get zero weight."""
    idx, om = select.compact_gather_indices(corr.w.reshape(nq, n_per) > 0, cap)

    def g(leaf):
        grp = leaf.reshape((nq, n_per) + leaf.shape[1:])
        ix = idx.reshape(idx.shape + (1,) * (leaf.ndim - 1)).expand(
            (nq, cap) + leaf.shape[1:])
        return torch.gather(grp, 1, ix).reshape((nq * cap,) + leaf.shape[1:])

    new = type(corr)(*(g(leaf) for leaf in corr))
    return new._replace(w=(new.w.reshape(nq, cap) * om).reshape(nq * cap))


def optimize_window(state: WindowState, cfg: MloamConfig,
                    calibrate_ext: bool = False,
                    lidars: tuple[int, ...] | None = None,
                    analytic: bool = True):
    """Backend solve over poses pivot..newest (+ non-ref extrinsics in
    calibration mode) with the marginalization prior.

    The normal equations are assembled from closed-form point Jacobians
    chained through the pose graph (per-chain 6x6 Gram blocks, then the chain
    rule by adjoints); ``analytic=False`` takes the forward-mode Jacobian of
    the stacked residuals instead. ``lidars`` restricts which lidars contribute
    correspondences. ``calibrate_ext``: ESTIMATE_EXTRINSIC==1, the extrinsic
    blocks of lidars 1..L-1 join the tangent with a weak prior toward the
    prior's linearization extrinsics, and the map is formed by lidar 0 only.

    As in the JAX package the solve passes ``remap_threshold=0.0`` (not
    ``None``) while the degeneracy gate is disarmed, so the projector and the
    block spectra are built on every solve; a direction freezes only if an
    f32 eigenvalue of the mean block comes out negative. Armed
    (``eig_threshold > 0``, analytic), the first outer iteration runs the
    persistence gate on the measurement Hessian at the window's start and
    every solve applies the projector it built.

    Returns (state with updated poses, extrinsics and gate state,
    WindowSolveResult).
    """
    oc = cfg.odometry
    s = oc.window_size + 1
    O = oc.opt_window_size
    pivot = s - 1 - O          # opt poses are the tail: pivot + O + 1 == s
    L = cfg.rig.n_lidars
    n_opt = O + 1
    n_ext = (L - 1) if calibrate_ext else 0
    dim = (n_opt + n_ext) * 6
    dev = state.poses.q.device
    if lidars is None:
        lidars = tuple(range(L))

    c_map, c_mmask, s_map, s_mmask = build_local_map(
        state, cfg, map_lidars=(0,) if calibrate_ext else None)
    pivot_init = Pose(state.poses.q[pivot], state.poses.t[pivot])

    # state under optimization: (poses [S], ext [L])
    def opt_pose(x, i: int) -> Pose:
        poses, _ = x
        return Pose(poses.q[pivot + i], poses.t[pivot + i])

    q_ids = [(f, l) for f in range(1, n_opt) for l in lidars]
    nq = len(q_ids)

    # all query frames share the same target map, so the per-frame
    # correspondence searches batch into ONE k-NN call per feature class
    # (queries concatenated along the point axis, per-point poses applied by
    # repeat in the residual)
    def gather_cat(stack: FeatCloud) -> FeatCloud:
        return _tmap(lambda a: torch.cat([a[pivot + f, l] for f, l in q_ids]),
                     stack)

    qc_all = gather_cat(state.corner)
    qs_all = gather_cat(state.surf)
    n_c = state.corner.xyz.shape[2]
    n_s = state.surf.xyz.shape[2]

    # query group qi = (frame f, lidar l) in row-major order over
    # (1..n_opt-1) x lidars; the lidars are a contiguous run. Built on the
    # device (a tensor from a host list is a copy from pageable memory,
    # which waits for the device).
    nl = len(lidars)
    assert lidars == tuple(range(lidars[0], lidars[0] + nl))
    ar = torch.arange(nq, device=dev)
    f_idx = pivot + 1 + torch.div(ar, nl, rounding_mode="floor")
    l_idx = lidars[0] + torch.remainder(ar, nl)

    def chains(x):
        """[nq] poses: pivot-base (map) frame <- lidar-l frame of opt frame f,
        all query groups in one batched composition. The pivot pose is an
        *optimized* parameter — every factor couples (pivot, frame), so
        marginalizing the pivot transfers relative-pose information to the
        retained frames. Returns (T [nq], E [nq])."""
        poses, ext = x
        Wp = opt_pose(x, 0)
        Wf = Pose(poses.q[f_idx], poses.t[f_idx])
        Ex = Pose(ext.q[l_idx], ext.t[l_idx])
        Wp_inv = se3.inverse(Pose(Wp.q[None], Wp.t[None]))
        return se3.compose(se3.compose(Wp_inv, Wf), Ex), Ex

    def retract(x, dx: torch.Tensor):
        # pure: builds new tensors (no write into the inputs), so it can sit
        # under torch.func.jacfwd
        poses, ext = x
        new = [se3.boxplus(opt_pose(x, i), dx[i * 6:(i + 1) * 6])
               for i in range(n_opt)]
        q = torch.cat([poses.q[:pivot], torch.stack([p.q for p in new])])
        t = torch.cat([poses.t[:pivot], torch.stack([p.t for p in new])])
        if n_ext:
            # lidar 0 is the reference: its extrinsic stays fixed
            ne = se3.boxplus(Pose(ext.q[1:], ext.t[1:]),
                             dx[n_opt * 6:].reshape(n_ext, 6))
            ext = Pose(torch.cat([ext.q[:1], ne.q]), torch.cat([ext.t[:1], ne.t]))
        return Pose(q, t), ext

    def prior_delta(x):
        poses, ext = x
        d = se3.boxminus(
            Pose(poses.q[pivot:], poses.t[pivot:]),
            Pose(state.prior_poses.q[pivot:], state.prior_poses.t[pivot:]),
        ).reshape(-1)
        if n_ext:
            de = se3.boxminus(
                Pose(ext.q[1:], ext.t[1:]),
                Pose(state.prior_ext.q[1:], state.prior_ext.t[1:]),
            ).reshape(-1)
            d = torch.cat([d, de])
        return d

    def point_poses(T: Pose, nc: int = n_c, ns: int = n_s):
        """Per-point chain poses for the concatenated query sets (``nc`` /
        ``ns`` rows per query group)."""
        return (
            (T.q.repeat_interleave(nc, 0), T.t.repeat_interleave(nc, 0)),
            (T.q.repeat_interleave(ns, 0), T.t.repeat_interleave(ns, 0)),
        )

    def ext_prior_rows(e: Pose, l: int) -> torch.Tensor:
        return factors.prior_residual(
            e, Pose(state.prior_ext.q[l], state.prior_ext.t[l]),
            pos_w=1.0, rot_w=1.0)

    def small_residual(xx):
        """The few non-point rows: gauge anchor + calibration extrinsic
        priors.

        Gauge anchor: the factor graph is purely relative (6-dim
        nullspace); a weak absolute prior on the pivot at its pre-solve
        estimate pins the gauge without biasing relative geometry. The
        calibration rows are a weak prior keeping each non-reference
        extrinsic near its running estimate. (The marginalization prior
        enters the normal equations as a quadratic form via gauss_newton's
        quad_prior — no rows here.)"""
        _, ext = xx
        rs = [oc.gauge_weight * se3.boxminus(opt_pose(xx, 0), pivot_init)]
        rs += [ext_prior_rows(Pose(ext.q[l], ext.t[l]), l)
               for l in range(1, n_ext + 1)]
        return torch.cat(rs) if n_ext else rs[0]

    def small_linearization(xx):
        """(rows, Jacobian [6 + 6 n_ext, dim]) of ``small_residual``. Each
        row block depends on one tangent block only (the gauge on the pivot,
        extrinsic l's prior on extrinsic l), so forward-mode AD runs over
        that block's 6-dim tangent alone — the same Jacobian as
        differentiating through ``retract`` over the whole window tangent, at
        a fraction of the ops."""
        _, ext = xx
        piv = opt_pose(xx, 0)
        zero = torch.zeros((6,), dtype=torch.float32, device=dev)
        J6 = torch.func.jacfwd(
            lambda d: oc.gauge_weight * se3.boxminus(se3.boxplus(piv, d), pivot_init)
        )(zero)
        rows = [torch.cat([J6, torch.zeros((6, dim - 6), device=dev)], dim=1)]
        for l in range(1, n_ext + 1):
            e_l = Pose(ext.q[l], ext.t[l])
            col = (n_opt + l - 1) * 6
            row = torch.zeros((6, dim), device=dev)
            row[:, col:col + 6] = torch.func.jacfwd(
                lambda d: ext_prior_rows(se3.boxplus(e_l, d), l))(zero)
            rows.append(row)
        return small_residual(xx), torch.cat(rows) if n_ext else rows[0]

    x = (state.poses, state.ext)
    result = None
    edge_corrs = plane_corrs = None
    # the armed gate's state: set on the first outer iteration, carried out
    # through the WindowState
    deg_P = spectra = support_neff = None
    deg_dir, deg_count = state.deg_dir, state.deg_count
    gnc = oc.loss_mode == "gnc_gm"
    # GNC needs iterations to anneal: the gnc mode gets a full budget
    eff_iters = max(oc.gn_iters, 8) if gnc else oc.gn_iters
    mu_sched = robust.gnc_mu_schedule(oc.gnc_mu_init, eff_iters + 1) if gnc else None

    for _ in range(oc.outer_iters):
        (cq, ct), (sq, st_) = point_poses(chains(x)[0])
        proj_c = rot.quat_rotate(cq, qc_all.xyz) + ct
        proj_s = rot.quat_rotate(sq, qs_all.xyz) + st_
        edge_corrs = factors.match_map_edge(
            qc_all, proj_c, c_map, c_mmask, oc.dist_sq_threshold)
        plane_corrs = factors.match_map_plane(
            qs_all, proj_s, s_map, s_mmask, oc.dist_sq_threshold)
        if oc.gf_ratio < 1.0 and oc.gf_method == "gd":
            # odometry-side good-feature selection: every matched
            # correspondence scored by its logdet gain against the running
            # information matrix (point Jacobians w.r.t. the chain pose)
            keep_p, keep_e = FS.logdet_gain_select(
                factors.plane_point_jacobian(sq, plane_corrs), plane_corrs.w,
                factors.edge_point_jacobian(cq, edge_corrs), edge_corrs.w,
                oc.gf_ratio, max_ratio=oc.gf_ratio)
            edge_corrs = edge_corrs._replace(w=edge_corrs.w * keep_e.to(edge_corrs.w.dtype))
            plane_corrs = plane_corrs._replace(w=plane_corrs.w * keep_p.to(plane_corrs.w.dtype))
        if oc.gf_ratio < 1.0 and oc.gf_compact:
            nc_cur, ns_cur = gf_caps(n_c, oc.gf_ratio), gf_caps(n_s, oc.gf_ratio)
            edge_corrs = _compact_groups(edge_corrs, nq, n_c, nc_cur)
            plane_corrs = _compact_groups(plane_corrs, nq, n_s, ns_cur)
        else:
            nc_cur, ns_cur = n_c, n_s

        def point_rows(T: Pose, mu):
            """Edge residuals [n, 3] and plane residuals [n] of the chain
            poses ``T``, with their IRLS weights under convexity ``mu``."""
            ec, pc = edge_corrs, plane_corrs
            (cq, ct), (sq, st_) = point_poses(T, nc_cur, ns_cur)
            re = factors.edge_residual(rot.quat_rotate(cq, ec.p) + ct, ec)
            we = factors.robust_weights(
                torch.sum(re * re, -1), ec.w, oc.loss_mode, oc.huber_delta,
                gm_c=oc.gm_c, gnc_mu=mu)
            rp = factors.plane_residual(rot.quat_rotate(sq, pc.p) + st_, pc)
            wp = factors.robust_weights(rp * rp, pc.w, oc.loss_mode,
                                        oc.huber_delta, gm_c=oc.gm_c, gnc_mu=mu)
            return (cq, re, we), (sq, rp, wp)

        def residual_fn(xx, mu=1.0):
            """The stacked rows for ``analytic=False``: point residuals and
            the small rows, with their weights."""
            (_, re, we), (_, rp, wp) = point_rows(chains(xx)[0], mu)
            rsm = small_residual(xx)
            return (torch.cat([re.reshape(-1), rp, rsm]),
                    torch.cat([torch.repeat_interleave(we, 3), wp,
                               torch.ones_like(rsm)]))

        def linearize_fn(xx, mu=1.0):
            """Closed-form normal equations: per-point analytic Jacobians
            w.r.t. each chain pose's right tangent, per-chain 6x6 Gram
            blocks, then the chain rule through the pose graph."""
            ec, pc = edge_corrs, plane_corrs
            T, Ex = chains(xx)
            (cq, re, we), (sq, rp, wp) = point_rows(T, mu)
            Je = factors.edge_point_jacobian(cq, ec).reshape(nq, nc_cur, 3, 6)
            Jp = factors.plane_point_jacobian(sq, pc).reshape(nq, ns_cur, 6)
            we_g = we.reshape(nq, nc_cur)
            re_g = re.reshape(nq, nc_cur, 3)
            wp_g = wp.reshape(nq, ns_cur)
            rp_g = rp.reshape(nq, ns_cur)
            G = (torch.einsum("qnka,qn,qnkb->qab", Je, we_g, Je)
                 + torch.einsum("qna,qn,qnb->qab", Jp, wp_g, Jp))
            bq = (torch.einsum("qnka,qn,qnk->qa", Je, we_g, re_g)
                  + torch.einsum("qna,qn->qa", Jp, wp_g * rp_g))

            # chain rule through the pose graph, closed form: for
            # T = Wp⁻¹∘Wf∘E under right perturbations,
            #   dδ_T/dδ_pivot = −Ad(T⁻¹), dδ_T/dδ_f = Ad(E⁻¹), dδ_T/dδ_E = I
            # (X∘Exp(v) = Exp(Ad_X v)∘X conjugation identities).
            A = torch.zeros((nq, 6, dim), device=dev)
            A[:, :, 0:6] = -se3.adjoint(se3.inverse(T))
            Ad_E = se3.adjoint(se3.inverse(Ex))
            eye6 = torch.eye(6, device=dev) if n_ext else None
            for qi, (f, l) in enumerate(q_ids):
                A[qi, :, f * 6:(f + 1) * 6] = Ad_E[qi]
                if n_ext and l >= 1:
                    col = (n_opt + l - 1) * 6
                    A[qi, :, col:col + 6] = eye6
            H = torch.einsum("qai,qab,qbj->ij", A, G, A)
            g = torch.einsum("qai,qa->i", A, bq)
            rsm, Jsm = small_linearization(xx)
            H = H + Jsm.T @ Jsm
            g = g + Jsm.T @ rsm
            cost = 0.5 * (torch.sum(we * torch.sum(re * re, -1))
                          + torch.sum(wp * rp * rp) + torch.sum(rsm * rsm))
            return H, g, cost

        if deg_P is None and analytic and oc.eig_threshold > 0:
            # the armed gate: linearize once here so the gate reads the
            # measurement Hessian, and hand the solver the linearization
            # and the projector (the identity unless the gate engages)
            init_lin = GN_linearize(
                None, retract, x, dim, quad_prior=(prior_delta, state.prior),
                linearize_fn=linearize_fn,
                mu=mu_sched(0) if mu_sched is not None else None)
            vals, vecs, vals_sh, vecs_sh = degeneracy.block_spectra(init_lin[3])
            v0 = vecs_sh[:, 0]
            below = vals_sh[0] < oc.eig_threshold
            consistent = torch.abs(torch.dot(v0, deg_dir)) > oc.eig_persist_cos
            # leaky persistence credit: +1 per consistent sub-threshold
            # sweep, 1 on a new direction, -3 (floored at 0) on a clear one
            deg_count = torch.where(
                below, torch.where(consistent, deg_count + 1, 1),
                torch.clamp(deg_count - 3, min=0)).to(torch.int32)
            deg_dir = torch.where(below, v0, deg_dir)
            engage = below & (deg_count >= oc.eig_persist_k)
            if oc.eig_snap_purity is not None:
                # freeze only a crisply canonical starved axis
                engage = engage & (torch.max(torch.abs(v0)) >= oc.eig_snap_purity)
            # support concentration: each correspondence's curvature along
            # v0, a_i = w_i (J_i·v0)², and n_eff = (Σa)²/Σa²
            (cq0, _), (sq0, _) = point_poses(chains(x)[0], nc_cur, ns_cur)
            a_p = plane_corrs.w * torch.square(
                factors.plane_point_jacobian(sq0, plane_corrs) @ v0)
            a_e = edge_corrs.w * torch.sum(torch.square(
                factors.edge_point_jacobian(cq0, edge_corrs) @ v0), -1)
            a = torch.cat([a_p, a_e])
            support_neff = torch.square(torch.sum(a)) / torch.clamp(
                torch.sum(a * a), min=1e-20)
            if oc.eig_support_neff is not None:
                engage = engage & (support_neff < oc.eig_support_neff)
            P_eng = degeneracy.projector_from_spectra(
                vals, vecs, vals_sh, vecs_sh, oc.eig_threshold,
                oc.remap_max_freeze, shared=oc.remap_shared,
                snap_purity=oc.eig_snap_purity)
            eye = torch.eye(6, dtype=P_eng.dtype, device=dev).expand(P_eng.shape)
            deg_P = torch.where(engage, P_eng, eye)
            spectra = (vals, vals_sh, v0)
        else:
            # later outer iterations keep the projector but linearize anew:
            # the solver reads the spectra off that linearization itself
            init_lin = spectra = None
        st = gauss_newton(
            None if analytic else residual_fn,
            x,
            retract,
            dim=dim,
            iters=eff_iters,
            remap_threshold=oc.eig_threshold if deg_P is None else None,
            remap_max_freeze=oc.remap_max_freeze,
            remap_shared=oc.remap_shared,
            remap_snap_purity=oc.eig_snap_purity,
            remap_P=deg_P,
            remap_spectra=spectra,
            init_linearization=init_lin,
            quad_prior=(prior_delta, state.prior),
            linearize_fn=linearize_fn if analytic else None,
            mu_schedule=mu_sched,
        )
        x = st.x
        result = st

    # re-linearize the anchor/prior rows at the solve's final accepted state
    # (result.x == result.H's linearization point) so marginalize_pivot can
    # subtract them exactly — see WindowSolveResult.H_anchor.
    rsm, Jsm = small_linearization(result.x)
    H_anchor = Jsm.T @ Jsm
    g_anchor = Jsm.T @ rsm
    val = state.prior.valid.to(torch.float32)
    Hq = state.prior.H * val
    g_prior = val * state.prior.b + Hq @ prior_delta(result.x)

    poses, ext = result.x
    solve = WindowSolveResult(
        H=result.H,
        g=result.g,
        cost=result.cost,
        n_corner=torch.sum(edge_corrs.w > 0),
        n_surf=torch.sum(plane_corrs.w > 0),
        eig_min=result.eig0[:, 0],
        H_anchor=H_anchor,
        g_anchor=g_anchor,
        eig_blocks=result.eig0,
        H_prior=Hq,
        g_prior=g_prior,
        frozen=result.frozen,
        eig_shared=result.eig_shared,
        weak_dir=result.weak_dir,
        remap_P=deg_P,
        support_neff=support_neff,
    )
    return state._replace(poses=poses, ext=ext, deg_dir=deg_dir,
                          deg_count=deg_count), solve


def marginalize_pivot(state: WindowState, solve: WindowSolveResult,
                      cfg: MloamConfig, calibrate_ext: bool = False) -> WindowState:
    """Schur-eliminate the pivot block of the final (H, g) into a prior over
    the remaining opt poses (+ extrinsics in calibration mode); re-linearize
    at the current estimates. The new frame pushed next step enters with a
    zero prior block.

    Armed (``eig_threshold > 0`` with ``remap_project_prior``, outside
    calibration): degeneracy-consistent marginalization. The measurement part
    of (H, g) is projected with the projector the solve applied
    (``solve.remap_P``, or ``block_projector`` of it when the gate did not
    build one) and the inherited prior part passes through untouched, so the
    prior stores only the measurements the solve accepted."""
    oc = cfg.odometry
    O = oc.opt_window_size
    dim = prior_dim(cfg, calibrate_ext)
    dev = solve.H.device
    # marginalize only the factor blocks + old prior: the per-solve gauge
    # anchor (and calibration extrinsic prior) rows are re-added fresh every
    # solve and must not be re-baked into the prior (see
    # WindowSolveResult.H_anchor)
    H_in = solve.H - solve.H_anchor
    g_in = solve.g - solve.g_anchor
    if (oc.eig_threshold > 0 and oc.remap_project_prior
            and solve.H_prior is not None and not calibrate_ext):
        Hm = H_in - solve.H_prior
        gm = g_in - solve.g_prior
        P = solve.remap_P
        if P is None:
            P, _ = degeneracy.block_projector(Hm, oc.eig_threshold,
                                              oc.remap_max_freeze,
                                              shared=oc.remap_shared,
                                              snap_purity=oc.eig_snap_purity)
        n = P.shape[0]
        Hm = torch.einsum("aij,ajbl,bkl->aibk", P, Hm.reshape(n, 6, n, 6),
                          P).reshape(n * 6, n * 6)
        gm = torch.einsum("aij,aj->ai", P, gm.reshape(n, 6)).reshape(-1)
        H_in = Hm + solve.H_prior
        g_in = gm + solve.g_prior
    small = schur_marginalize_quad(H_in, g_in, n_drop=6)
    # retained layout after the slide: [poses 0..O-1 | ext...], new pose
    # block O is zero. Old retained layout: [poses 1..O | ext...]: the
    # extrinsic blocks shift past the zero new-pose block.
    k = O * 6
    Hp = torch.zeros((dim, dim), device=dev)
    b = torch.zeros((dim,), device=dev)
    if dim == k + 6:   # poses only
        Hp[:k, :k] = small.H
        b[:k] = small.b
    else:
        new_idx = torch.cat([torch.arange(k, device=dev),
                             torch.arange(k + 6, dim, device=dev)])
        Hp[new_idx[:, None], new_idx[None, :]] = small.H
        b[new_idx] = small.b
    return state._replace(
        prior=QuadPrior(H=Hp, b=b, valid=small.valid),
        # clones: the window is rolled and written in place on the next
        # push, the linearization points must not move with it
        prior_poses=_tmap(torch.clone, state.poses),
        prior_ext=_tmap(torch.clone, state.ext),
    )


def drop_prior(state: WindowState, cfg: MloamConfig) -> WindowState:
    """Discard the marginalization prior."""
    dim = (cfg.odometry.opt_window_size + 1) * 6
    return state._replace(
        prior=QuadPrior.empty(dim, device=state.poses.q.device))
