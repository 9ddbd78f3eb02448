"""Uncertainty-aware keyframe mapping backend (scan-to-map refinement).

Counterpart of ``mloam_tpu/mapping/mapper.py`` (the reference's
``lidar_mapper_keyframe.cpp`` process loop): odometry-to-map association,
surround-keyframe map assembly with covariance compounding, uncertainty-gated
downsampling of the current scan, two-round scan-to-map Gauss-Newton with
covariance-weighted factors, optional good-feature selection and degeneracy
remapping, pose covariance = H⁻¹, and motion-gated keyframe insertion.

The JAX package runs one jitted program per step with two ``lax.cond``s.
Eager PyTorch has no such conditional, and evaluating both arms and selecting
would run the expensive one every step, so:

  * whether there is a map to match against is known on the host: the first
    mapper step always inserts a keyframe (``last_kf_pose`` starts 1e6 m
    away) and the ring never empties, so it is ``state.step > 0``, a host
    counter;
  * whether the cached surround map is stale depends on the device pose and
    on last step's insertion: it is read with ONE device-to-host read of a
    single bool per step (``refresh_surround``; counted in
    ``stale_reads``). No other value of the step is read on the host.

Keyframe insertion writes the ring's slot ``head % K`` alone, in place, under
``torch.where`` (``keyframes.insert``), where the JAX package selects over
the whole ring. The ``rnd`` feature selection draws from a
``torch.Generator`` seeded from (17, step).

``torch.linalg.eigh`` on a CUDA tensor waits for the device to report its
solver status, so the step also synchronises (without reading a value) at
each ``eigh``: the final covariance, the armed gate's, and the projector and
spectra the Gauss-Newton solve builds when given a remap threshold.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mloam_tpu_torch.config import MloamConfig
from mloam_tpu_torch.core import se3, uncertainty
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.frontend.features import FeatCloud
from mloam_tpu_torch.mapping import keyframes as KF
from mloam_tpu_torch.ops import select, voxel
from mloam_tpu_torch.solver import degeneracy, factors, robust
from mloam_tpu_torch.solver import feature_selection as FS
from mloam_tpu_torch.solver.gauss_newton import gauss_newton, tree_where

stale_reads = 0  # device-to-host reads of the surround map's staleness


class SurroundMap(NamedTuple):
    """Cached assembled surround map (fixed caps, world frame).

    Keyframe poses never change between insertions, so the assembled
    world-frame map is exactly reusable: it is rebuilt only when a keyframe
    was inserted or the sensor moved beyond ``surround_rebuild_dist`` from
    the assembly center.
    """

    c_xyz: torch.Tensor    # [capC, 3]
    c_mask: torch.Tensor   # [capC]
    s_xyz: torch.Tensor    # [capS, 3]
    s_mask: torch.Tensor   # [capS]
    center: torch.Tensor   # [3] assembly center (world)
    head: torch.Tensor     # db.head at assembly time
    valid: torch.Tensor    # scalar bool


class MapperState(NamedTuple):
    db: KF.KeyframeDB
    pose_map_odom: Pose   # map <- odom drift correction
    last_kf_pose: Pose
    # [L, 6, 6] per-lidar extrinsic covariance (the reference's COV_EXT):
    # config priors at init, the calibrated covariance after the 1->0 freeze
    ext_cov: torch.Tensor
    cov_meas: torch.Tensor  # [3, 3] measurement covariance
    cache: SurroundMap
    step: int             # mapping-step counter, on the host
    deg_dir: torch.Tensor  # [6] degeneracy persistence state
    deg_count: torch.Tensor  # scalar int32


class MapperOutput(NamedTuple):
    pose: Pose            # map <- base refined
    cov: torch.Tensor     # [6, 6] pose covariance (H^-1)
    cost: torch.Tensor
    n_corner: torch.Tensor
    n_surf: torch.Tensor
    eig_min: torch.Tensor
    inserted_kf: torch.Tensor  # device bool
    # directions frozen by the applied projector (trace deficit)
    frozen: torch.Tensor
    stale: bool = False   # the surround map was rebuilt this step (host)


def uncertainty_sqrt_info(trace: torch.Tensor) -> torch.Tensor:
    """Normalized/clamped covariance-driven factor weight: s = sqrt(1/trace),
    weight 1 while s >= 3 (trace <= 1/9), s/3 beyond. NaN/invalid traces map
    to a large trace (weight -> ~0). Kept as the JAX package states it,
    including its deviation from the reference's unclamped weight."""
    tr = torch.clamp(torch.nan_to_num(trace, nan=1e6, posinf=1e6), min=1e-12)
    s = torch.sqrt(1.0 / tr)
    return torch.where(s >= 3.0, 1.0, s / 3.0)


def default_ext_cov(cfg: MloamConfig, device=None) -> torch.Tensor:
    """[L, 6, 6] prior extrinsic covariance: zeros for the reference lidar,
    the configured uct_ext diagonal (scaled by uct_ext_ratio) for the rest."""
    L = cfg.rig.n_lidars
    mc = cfg.mapping
    ec = torch.zeros((L, 6, 6), device=device)
    if mc.ext_cov_prior_diag is not None and L > 1:
        d = torch.diag(torch.tensor(mc.ext_cov_prior_diag, dtype=torch.float32,
                                    device=device))
        ec[1:] = mc.uct_ext_ratio * d
    return ec


def _point_cov(xyz: torch.Tensor, pose: Pose, base_cov: torch.Tensor,
               ext_cov: torch.Tensor, cov_meas: torch.Tensor) -> torch.Tensor:
    """Per-point 3x3 covariance pushforward with PER-LIDAR extrinsic
    covariance. Clouds are the per-lidar features concatenated in lidar order
    with equal segments (``FullPipeline._merge``), so segment l gets pose
    covariance ``base_cov + ext_cov[l]``; the lidar-mean extrinsic covariance
    when the cloud is not an even concatenation. Batched: ``xyz`` [..., n, 3]
    with ``pose`` and ``base_cov`` of batch shape [...]."""
    L = ext_cov.shape[0]
    n = xyz.shape[-2]
    if L == 1 or n % L != 0:
        cov6 = base_cov + torch.mean(ext_cov, dim=0)
        return uncertainty.point_cov_pushforward(xyz, pose, cov6, cov_meas)
    lead = xyz.shape[:-2]
    per = uncertainty.point_cov_pushforward(
        xyz.reshape(lead + (L, n // L, 3)),
        Pose(pose.q[..., None, :], pose.t[..., None, :]),
        base_cov[..., None, :, :] + ext_cov, cov_meas)
    return per.reshape(lead + (n, 3, 3))


def init_state(cfg: MloamConfig, device=None) -> MapperState:
    mc = cfg.mapping
    # keyframe clouds are the per-sweep features merged over all lidars
    L = cfg.rig.n_lidars
    db = KF.empty_db(mc.max_keyframes, L * cfg.odometry.cap_frame_corner,
                     L * cfg.odometry.cap_frame_surf, L * mc.cap_frame_outlier,
                     device=device)

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return MapperState(
        db=db,
        pose_map_odom=Pose.identity(device=device),
        last_kf_pose=Pose(torch.tensor([1.0, 0, 0, 0], device=device),
                          torch.full((3,), 1e6, device=device)),  # force first keyframe
        ext_cov=default_ext_cov(cfg, device),
        cov_meas=1e-4 * torch.eye(3, device=device),
        cache=SurroundMap(
            c_xyz=z(mc.cap_map_corner, 3), c_mask=z(mc.cap_map_corner, dtype=torch.bool),
            s_xyz=z(mc.cap_map_surf, 3), s_mask=z(mc.cap_map_surf, dtype=torch.bool),
            center=z(3),
            head=torch.tensor(-1, dtype=torch.int32, device=device),
            valid=torch.tensor(False, device=device)),
        step=0,
        deg_dir=z(6),
        deg_count=torch.tensor(0, dtype=torch.int32, device=device),
    )


def _assemble_map(state: MapperState, center: torch.Tensor, cfg: MloamConfig,
                  n_surround: int = 50):
    """Surround-keyframe gather -> world-frame cov-clouds -> uncertainty-
    weighted voxel filter. Returns (c_xyz, c_cov, c_mask, s_xyz, s_cov, s_mask)."""
    mc = cfg.mapping
    idx, ok = KF.surrounding(state.db, center, mc.surround_radius, n_surround)
    kf_pose = Pose(state.db.poses.q[idx], state.db.poses.t[idx])   # [M]
    cov_pose = state.db.cov[idx]                                    # [M, 6, 6]

    def project(stack: FeatCloud, leaf: float, precap: int | None):
        xyz = stack.xyz[idx]                                        # [M, N, 3]
        flat_xyz = se3.transform_points(kf_pose, xyz).reshape(-1, 3)
        flat_cov = _point_cov(xyz, kf_pose, cov_pose, state.ext_cov,
                              state.cov_meas).reshape(-1, 3, 3)
        flat_m = (stack.mask[idx] & ok[:, None]).reshape(-1)
        # sort-free compaction before the voxel sort: the stacked keyframe
        # clouds are mostly padding. Exact when the valid count fits the
        # bound; even-stride subsample otherwise.
        if precap is not None and precap < flat_xyz.shape[0]:
            packed = torch.cat([flat_xyz, flat_cov.reshape(-1, 9)], -1)
            packed, flat_m = select.compact_stride(packed, flat_m, precap)
            flat_xyz = packed[:, :3]
            flat_cov = packed[:, 3:].reshape(-1, 3, 3)
        # packed single-key sort: the surround map spans <= 2*radius, well
        # inside the 1024-cell packed grid
        ds_xyz, ds_cov, ds_m, _ = voxel.voxel_downsample_with_cov(
            flat_xyz, flat_cov, flat_m, leaf, mc.voxel_trace_threshold,
            packed=True)
        return ds_xyz, ds_cov, ds_m

    L = cfg.rig.n_lidars
    pc = mc.surround_precap_corner * L if mc.surround_precap_corner is not None else None
    ps = mc.surround_precap_surf * L if mc.surround_precap_surf is not None else None
    c_xyz, c_cov, c_m = project(state.db.corner, mc.corner_leaf, pc)
    s_xyz, s_cov, s_m = project(state.db.surf, mc.surf_leaf, ps)
    return c_xyz, c_cov, c_m, s_xyz, s_cov, s_m


def refresh_surround(state: MapperState, center: torch.Tensor,
                     cfg: MloamConfig) -> tuple[SurroundMap, bool]:
    """(fresh or reused SurroundMap, whether it was rebuilt). Rebuilds (the
    expensive assembly) only when stale: a keyframe was inserted since
    assembly, or the sensor moved > surround_rebuild_dist from the assembly
    center. The staleness is the step's one host read."""
    global stale_reads
    mc = cfg.mapping
    cache = state.cache
    moved = torch.sum((center - cache.center) ** 2) > mc.surround_rebuild_dist ** 2
    stale = bool((~cache.valid) | (cache.head != state.db.head) | moved)
    stale_reads += 1
    if not stale:
        return cache, False
    c_xyz, _c_cov, c_m, s_xyz, _s_cov, s_m = _assemble_map(state, center, cfg)
    # compact to the fixed map caps (even-stride subsample if ever over-full)
    c2, cm2 = select.compact_stride(c_xyz, c_m, mc.cap_map_corner)
    s2, sm2 = select.compact_stride(s_xyz, s_m, mc.cap_map_surf)
    return SurroundMap(c2, cm2, s2, sm2, center, state.db.head.clone(),
                       torch.ones((), dtype=torch.bool, device=center.device)), True


def _select_features(pc, ec, pose: Pose, state: MapperState, cfg: MloamConfig):
    """Good-feature selection of the configured method (the JAX package's
    ``scan_to_map`` branch on ``gf_method``)."""
    mc = cfg.mapping
    if mc.gf_method == "gd_float":
        # budget-adaptive ratio: the full-Hessian logdet of all matched
        # features picks the aggressive or the degraded keep ratio
        Jp = FS.plane_jacobian_blocks(pc, pose)
        Je = FS.edge_jacobian_blocks(ec, pose)
        vp = (pc.w > 0).to(Jp.dtype)
        ve = (ec.w > 0).to(Je.dtype)
        Hfull = (torch.einsum("n,ni,nj->ij", vp, Jp, Jp)
                 + torch.einsum("n,nai,naj->ij", ve, Je, Je)
                 + 1e-6 * torch.eye(6, dtype=Jp.dtype, device=Jp.device))
        _, ld = torch.linalg.slogdet(Hfull)
        ratio = torch.where(ld > mc.map_deg_threshold, mc.gf_ratio,
                            mc.gf_ratio_degraded)
        keep_p, keep_e = FS.logdet_gain_select(
            Jp, pc.w, Je, ec.w, ratio,
            max_ratio=max(mc.gf_ratio, mc.gf_ratio_degraded))
        return FS.apply_masks(pc, ec, keep_p, keep_e)
    if mc.gf_method != "full" and mc.gf_ratio < 1.0:
        # the step folds into the seed so the 'rnd' mask differs every step
        gen = None
        if mc.gf_method == "rnd":
            gen = torch.Generator(device=pose.q.device)
            gen.manual_seed((17 << 32) | state.step)
        return FS.apply_selection(pc, ec, pose, mc.gf_method, mc.gf_ratio,
                                  generator=gen)
    return pc, ec


def scan_to_map(state: MapperState, pose_pred: Pose, corner: FeatCloud,
                surf: FeatCloud, cfg: MloamConfig, smap: SurroundMap):
    """Refine pose_pred against the surround map. corner/surf in base frame.

    Returns (pose, cov, cost, n_corner, n_surf, eig_min, frozen, deg_dir,
    deg_count)."""
    mc = cfg.mapping
    dev = pose_pred.q.device

    # current-scan uncertainty gate (downsampleCurrentScan :356-421)
    def gate(fc: FeatCloud):
        cov_pt = _point_cov(fc.xyz, Pose.identity(device=dev),
                            torch.zeros((6, 6), device=dev), state.ext_cov,
                            state.cov_meas)
        tr = torch.diagonal(cov_pt, dim1=-2, dim2=-1).sum(-1)
        return fc._replace(mask=fc.mask & (tr < mc.trace_threshold)), tr

    corner, corner_tr = gate(corner)
    surf, surf_tr = gate(surf)

    pose = pose_pred
    result = ec = pc = deg_P = None
    deg_dir, deg_count = state.deg_dir, state.deg_count
    gnc = mc.loss_mode == "gnc_gm"
    eff_iters = max(mc.gn_iters, 8) if gnc else mc.gn_iters
    mu_sched = robust.gnc_mu_schedule(mc.gnc_mu_init, eff_iters + 1) if gnc else None
    for _ in range(mc.outer_iters):
        ec = factors.match_map_edge(corner, se3.transform_points(pose, corner.xyz),
                                    smap.c_xyz, smap.c_mask,
                                    cfg.odometry.dist_sq_threshold)
        pc = factors.match_map_plane(surf, se3.transform_points(pose, surf.xyz),
                                     smap.s_xyz, smap.s_mask,
                                     cfg.odometry.dist_sq_threshold)
        # covariance-aware weights in both feature classes
        pc = pc._replace(w=pc.w * uncertainty_sqrt_info(surf_tr))
        ec = ec._replace(w=ec.w * uncertainty_sqrt_info(corner_tr))
        pc, ec = _select_features(pc, ec, pose, state, cfg)
        linearize_fn = factors.pose_normal_equations(ec, pc, mc.loss_mode,
                                                     mc.huber_delta, gm_c=mc.gm_c)

        init_lin = None
        if deg_P is None and mc.eig_threshold > 0:
            # ARMED gate: persistence-gated mapper remap (MAP_EIG_THRE),
            # linearized once here; the projector built in the first outer
            # iteration serves both
            H0, g0, c0 = (linearize_fn(pose) if mu_sched is None
                          else linearize_fn(pose, mu_sched(0)))
            init_lin = (H0, g0, c0, H0)
            vals, vecs = torch.linalg.eigh(H0)
            below = vals[0] < mc.eig_threshold
            consistent = torch.abs(torch.dot(vecs[:, 0], state.deg_dir)) \
                > mc.eig_persist_cos
            # leaky persistence credit (see the estimator's gate)
            deg_count = torch.where(
                below, torch.where(consistent, state.deg_count + 1, 1),
                torch.clamp(state.deg_count - 3, min=0)).to(torch.int32)
            deg_dir = torch.where(below, vecs[:, 0], state.deg_dir)
            engage = below & (deg_count >= mc.eig_persist_k)
            if mc.eig_snap_purity is not None:
                engage = engage & (torch.max(torch.abs(vecs[:, 0]))
                                   >= mc.eig_snap_purity)
            P_eng, _ = degeneracy.block_projector(
                H0, mc.eig_threshold, mc.remap_max_freeze,
                snap_purity=mc.eig_snap_purity)
            deg_P = torch.where(engage, P_eng,
                                torch.eye(6, dtype=P_eng.dtype, device=dev).expand_as(P_eng))
        result = gauss_newton(
            None, pose, se3.boxplus, dim=6, iters=eff_iters,
            # disarmed: threshold 0.0 still populates the eig diagnostics
            # (freezes nothing); armed: the gated projector applies
            remap_threshold=mc.eig_threshold if deg_P is None else None,
            remap_max_freeze=mc.remap_max_freeze,
            remap_snap_purity=mc.eig_snap_purity,
            remap_P=deg_P, init_linearization=init_lin,
            linearize_fn=linearize_fn, mu_schedule=mu_sched)
        pose = result.x

    vals, vecs = torch.linalg.eigh(result.H)
    inv_vals = torch.where(vals > 1e-6, 1.0 / torch.clamp(vals, min=1e-6), 1e6)
    cov = (vecs * inv_vals[None, :]) @ vecs.T
    return (pose, cov, result.cost, torch.sum(ec.w > 0), torch.sum(pc.w > 0),
            result.eig0[0, 0], result.frozen[0], deg_dir, deg_count)


def mapper_step(state: MapperState, odom_pose: Pose, corner: FeatCloud,
                surf: FeatCloud, cfg: MloamConfig,
                outlier: FeatCloud | None = None) -> tuple[MapperState, MapperOutput]:
    """One mapping update. ``odom_pose`` is the odometry-frame pose;
    corner/surf are the current sweep's features in the base frame (merged
    over lidars through their extrinsics). ``outlier`` (optional, same frame)
    is stored into the keyframe for map completeness, never matched.

    The keyframe ring of ``state`` is written in place (``keyframes.insert``):
    hand each state to this function once."""
    mc = cfg.mapping
    dev = odom_pose.q.device
    pose_pred = se3.compose(state.pose_map_odom, odom_pose)
    smap, stale = refresh_surround(state, pose_pred.t, cfg)
    state = state._replace(cache=smap)
    if state.step > 0:   # has_map: see the module note
        (pose, cov, cost, nc, ns, eig, frozen, deg_dir,
         deg_count) = scan_to_map(state, pose_pred, corner, surf, cfg, smap)
    else:
        zero = torch.zeros((), device=dev)
        zero_i = torch.zeros((), dtype=torch.int64, device=dev)
        pose, cov, cost, nc, ns, eig, frozen = (
            pose_pred, torch.eye(6, device=dev) * 1e-2, zero, zero_i, zero_i,
            zero, zero)
        deg_dir, deg_count = state.deg_dir, state.deg_count

    # drift correction update (transformUpdate :154)
    pose_map_odom = se3.compose(pose, se3.inverse(odom_pose))
    ins = KF.should_insert(pose, state.last_kf_pose, mc.keyframe_dist,
                           mc.keyframe_angle_deg)
    db = KF.insert(state.db, pose, cov, corner, surf, outlier, where=ins)
    new_state = state._replace(
        db=db, pose_map_odom=pose_map_odom,
        last_kf_pose=tree_where(ins, pose, state.last_kf_pose),
        step=state.step + 1, deg_dir=deg_dir, deg_count=deg_count)
    out = MapperOutput(pose=pose, cov=cov, cost=cost, n_corner=nc, n_surf=ns,
                       eig_min=eig, inserted_kf=ins, frozen=frozen, stale=stale)
    return new_state, out
