"""Loop-closure pose graph: keyframe store, scan-context detection,
geometric verification and pose-graph optimization.

Counterpart of ``mloam_tpu/loop/posegraph.py`` (the reference's
``PoseGraph``): detection with the loop-distance gate -> verification by
registering the query keyframe against the candidate's local map ->
optimization over all keyframes with sequential and loop edges, the drift
carried on to keyframes added after a correction.

Fixed capacities with masks throughout. ``add_keyframe`` and ``record_loop``
write their one slot in place under ``torch.where`` (the JAX package selects
over the whole arrays): hand each ``LoopGraphState`` to them once.
``try_close_loop`` is one straight run of device ops with no host read: it
computes the detection, the pose-seeded registration and, with
``use_global_reg``, the correlation-seeded one whatever the detection found,
and selects with ``torch.where``, as the JAX package's one device program
does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mloam_tpu_torch.config import LoopConfig, MloamConfig
from mloam_tpu_torch.core import se3
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.frontend.features import FeatCloud
from mloam_tpu_torch.loop import global_registration as GREG
from mloam_tpu_torch.loop import registration as REG
from mloam_tpu_torch.loop import scancontext as SC
from mloam_tpu_torch.mapping.keyframes import write_slot
from mloam_tpu_torch.parallel import sharded_pgo as PG
from mloam_tpu_torch.solver.gauss_newton import tree_where


class LoopGraphState(NamedTuple):
    """Fixed-capacity keyframe graph."""

    poses: Pose           # [K] current (possibly PGO-corrected) poses
    odom_poses: Pose      # [K] poses as first received (for odometry edges)
    corner: FeatCloud     # [K, Nc] keyframe corner clouds (base frame)
    surf: FeatCloud       # [K, Ns]
    sc_db: SC.ScanContextDB
    valid: torch.Tensor   # [K]
    count: torch.Tensor   # scalar int32 (== number of keyframes, no ring)
    # loop edges (padded)
    loop_i: torch.Tensor  # [E]
    loop_j: torch.Tensor  # [E]
    loop_zq: torch.Tensor  # [E, 4]
    loop_zt: torch.Tensor  # [E, 3]
    loop_valid: torch.Tensor  # [E]
    n_loops: torch.Tensor  # scalar int32


def init_state(capacity: int, cap_corner: int, cap_surf: int, cfg: LoopConfig,
               max_loops: int | None = None, device=None) -> LoopGraphState:
    if max_loops is None:
        max_loops = cfg.max_loop_edges

    def stack(n):
        return FeatCloud(*(x.expand((capacity,) + x.shape).clone()
                           for x in FeatCloud.zeros(n, device=device)))

    return LoopGraphState(
        poses=Pose.identity((capacity,), device=device),
        odom_poses=Pose.identity((capacity,), device=device),
        corner=stack(cap_corner),
        surf=stack(cap_surf),
        sc_db=SC.empty_db(capacity, cfg, device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        loop_i=torch.zeros((max_loops,), dtype=torch.int32, device=device),
        loop_j=torch.zeros((max_loops,), dtype=torch.int32, device=device),
        loop_zq=Pose.identity((max_loops,), device=device).q,
        loop_zt=torch.zeros((max_loops, 3), device=device),
        loop_valid=torch.zeros((max_loops,), dtype=torch.bool, device=device),
        n_loops=torch.zeros((), dtype=torch.int32, device=device),
    )


def _pose_at(p: Pose, i: torch.Tensor) -> Pose:
    """Pose ``i`` of a stack, for a device index (a 0-dim index would be
    read on the host)."""
    i = i.to(torch.int64).reshape(1)
    return Pose(p.q.index_select(0, i)[0], p.t.index_select(0, i)[0])


def add_keyframe(state: LoopGraphState, pose: Pose, corner: FeatCloud,
                 surf: FeatCloud, cfg: LoopConfig) -> LoopGraphState:
    """Append a keyframe. At capacity the new keyframe is dropped whole: no
    slot is overwritten, ``count`` stops.

    ``poses`` holds the PGO-corrected trajectory; an incoming pose is in
    the odometry frame, so it enters with the current drift correction
    T_drift = poses[last] ∘ odom_poses[last]⁻¹ (otherwise every keyframe
    added after a correction re-enters uncorrected)."""
    k = state.valid.shape[0]
    ok = state.count < k
    i = torch.clamp(state.count, max=k - 1).to(torch.int64).reshape(1)
    last = torch.clamp(state.count - 1, min=0)
    drift = se3.compose(_pose_at(state.poses, last),
                        se3.inverse(_pose_at(state.odom_poses, last)))
    pose_corr = tree_where(state.count > 0, se3.compose(drift, pose), pose)
    desc = SC.make_descriptor(torch.cat([corner.xyz, surf.xyz]),
                              torch.cat([corner.mask, surf.mask]), cfg)
    pairs = [(state.poses.q, pose_corr.q), (state.poses.t, pose_corr.t),
             (state.odom_poses.q, pose.q), (state.odom_poses.t, pose.t)]
    pairs += list(zip(state.corner, corner)) + list(zip(state.surf, surf))
    for ring, new in pairs:
        write_slot(ring, i, new, ok)
    write_slot(state.valid, i, torch.ones((), dtype=torch.bool, device=i.device), ok)
    return state._replace(sc_db=SC.add(state.sc_db, desc, where=ok),
                          count=state.count + ok.to(torch.int32))


def _local_map(state: LoopGraphState, center_idx, half: int, n_kf: int,
               stack: FeatCloud, into_frame: Pose):
    """Stack the ±``half`` neighbour keyframes' clouds into ``into_frame``
    coordinates (the reference's constructLocalMap); fixed gather size.
    ``center_idx`` is a host int or a device scalar."""
    offs = torch.arange(-half, half + 1, device=stack.xyz.device)
    ids = torch.clamp(center_idx + offs, 0, n_kf - 1)
    rel = se3.compose(se3.inverse(Pose(into_frame.q[None], into_frame.t[None])),
                      Pose(state.poses.q[ids], state.poses.t[ids]))
    xyz = se3.transform_points(rel, stack.xyz[ids])
    mask = stack.mask[ids] & state.valid[ids][:, None]
    return xyz.reshape(-1, 3), mask.reshape(-1)


def try_close_loop(state: LoopGraphState, query_idx: int, lcfg: LoopConfig,
                   cfg: MloamConfig, use_global_reg: bool = False):
    """Detection + geometric verification for keyframe ``query_idx`` (a
    host int: the caller's mirror of the keyframe count).

    ``use_global_reg``: also seed the fine registration from the priorless
    correlation registration and take whichever seed verifies (the better
    cost when both do) — for loops whose odometry drift exceeds the
    pose-seeded basin.

    Returns (found, cand_idx, z_q, z_t, sc_dist, RegistrationResult) with
    Z = T_cand⁻¹ T_query."""
    k = state.valid.shape[0]
    cand = SC.detect(state.sc_db, state.sc_db.desc[query_idx], lcfg,
                     exclude_after=state.count - lcfg.num_exclude_recent)
    q_pose = Pose(state.poses.q[query_idx], state.poses.t[query_idx])
    c_pose = _pose_at(state.poses, cand.index)
    near = torch.linalg.norm(q_pose.t - c_pose.t) < lcfg.loop_distance_threshold
    candidate_ok = cand.found & near & (cand.index != query_idx)

    # the candidate's local map is kept small: stacking many neighbours at
    # their drifted estimates blurs the target and biases the loop edge by
    # the very drift the loop is meant to fix
    half = min(lcfg.history_search_num, 3)
    tc_xyz, tc_mask = _local_map(state, cand.index, half, k, state.corner, c_pose)
    ts_xyz, ts_mask = _local_map(state, cand.index, half, k, state.surf, c_pose)
    q_corner = FeatCloud(*(a[query_idx] for a in state.corner))
    q_surf = FeatCloud(*(a[query_idx] for a in state.surf))

    T0 = REG.coarse_align(q_surf.xyz, q_surf.mask, ts_xyz, ts_mask, -cand.yaw)
    # the translation seed from the current pose estimates
    T_odo = se3.compose(se3.inverse(c_pose), q_pose)
    reg = REG.fine_register(q_corner, q_surf, tc_xyz, tc_mask, ts_xyz, ts_mask,
                            Pose(T0.q, T_odo.t), cfg)
    if use_global_reg:
        qm_xyz, qm_mask = _local_map(state, query_idx, half, k, state.surf, q_pose)
        gres = GREG.register_correlation(qm_xyz, qm_mask, ts_xyz, ts_mask)
        reg2 = REG.fine_register(q_corner, q_surf, tc_xyz, tc_mask, ts_xyz,
                                 ts_mask, gres.pose, cfg)
        take2 = (reg2.ok & ~reg.ok) | (reg2.ok & reg.ok & (reg2.cost < reg.cost))
        reg = tree_where(take2, reg2, reg)
    found = candidate_ok & reg.ok
    return found, cand.index, reg.pose.q, reg.pose.t, cand.dist, reg


def _device_value(x, dtype, device) -> torch.Tensor:
    """A device scalar of ``x``: a tensor as it is, a host value by a fill
    (no copy from pageable host memory, which would wait for the stream)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.full((), x, dtype=dtype, device=device)


def record_loop(state: LoopGraphState, found, i, j, zq, zt) -> LoopGraphState:
    """Append an accepted loop edge (i = candidate / earlier keyframe,
    j = query). At capacity new edges are dropped, never overwriting a
    recorded one. ``found``, ``i`` and ``j`` are device scalars or host
    values."""
    dev = state.loop_valid.device
    e = state.loop_valid.shape[0]
    found = _device_value(found, torch.bool, dev) & (state.n_loops < e)
    s = torch.clamp(state.n_loops, max=e - 1).to(torch.int64).reshape(1)
    for arr, v in ((state.loop_i, _device_value(i, torch.int32, dev)),
                   (state.loop_j, _device_value(j, torch.int32, dev)),
                   (state.loop_zq, zq), (state.loop_zt, zt),
                   (state.loop_valid, torch.ones((), dtype=torch.bool, device=dev))):
        write_slot(arr, s, v, found)
    return state._replace(n_loops=state.n_loops + found.to(torch.int32))


def build_edges(state: LoopGraphState, seq_weight: float = 1.0,
                loop_weight: float = 5.0) -> PG.PoseGraphEdges:
    """Sequential odometry edges (from the received poses) + loop edges;
    edges between invalid keyframes and unused loop slots weigh 0."""
    k = state.valid.shape[0]
    dev = state.valid.device
    seq_i = torch.arange(k - 1, dtype=torch.int64, device=dev)
    op = state.odom_poses
    rel = se3.relative(Pose(op.q[:-1], op.t[:-1]), Pose(op.q[1:], op.t[1:]))
    seq_ok = (state.valid[:-1] & state.valid[1:]).to(torch.float32)
    loop_ok = state.loop_valid.to(torch.float32)
    return PG.PoseGraphEdges(
        i=torch.cat([seq_i, state.loop_i.to(torch.int64)]),
        j=torch.cat([seq_i + 1, state.loop_j.to(torch.int64)]),
        z_q=torch.cat([rel.q, state.loop_zq]),
        z_t=torch.cat([rel.t, state.loop_zt]),
        weight=torch.cat([(seq_weight * seq_ok)[:, None].expand(k - 1, 6),
                          (loop_weight * loop_ok)[:, None].expand(-1, 6)]),
    )


def optimize(state: LoopGraphState, iters: int = 10, mesh=None,
             dof4: bool = False) -> LoopGraphState:
    """Run PGO over all keyframes, the first anchored; invalid slots keep
    their poses."""
    new = PG.optimize_pose_graph(state.poses, build_edges(state), iters=iters,
                                 anchor_idx=0, mesh=mesh, dof4=dof4)
    keep = state.valid[:, None]
    return state._replace(poses=Pose(torch.where(keep, new.q, state.poses.q),
                                     torch.where(keep, new.t, state.poses.t)))
