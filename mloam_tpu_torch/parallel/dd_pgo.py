"""Nested-dissection pose-sharded PGO/BA: the communication-avoiding
distributed solver.

Counterpart of ``mloam_tpu/parallel/dd_pgo.py`` (the reference's PGO thread,
``mloam_loop/src/pose_graph.cpp:491-653``, as a distributed solver). The
*poses* are sharded, not only the edges:

  * Each shard owns a contiguous trajectory block. Poses whose edges never
    leave the shard are *interior*; poses touched by a cross-shard edge (or
    the anchor) are *separators*: a small set.
  * Per GN iteration each shard linearizes its own edges (+ its poses'
    scan-to-map point factors, re-associated in-step against its map shard)
    and assembles a local dense Hessian over [its interiors | its host's
    intra separators | global separators], then eliminates its interiors
    (one batched Cholesky and triangular solves).
  * One reduction of the separator system per GN iteration. On a 2-D (host,
    factor) mesh the reduction is two-level: the [intra | global] system is
    reduced over the chip axis within a host, each host eliminates its intra
    separators, and only the global system is reduced across hosts.
  * The small separator solve closes the step (once for all shards);
    interiors back-substitute locally.

The step is algebraically the dense single-device damped GN step
(``sharded_pgo.pgo_step``): block elimination of a damped SPD system is a
reordered factorization. Written once against ``parallel/mesh.py``: on a
stacked mesh every shard's tensors carry the mesh axes in front, in a process
mesh each rank's carry them at size 1. A non-positive-definite block gives
NaN (``cholesky_ex``), as the JAX package's Cholesky does.

Every float scatter onto poses or local slots is ``ops/segsum.index_sum``
(each shard with its own fixed-point scale). The local Hessian is summed
straight into its 6x6 blocks: an int64 accumulator of (local blocks)^2 x 36
per shard (11.9 MB a shard at 1024 poses over 8 shards, 0.1 GB at 4096).
The separator reductions are float sums (``mesh.psum``), in the order of
the mesh's sum (a stacked mesh: one ``torch.sum`` over the shard axes).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mloam_tpu_torch.core import rotations as rot
from mloam_tpu_torch.core import se3
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.ops.segsum import index_sum
from mloam_tpu_torch.parallel.mesh import data_axes
from mloam_tpu_torch.parallel.sharded_pgo import (
    PoseGraphEdges,
    _linearize_sparse,
    boxplus_dof4,
)


class DDPartition(NamedTuple):
    """Static partition of a pose graph for the nested-dissection solve.

    Built on the host (numpy) from the edge list. All arrays are padded to
    static shapes; masks mark live entries. P = number of shards, H = number
    of hosts (level-2 groups; 1 = flat). The global separator slot table is
    [host0-intra | ... | hostH-1-intra | global] with SI intra slots per host
    and SG global slots. Each shard's local tangent layout is [MI interiors |
    SI own-host intra | SG global] (+ one trash block).

    ``optimize_pose_graph_dd`` holds the per-shard arrays on the device
    (``[*mesh.local_shape, ...]``) in a ``DDPartition`` of tensors, with
    ``sep_owner``, ``e_gidx`` and ``e_mask`` left out.
    """

    int_idx: np.ndarray    # [P, MI] global pose index per interior slot
    int_mask: np.ndarray   # [P, MI] 1 = live
    sep_idx: np.ndarray    # [H*SI + SG] global pose index per sep slot
    sep_mask: np.ndarray   # [H*SI + SG]
    sep_owner: np.ndarray  # [H*SI + SG] shard owning each separator pose
    n_hosts: int
    si: int                # intra separator slots per host (0 if H == 1)
    sg: int                # global separator slots
    e_i: np.ndarray        # [P, EM] global source pose index
    e_j: np.ndarray        # [P, EM] global target pose index
    e_li: np.ndarray       # [P, EM] local slot of i (MI + SI + SG = trash)
    e_lj: np.ndarray       # [P, EM] local slot of j
    e_gidx: np.ndarray     # [P, EM] index into the global edge array
    e_mask: np.ndarray     # [P, EM]
    own_rows: np.ndarray   # [P, SO] global pose index of owned separators
    own_slot: np.ndarray   # [P, SO] local sep slot (trash for padding)
    own_mask: np.ndarray   # [P, SO]
    anchor_slot: int       # rank of the anchor within the global block


def build_partition(edge_i: np.ndarray, edge_j: np.ndarray, n_poses: int,
                    n_shards: int, n_hosts: int = 1,
                    anchor_idx: int = 0) -> DDPartition:
    """Classify poses into interiors/separators and assign edges to shards.

    Poses are split into ``n_shards`` contiguous blocks (trajectory order).
    A pose is a separator iff some edge connects it to a pose in another
    shard, or it is the anchor. With ``n_hosts > 1``, shards group
    contiguously into hosts and a separator is host-intra iff none of its
    edges leave its host group. (The JAX package's host numpy, copied.)
    """
    edge_i = np.asarray(edge_i)
    edge_j = np.asarray(edge_j)
    block = -(-n_poses // n_shards)  # ceil
    owner = np.minimum(np.arange(n_poses) // block, n_shards - 1)
    shards_per_host = max(n_shards // max(n_hosts, 1), 1)
    host_of_shard = np.minimum(np.arange(n_shards) // shards_per_host,
                               n_hosts - 1)
    host = host_of_shard[owner]

    oi, oj = owner[edge_i], owner[edge_j]
    cross = oi != oj
    is_sep = np.zeros(n_poses, bool)
    is_sep[edge_i[cross]] = True
    is_sep[edge_j[cross]] = True
    is_sep[anchor_idx] = True

    if n_hosts > 1:
        hcross = host[edge_i] != host[edge_j]
        is_glob = np.zeros(n_poses, bool)
        is_glob[edge_i[hcross]] = True
        is_glob[edge_j[hcross]] = True
        is_glob[anchor_idx] = True
        is_glob &= is_sep
    else:
        is_glob = is_sep.copy()
    is_intra = is_sep & ~is_glob

    si = 0
    intra_by_host: list[np.ndarray] = []
    for h in range(n_hosts):
        ids = np.where(is_intra & (host == h))[0]
        intra_by_host.append(ids)
        si = max(si, len(ids))
    if n_hosts == 1:
        si = 0
    glob_ids = np.where(is_glob)[0]
    sg = len(glob_ids)
    S = n_hosts * si + sg
    sep_idx = np.zeros(S, np.int32)
    sep_mask = np.zeros(S, np.float32)
    intra_rank = np.full(n_poses, -1, np.int64)
    glob_rank = np.full(n_poses, -1, np.int64)
    for h in range(n_hosts):
        ids = intra_by_host[h]
        sep_idx[h * si:h * si + len(ids)] = ids
        sep_mask[h * si:h * si + len(ids)] = 1.0
        intra_rank[ids] = np.arange(len(ids))
    sep_idx[n_hosts * si:] = glob_ids
    sep_mask[n_hosts * si:] = 1.0
    glob_rank[glob_ids] = np.arange(sg)

    mi = 0
    int_by_shard = []
    for s in range(n_shards):
        ids = np.where((owner == s) & ~is_sep)[0]
        int_by_shard.append(ids)
        mi = max(mi, len(ids))
    mi = max(mi, 1)  # keep A non-empty even if every pose is a separator
    int_idx = np.zeros((n_shards, mi), np.int32)
    int_mask = np.zeros((n_shards, mi), np.float32)
    int_slot = np.full(n_poses, -1, np.int64)
    for s in range(n_shards):
        ids = int_by_shard[s]
        int_idx[s, :len(ids)] = ids
        int_mask[s, :len(ids)] = 1.0
        int_slot[ids] = np.arange(len(ids))

    # edge -> shard of owner(i); cross-shard edges touch only separators so
    # any shard seeing them has both endpoints in its local tangent space
    eshard = oi
    em = max(int(np.bincount(eshard, minlength=n_shards).max()), 1)
    s_loc = si + sg
    trash = mi + s_loc

    def local_slot(p):
        return np.where(
            is_glob[p], mi + si + glob_rank[p],
            np.where(is_sep[p], mi + intra_rank[p], int_slot[p]))

    e_i = np.zeros((n_shards, em), np.int32)
    e_j = np.zeros((n_shards, em), np.int32)
    e_li = np.full((n_shards, em), trash, np.int32)
    e_lj = np.full((n_shards, em), trash, np.int32)
    e_gidx = np.zeros((n_shards, em), np.int32)
    e_mask = np.zeros((n_shards, em), np.float32)
    for s in range(n_shards):
        ids = np.where(eshard == s)[0]
        k = len(ids)
        e_i[s, :k] = edge_i[ids]
        e_j[s, :k] = edge_j[ids]
        e_li[s, :k] = local_slot(edge_i[ids])
        e_lj[s, :k] = local_slot(edge_j[ids])
        e_gidx[s, :k] = ids
        e_mask[s, :k] = 1.0

    # owned separators: each separator pose belongs to exactly one shard,
    # which computes its (per-pose) point factors
    sep_pose_ids = np.where(is_sep)[0]
    so = max(int(np.bincount(owner[sep_pose_ids],
                             minlength=n_shards).max()), 1)
    own_rows = np.zeros((n_shards, so), np.int32)
    own_slot = np.full((n_shards, so), trash, np.int32)
    own_mask = np.zeros((n_shards, so), np.float32)
    for s in range(n_shards):
        ids = sep_pose_ids[owner[sep_pose_ids] == s]
        k = len(ids)
        own_rows[s, :k] = ids
        own_slot[s, :k] = local_slot(ids)
        own_mask[s, :k] = 1.0

    return DDPartition(
        int_idx=int_idx, int_mask=int_mask,
        sep_idx=sep_idx, sep_mask=sep_mask,
        sep_owner=owner[sep_idx].astype(np.int32),
        n_hosts=n_hosts, si=si, sg=sg,
        e_i=e_i, e_j=e_j, e_li=e_li, e_lj=e_lj,
        e_gidx=e_gidx, e_mask=e_mask,
        own_rows=own_rows, own_slot=own_slot, own_mask=own_mask,
        anchor_slot=int(glob_rank[anchor_idx]),
    )


class PointFactors(NamedTuple):
    """Per-pose scan-to-map point-to-plane factors (the BA fattener): the
    reference's LidarMapPlaneNormFactor, residual w (n . (T p) + d) for a
    world-frame plane (n, d) matched to body-frame point p. They touch only
    their pose's 6x6 diagonal block."""

    pts: torch.Tensor      # [N, K, 3] scan points in body frame
    normals: torch.Tensor  # [N, K, 3] world-frame plane unit normals
    d: torch.Tensor        # [N, K] plane offsets
    w: torch.Tensor        # [N, K] sqrt-info weights (0 = invalid)


class MapShard(NamedTuple):
    """Per-pose candidate map planes for in-step re-association: every GN
    iteration each scan point is re-matched to its nearest plane anchor."""

    pts: torch.Tensor      # [N, K, 3] scan points in body frame
    anchors: torch.Tensor  # [N, M, 3] world-frame plane anchor points
    normals: torch.Tensor  # [N, M, 3] world-frame plane unit normals
    w: torch.Tensor        # [N, K] per-scan-point sqrt-info (0 = invalid)
    valid: torch.Tensor    # [N, M] candidate validity mask


def point_block(pose: Pose, pts, n, d, w):
    """(H [..., 6, 6], g [..., 6], cost [...]) of each pose's point-to-plane
    factors (pts, n [..., K, 3], d, w [..., K]).

    Right-perturbation analytic Jacobian: with T' = T Exp(xi),
    T' p ~= R (p + rho + phi x p) + t, so with m = R^T n:
      dr/drho = w m^T,    dr/dphi = w (p x m)^T.
    """
    R = rot.quat_to_matrix(pose.q)
    pw = torch.einsum("...ij,...kj->...ki", R, pts) + pose.t[..., None, :]
    r = w * (torch.sum(n * pw, -1) + d)
    m = torch.einsum("...ki,...ij->...kj", n, R)
    J = torch.cat([w[..., None] * m,
                   w[..., None] * torch.linalg.cross(pts, m, dim=-1)], -1)
    Jt = J.transpose(-1, -2)
    return Jt @ J, (Jt @ r[..., None])[..., 0], 0.5 * torch.sum(r * r, -1)


def associate_block(pose: Pose, ms_pts, ms_anchor, ms_n, ms_w, ms_valid,
                    max_dist: float, m_tile: int = 1024,
                    search_dtype=torch.bfloat16):
    """Re-associate each pose's scan points [..., K, 3] against its map
    candidates [..., M, 3] and return (H, g, cost) as :func:`point_block`:
    nearest-anchor match, gated at ``max_dist``.

    The search streams over M in tiles of ``m_tile``: each step computes a
    [K, m_tile] block of squared distances and folds it into a running
    (best d², index); the [K, M] matrix is never held. It runs on operands
    centred on the anchors' centroid and rounded to ``search_dtype`` (bf16:
    the argmin is a selection, and may swap neighbours whose distances agree
    to ~0.4 %), multiplied and summed in f32, d² = |p|² + |a|² - 2 p·a as the
    JAX package computes it. ``torch.matmul`` on bf16 tensors would return
    bf16 and move the argmin; here the products of bf16 values are exact in
    f32 and p·a is summed elementwise, not by a matmul whose kernel depends
    on the batch's shape. The selected pair's linearization is f32.
    """
    R = rot.quat_to_matrix(pose.q)
    pw = torch.einsum("...ij,...kj->...ki", R, ms_pts) + pose.t[..., None, :]
    M = ms_anchor.shape[-2]
    tile = min(m_tile, M)
    center = torch.sum(ms_anchor, -2) / max(M, 1)
    pw_s = (pw - center[..., None, :]).to(search_dtype).float()
    anc_s = (ms_anchor - center[..., None, :]).to(search_dtype).float()
    pw2 = torch.sum(pw_s * pw_s, -1)
    best = torch.full_like(pw2, torch.inf)
    bj = torch.zeros(pw2.shape, dtype=torch.int64, device=pw2.device)
    for base in range(0, M, tile):
        a = anc_s[..., base:base + tile, :]
        cross = pw_s[..., :, None, 0] * a[..., None, :, 0]
        cross.addcmul_(pw_s[..., :, None, 1], a[..., None, :, 1])
        cross.addcmul_(pw_s[..., :, None, 2], a[..., None, :, 2])
        d2 = pw2[..., None] + torch.sum(a * a, -1)[..., None, :]
        d2.add_(cross, alpha=-2.0)
        d2.masked_fill_(~(ms_valid[..., None, base:base + tile] > 0), 3.4e38)
        tmin, targ = torch.min(d2, -1)
        upd = tmin < best
        best = torch.where(upd, tmin, best)
        bj = torch.where(upd, targ + base, bj)
    idx = bj[..., None].expand(bj.shape + (3,))
    n = torch.gather(ms_n, -2, idx)
    a = torch.gather(ms_anchor, -2, idx)
    d = -torch.sum(n * a, -1)
    w = torch.where(torch.isfinite(best) & (best < max_dist * max_dist), ms_w, 0.0)
    return point_block(pose, ms_pts, n, d, w)


def _chol(A):
    """Lower Cholesky factor; NaN where ``A`` is not positive definite."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def _eye(d, like):
    return torch.eye(d, dtype=like.dtype, device=like.device)


def _schur(A, B, C, gI, gS, eps: float = 1e-8):
    """Eliminate the A block of [[A, B], [B^T, C]] x = -[gI, gS]."""
    L = _chol(A + eps * _eye(A.shape[-1], A))
    AinvB = torch.cholesky_solve(B, L)
    AinvgI = torch.cholesky_solve(gI[..., None], L)[..., 0]
    Bt = B.transpose(-1, -2)
    return C - Bt @ AinvB, gS - (Bt @ AinvgI[..., None])[..., 0], L, AinvgI


def _add_diag(S, v):
    """S + diag(v), batched."""
    return S + torch.diag_embed(v)


def _rows(fn, chunk, nd, *xs):
    """``fn`` over the rows (axis ``nd``, after the mesh axes) of ``xs``, in
    chunks of ``chunk`` rows (all at once for None): bounds the association
    scratch at realistic map sizes."""
    n = xs[0].shape[nd]
    if chunk is None or n <= chunk:
        return fn(*xs)
    parts = [fn(*(x.narrow(nd, s, min(chunk, n - s)) for x in xs))
             for s in range(0, n, chunk)]
    return tuple(torch.cat(p, nd) for p in zip(*parts))


def shard_system(poses: Pose, part: DDPartition, edges_z, pf_local, ms_local,
                 lm_lambda: float = 1e-3, dof4: bool = False,
                 max_dist: float = 1.0, assoc_chunk: int | None = None,
                 nd: int = 1):
    """Each shard's linearization and interior elimination, no collective:
    (S_part, g_part, sep_diag_part, L_A, AinvgI, B, cost) over the shards'
    [*lead, ...] tensors (``nd`` leading mesh axes)."""
    mi = part.int_idx.shape[-1]
    s_loc = part.si + part.sg
    nb = mi + s_loc + 1                   # + one trash block for padding
    z_q, z_t, weight = edges_z
    r, J = _linearize_sparse(poses, PoseGraphEdges(part.e_i, part.e_j, z_q, z_t, weight),
                             dof4)
    Ji, Jj = J[..., :6], J[..., 6:]
    li, lj = part.e_li, part.e_lj
    JiTJj = torch.einsum("...eai,...eaj->...eij", Ji, Jj)
    blocks = [torch.einsum("...eai,...eaj->...eij", Ji, Ji),
              torch.einsum("...eai,...eaj->...eij", Jj, Jj), JiTJj, JiTJj.transpose(-1, -2)]
    keys = [li * nb + li, lj * nb + lj, li * nb + lj, lj * nb + li]
    grows = [torch.einsum("...eai,...ea->...ei", Ji, r),
             torch.einsum("...eai,...ea->...ei", Jj, r)]
    gslots = [li, lj]
    cost = 0.5 * torch.sum(r * r, dim=(-2, -1))

    int_slot = torch.arange(mi, device=li.device).expand(part.int_idx.shape)

    def add(hgc, slots):
        """Per-pose 6x6 blocks onto their local slots' diagonal blocks."""
        nonlocal cost
        Hb, gb, cb = hgc
        blocks.append(Hb)
        keys.append(slots * nb + slots)
        grows.append(gb)
        gslots.append(slots)
        cost = cost + torch.sum(cb, -1)

    rows = ((part.int_idx, part.int_mask, int_slot),
            (part.own_rows, part.own_mask, part.own_slot))
    if pf_local is not None:
        for (idx, mask, slots), pf in zip(rows, pf_local):
            add(point_block(Pose(poses.q[idx], poses.t[idx]), pf.pts, pf.normals,
                            pf.d, pf.w * mask[..., None]), slots)
    if ms_local is not None:
        def ablock(q, t, p, a, n, w, v):
            return associate_block(Pose(q, t), p, a, n, w, v, max_dist)

        for (idx, mask, slots), ms in zip(rows, ms_local):
            add(_rows(ablock, assoc_chunk, nd, poses.q[idx], poses.t[idx], ms.pts,
                      ms.anchors, ms.normals, ms.w * mask[..., None], ms.valid), slots)

    H = index_sum(torch.cat(blocks, -3), torch.cat(keys, -1), nb * nb)
    lead = H.shape[:-3]
    H = H.reshape(lead + (nb, nb, 6, 6)).transpose(-3, -2).reshape(lead + (nb * 6, nb * 6))
    g = index_sum(torch.cat(grows, -2), torch.cat(gslots, -1), nb).reshape(lead + (nb * 6,))
    # drop the trash block, then split
    H, g = H[..., :-6, :-6], g[..., :-6]
    d_int = mi * 6
    A, B, C = H[..., :d_int, :d_int], H[..., :d_int, d_int:], H[..., d_int:, d_int:]
    # Marquardt damping, matching the dense path's lm_lambda*(diag + 1e-3);
    # padded interior slots get lm_lambda*1e-3, which keeps A invertible
    A = _add_diag(A, lm_lambda * (torch.diagonal(A, dim1=-2, dim2=-1) + 1e-3))
    # the separator diagonal (pre-Schur) travels with the reduction so
    # damping uses the complete assembled diagonal, as the dense path does
    sep_diag_part = torch.diagonal(C, dim1=-2, dim2=-1)
    S_part, g_part, L_A, AinvgI = _schur(A, B, C, g[..., :d_int], g[..., d_int:])
    return S_part, g_part, sep_diag_part, L_A, AinvgI, B, cost


def dd_pgo_step(poses: Pose, part: DDPartition, edges_z, pf_local, ms_local,
                mesh, anchor_w: float = 1e3, lm_lambda: float = 1e-3,
                dof4: bool = False, reduce_dtype=None, max_dist: float = 1.0,
                assoc_chunk: int | None = None):
    """One exact damped-GN step over ``mesh``.

    ``part``: the device partition (per-shard arrays [*local, ...], the
    separator table replicated). ``edges_z`` = each shard's (z_q, z_t,
    weight) [*local, EM, ...]. ``pf_local`` = None or (PointFactors rows of
    the interiors [*local, MI, K, ...], of the owned separators [*local, SO,
    K, ...]); ``ms_local`` the same for MapShard rows. Every pose's factors
    are computed once across the mesh. Returns (new poses, cost).
    """
    axes = data_axes(mesh)
    mi = part.int_idx.shape[-1]
    nH, si, sg = part.n_hosts, part.si, part.sg
    s_loc = si + sg
    n = poses.q.shape[0]

    S_part, g_part, sep_diag_part, L_A, AinvgI, B, cost = shard_system(
        poses, part, edges_z, pf_local, ms_local, lm_lambda, dof4, max_dist,
        assoc_chunk, mesh.ndim)

    def reduce_(x, ax):
        if reduce_dtype is not None:
            return mesh.psum(x.to(reduce_dtype), ax).to(poses.q.dtype)
        return mesh.psum(x, ax)

    cost = mesh.psum(cost, axes)
    # the dense path adds the anchor weight before damping, so its diagonal
    # damping includes lm_lambda*anchor_w: replicate that exactly
    anchor_add = anchor_w * (1.0 + lm_lambda)
    d_si, d_sg = si * 6, sg * 6
    ar = torch.arange(6, device=S_part.device)

    def anchored(S, slot):
        a = slot * 6 + ar
        S = S.clone()
        S[..., a, a] += anchor_add
        return S

    if nH > 1 and si > 0:
        host_axis, chip_axis = axes[0], axes[-1]
        # level 1: reduction of this host's [intra | global] system over its chips
        S1 = reduce_(S_part, chip_axis)
        g1 = reduce_(g_part, chip_axis)
        sd1 = reduce_(sep_diag_part, chip_axis)
        A2 = _add_diag(S1[..., :d_si, :d_si], lm_lambda * (sd1[..., :d_si] + 1e-3))
        B2 = S1[..., :d_si, d_si:]
        C2 = S1[..., d_si:, d_si:]
        S2_part, g2_part, L2, A2invg2 = _schur(A2, B2, C2, g1[..., :d_si], g1[..., d_si:])
        # level 2: reduction of only the global separator system across hosts
        SG = reduce_(S2_part, host_axis)
        gG = reduce_(g2_part, host_axis)
        sdG = reduce_(sd1[..., d_si:], host_axis)
        SG = anchored(_add_diag(SG, lm_lambda * (sdG + 1e-3)), part.anchor_slot)
        LG = _chol(SG + 1e-8 * _eye(d_sg, SG))
        dxG = -torch.cholesky_solve(gG[..., None], LG)[..., 0]
        # back-substitute this host's intra separators
        dx2 = -(A2invg2 + torch.cholesky_solve(B2 @ dxG[..., None], L2)[..., 0])
        dx_sep = torch.cat([dx2, dxG.expand(dx2.shape[:-1] + (d_sg,))], -1)
    else:
        Sred = reduce_(S_part, axes)
        gred = reduce_(g_part, axes)
        sd = reduce_(sep_diag_part, axes)
        Sd = anchored(_add_diag(Sred, lm_lambda * (sd + 1e-3)), si + part.anchor_slot)
        Ls = _chol(Sd + 1e-8 * _eye(s_loc * 6, Sd))
        dx_sep = -torch.cholesky_solve(gred[..., None], Ls)[..., 0]

    # back-substitute interiors: dx_I = -A^-1 (g_I + B dx_sep)
    dx_int = -(AinvgI + torch.cholesky_solve(B @ dx_sep[..., None], L_A)[..., 0])

    def scatter(rows, idx, mask):
        """[..., R*6] slot updates onto their poses [..., N, 6]."""
        rows = rows.reshape(rows.shape[:-1] + (-1, 6)) * mask[..., None]
        return index_sum(rows, idx.expand(rows.shape[:-1]), n)

    # interiors: disjoint across shards, summed over all axes; intra
    # separators: the same on a host's chips, disjoint across hosts, summed
    # over the host axis; global separators: the same everywhere, added once
    dx_full = mesh.psum(scatter(dx_int, part.int_idx, part.int_mask), axes)
    if nH > 1 and si > 0:
        h = mesh.axis_index(axes[0])[..., None]
        intra_idx = part.sep_idx[h * si + torch.arange(si, device=h.device)]
        intra_mask = part.sep_mask[h * si + torch.arange(si, device=h.device)]
        dx_full = dx_full + mesh.psum(scatter(dx2, intra_idx, intra_mask), axes[0])
        dx_full = dx_full + scatter(dxG, part.sep_idx[nH * si:], part.sep_mask[nH * si:])
    else:
        dx_full = dx_full + scatter(dx_sep, part.sep_idx, part.sep_mask)

    retract = boxplus_dof4 if dof4 else se3.boxplus
    new = retract(poses, mesh.replicated(dx_full))
    return Pose(new.q, new.t), mesh.replicated(cost)


def _prepare_device_inputs(part: DDPartition, edges: PoseGraphEdges,
                           point_factors, map_shard, mesh):
    """This process's shards of the partition, the edges' measurements and
    the per-pose factor rows, gathered on the device (padding rows masked
    by ``int_mask`` / ``own_mask``). Returns (device partition, (z_q, z_t,
    weight), factor rows, map rows)."""
    dev = mesh.device

    def loc(x, dtype):
        return mesh.local(torch.as_tensor(np.asarray(x))).to(dtype)

    L = torch.int64
    f = torch.float32
    e_gidx, e_mask = loc(part.e_gidx, L), loc(part.e_mask, f)
    local = DDPartition(
        int_idx=loc(part.int_idx, L), int_mask=loc(part.int_mask, f),
        sep_idx=torch.as_tensor(part.sep_idx, dtype=L, device=dev),
        sep_mask=torch.as_tensor(part.sep_mask, dtype=f, device=dev),
        sep_owner=None, n_hosts=part.n_hosts, si=part.si, sg=part.sg,
        e_i=loc(part.e_i, L), e_j=loc(part.e_j, L),
        e_li=loc(part.e_li, L), e_lj=loc(part.e_lj, L),
        e_gidx=None, e_mask=None,
        own_rows=loc(part.own_rows, L), own_slot=loc(part.own_slot, L),
        own_mask=loc(part.own_mask, f), anchor_slot=part.anchor_slot)
    live = e_mask[..., None] > 0
    z_q = torch.where(live, edges.z_q[e_gidx], Pose.identity((), f, dev).q)
    ez = (z_q, edges.z_t[e_gidx], edges.weight[e_gidx] * e_mask[..., None])

    def rows(tree):
        if tree is None:
            return None
        return (type(tree)(*(x[local.int_idx] for x in tree)),
                type(tree)(*(x[local.own_rows] for x in tree)))

    return local, ez, rows(point_factors), rows(map_shard)


def make_dd_program(part: DDPartition, mesh, iters: int = 10,
                    anchor_w: float = 1e3, lm_lambda: float = 1e-3,
                    dof4: bool = False, reduce_dtype=None,
                    max_dist: float = 1.0, assoc_chunk: int | None = None):
    """The solve for a fixed partition: ``run(poses, local_part, ez, pf_dev,
    ms_dev)`` runs ``iters`` exact damped-GN steps -> (poses, final cost)."""

    def run(poses, local_part, ez, pf_dev, ms_dev):
        cost = torch.zeros((), device=poses.q.device)
        for _ in range(iters):
            poses, cost = dd_pgo_step(poses, local_part, ez, pf_dev, ms_dev, mesh,
                                      anchor_w=anchor_w, lm_lambda=lm_lambda,
                                      dof4=dof4, reduce_dtype=reduce_dtype,
                                      max_dist=max_dist, assoc_chunk=assoc_chunk)
        return poses, cost

    return run


def mesh_partition(edges: PoseGraphEdges, n_poses: int, mesh,
                   anchor_idx: int = 0) -> DDPartition:
    """``build_partition`` for a 1-D (factor) or 2-D (host, factor) mesh."""
    n_hosts = mesh.shape[0] if mesh.ndim == 2 else 1
    return build_partition(edges.i.cpu().numpy(), edges.j.cpu().numpy(), n_poses,
                           mesh.size, n_hosts=n_hosts, anchor_idx=anchor_idx)


def optimize_pose_graph_dd(poses: Pose, edges: PoseGraphEdges, mesh,
                           iters: int = 10, anchor_idx: int = 0,
                           anchor_w: float = 1e3, lm_lambda: float = 1e-3,
                           dof4: bool = False,
                           point_factors: PointFactors | None = None,
                           map_shard: MapShard | None = None,
                           reduce_dtype=None,
                           partition: DDPartition | None = None,
                           max_dist: float = 1.0,
                           assoc_chunk: int | None = None):
    """Nested-dissection PGO/BA over a 1-D (factor) or 2-D (host, factor)
    mesh. Per GN iteration the communication is one separator-system
    reduction (+ an [N, 6] interior-update reduction and a scalar),
    independent of any inner iteration count. ``partition`` may be built
    once with :func:`build_partition` and reused across calls sharing the
    graph topology. Returns (poses, cost)."""
    if dof4 and (point_factors is not None or map_shard is not None):
        # point_block/associate_block linearize with the full 6-DoF
        # right-perturbation Jacobian; the dof4 step is a world-frame
        # translation + yaw-only retraction, so mixing them would be an
        # inconsistent linearization (the reference's 4-DoF graph is
        # edges-only too, pose_graph.h:199-289)
        raise ValueError(
            "dof4=True is only supported for edge-only pose graphs; "
            "point_factors/map_shard use the 6-DoF linearization")
    if partition is None:
        partition = mesh_partition(edges, poses.q.shape[0], mesh, anchor_idx)
    local, ez, pf_dev, ms_dev = _prepare_device_inputs(
        partition, edges, point_factors, map_shard, mesh)
    run = make_dd_program(partition, mesh, iters=iters, anchor_w=anchor_w,
                          lm_lambda=lm_lambda, dof4=dof4, reduce_dtype=reduce_dtype,
                          max_dist=max_dist, assoc_chunk=assoc_chunk)
    return run(poses, local, ez, pf_dev, ms_dev)
