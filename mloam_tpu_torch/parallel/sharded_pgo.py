"""Pose-graph optimization: damped Gauss-Newton over keyframe poses.

Counterpart of ``mloam_tpu/parallel/sharded_pgo.py`` on one device (the
reference's PGO thread: sequential and loop relative-pose edges over the
keyframe poses). Two solvers share the per-edge linearization:

  * ``pgo_step``: dense normal equations [N·6, N·6], block scatter-add, one
    Cholesky (``cholesky_ex``: a damped H that is not positive definite gives
    a NaN step, as the JAX package's Cholesky does; nothing regularises it
    silently);
  * ``pgo_step_cg``: the normal equations kept as the operator
    H v = Σ_e Jᵉᵀ (Jᵉ v|_e) + damping + anchor, solved by conjugate
    gradients with a block-Jacobi (6×6 per pose) preconditioner.

Every scatter-add of per-edge terms onto the poses is ``ops/segsum.index_sum``
(fixed-point integer adds): the same bits on every run, where float atomics
would change the last bits of H, g and each conjugate-gradient product.

The per-edge Jacobians [E, R, 12] come from one forward-mode pass over a
12-dim perturbation shared by all edges (edge e's residual depends on its
own two poses only, so the shared perturbation yields every edge's own
Jacobian; the JAX package vmaps a per-edge ``jacfwd``).

With a mesh (``parallel/mesh.py``) the edges are sharded over every mesh
axis, as the JAX package shards them: each shard linearizes its edges and
the per-pose sums are reduced across shards by ``mesh.index_sum`` (the
fixed-point scale of each column from the bound over all shards, one small
``pmax``; the integer partial sums ``psum``-reduced), so the sharded step has
the bits of the one-device step on the same (padded) edge list. The dense
step assembles H the same way with and without a mesh: the 6×6 blocks are
summed per (row pose, column pose) pair, keyed by the pair's rank among the
pairs of all shards, and each sum is written once into H; so a shard's
accumulator and the reduction hold the pairs (about 9 per pose on the
survey graph), not H [N·6, N·6], and the mesh step's memory is the
one-device step's. It reduces those blocks, g and the cost once; the PCG
step g, the diagonal blocks and the cost once, and every H·v product. The
damped solve then runs on the reduced system, once for all shards.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mloam_tpu_torch.core import rotations as rot
from mloam_tpu_torch.core import se3
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.ops.segsum import index_sum
from mloam_tpu_torch.parallel.mesh import data_axes


class PoseGraphEdges(NamedTuple):
    """Padded edge set. i -> j measurement Z = T_i^-1 T_j (expected)."""

    i: torch.Tensor        # [E] int source pose index
    j: torch.Tensor        # [E] int target pose index
    z_q: torch.Tensor      # [E, 4] measured relative rotation
    z_t: torch.Tensor      # [E, 3] measured relative translation
    weight: torch.Tensor   # [E, 6] per-tangent-dim sqrt-weights (0 = invalid)


def edge_residual(Ti: Pose, Tj: Pose, z_q, z_t, weight) -> torch.Tensor:
    """[..., 6] weighted tangent error log(Z^-1 (T_i^-1 T_j))."""
    rel = se3.relative(Ti, Tj)
    return weight * se3.boxminus(rel, Pose(z_q, z_t))


def _yaw_of(q: torch.Tensor) -> torch.Tensor:
    """Yaw (rotation about world z) of a wxyz quaternion."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))


def boxplus_dof4(T: Pose, d: torch.Tensor) -> Pose:
    """4-DoF retraction: world-frame translation + yaw about world z.
    Tangent layout [dt(3), _, _, dyaw]; the roll/pitch slots are ignored, so
    those orientations stay exactly at their odometry estimates."""
    zero = torch.zeros_like(d[..., 5])
    qy = rot.so3_exp_quat(torch.stack([zero, zero, d[..., 5]], -1))
    return Pose(rot.quat_multiply(qy, T.q), T.t + d[..., :3])


def edge_residual_dof4(Ti: Pose, Tj: Pose, z_q, z_t, weight) -> torch.Tensor:
    """[..., 4] 4-DoF edge error: relative translation (in frame i) and
    relative yaw, wrapped to [-pi, pi]; roll/pitch error is not penalized."""
    rel = se3.relative(Ti, Tj)
    r_t = weight[..., :3] * (rel.t - z_t)
    dyaw = _yaw_of(rel.q) - _yaw_of(z_q)
    dyaw = torch.atan2(torch.sin(dyaw), torch.cos(dyaw))
    return torch.cat([r_t, (weight[..., 5] * dyaw)[..., None]], -1)


def _linearize_sparse(poses: Pose, edges: PoseGraphEdges, dof4: bool = False):
    """Per-edge residuals [..., E, R] and Jacobians [..., E, R, 12] (w.r.t.
    the perturbations of T_i then T_j), kept in block form; leading axes of
    the edges (a stacked mesh's shards) carry through."""
    res_fn = edge_residual_dof4 if dof4 else edge_residual
    retract = boxplus_dof4 if dof4 else se3.boxplus
    Ti = Pose(poses.q[edges.i], poses.t[edges.i])
    Tj = Pose(poses.q[edges.j], poses.t[edges.j])

    def res(xi):
        return res_fn(retract(Ti, xi[:6]), retract(Tj, xi[6:]),
                      edges.z_q, edges.z_t, edges.weight)

    zero = torch.zeros((12,), dtype=poses.q.dtype, device=poses.q.device)
    J = torch.func.jacfwd(res)(zero)        # [E, R, 12]
    return res(zero), J


def _blocks(ii: torch.Tensor) -> torch.Tensor:
    """[..., E] pose indices -> [..., E, 6] flat tangent indices."""
    return ii[..., None] * 6 + torch.arange(6, device=ii.device)


def _sum_over_shards(values, index, n_out, mesh, axis_name):
    """``index_sum`` of the per-edge terms; with a mesh, of every shard's
    rows together, reduced over ``axis_name`` (``mesh.index_sum``)."""
    if mesh is None:
        return index_sum(values, index, n_out)
    return mesh.replicated(mesh.index_sum(values, index, n_out, axis_name))


def _linearize_edges(poses: Pose, edges: PoseGraphEdges, dof4: bool = False,
                     mesh=None, axis_name=None):
    """Dense (H, g, cost) over the full N·6 tangent; with a mesh, of every
    shard's edges, reduced over ``axis_name``."""
    n = poses.q.shape[0]
    dim = n * 6
    r, J = _linearize_sparse(poses, edges, dof4)
    Ji, Jj = J[..., :6], J[..., 6:]
    gvals = torch.cat([torch.einsum("...eai,...ea->...ei", Ji, r),
                       torch.einsum("...eai,...ea->...ei", Jj, r)], -2)
    gidx = torch.cat([_blocks(edges.i), _blocks(edges.j)], -2)
    # the four block sets, keyed by their (row pose, column pose) pair
    key = torch.cat([edges.i * n + edges.i, edges.j * n + edges.j,
                     edges.i * n + edges.j, edges.j * n + edges.i], -1)
    JiTJj = torch.einsum("...eai,...eaj->...eij", Ji, Jj)
    blks = torch.cat([torch.einsum("...eai,...eaj->...eij", Ji, Ji),
                      torch.einsum("...eai,...eaj->...eij", Jj, Jj),
                      JiTJj, JiTJj.transpose(-1, -2)], -3)
    # the blocks are summed per pair, over every shard, keyed by the pair's
    # rank among all shards' pairs (the keys gathered: 4 integers an edge), and each
    # pair's sum is written once into its block of H: the accumulators are
    # of the pairs' count, not of H's size
    every = key if mesh is None else mesh.replicated(mesh.all_gather(key, axis_name))
    pairs = torch.unique(every)
    sums = _sum_over_shards(blks, torch.searchsorted(pairs, key), pairs.shape[0],
                            mesh, axis_name)
    H = torch.zeros((n, 6, n, 6), dtype=blks.dtype, device=blks.device)
    H[pairs // n, :, pairs % n, :] = sums
    g = _sum_over_shards(gvals.flatten(-2), gidx.flatten(-2), dim, mesh, axis_name)
    cost = 0.5 * torch.sum(r * r, dim=(-2, -1))
    if mesh is not None:
        cost = mesh.replicated(mesh.psum(cost, axis_name))
    return H.reshape(dim, dim), g, cost


def _retract_all(poses: Pose, dx: torch.Tensor, dof4: bool) -> Pose:
    return (boxplus_dof4 if dof4 else se3.boxplus)(poses, dx)


def pgo_step(poses: Pose, edges: PoseGraphEdges, anchor_idx: int = 0,
             anchor_w: float = 1e3, lm_lambda: float = 1e-3,
             dof4: bool = False, mesh=None, axis_name=None):
    """One damped GN step over all poses, dense: a strong absolute prior on
    ``anchor_idx`` fixes the gauge, Marquardt damping on diag(H), one
    Cholesky. ``dof4``: (x, y, z, yaw) variables with 4-row edge residuals
    and a yaw-only retraction. With ``mesh``, ``edges`` are one shard's per
    leading mesh position and (H, g, cost) are reduced over ``axis_name``
    (one mesh axis or a tuple, the JAX package's ``axis_name``). Returns
    (new poses, cost)."""
    n = poses.q.shape[0]
    dim = n * 6
    H, g, cost = _linearize_edges(poses, edges, dof4, mesh, axis_name)
    # anchor, damping and jitter on H's diagonal in place: the step holds
    # two dim x dim matrices, H and its Cholesky factor
    diag = H.diagonal()
    diag[anchor_idx * 6:(anchor_idx + 1) * 6] += anchor_w
    diag += lm_lambda * (diag + 1e-3)
    diag += 1e-8
    L, info = torch.linalg.cholesky_ex(H)
    dx = -torch.cholesky_solve(g[:, None], L)[:, 0]
    dx = torch.where(info == 0, dx, torch.nan)
    return _retract_all(poses, dx.reshape(n, 6), dof4), cost


def pgo_step_cg(poses: Pose, edges: PoseGraphEdges, anchor_idx: int = 0,
                anchor_w: float = 1e3, lm_lambda: float = 1e-3,
                cg_iters: int = 32, dof4: bool = False, mesh=None,
                axis_name=None):
    """One damped GN step solved matrix-free by preconditioned conjugate
    gradients over the block-sparse normal equations (H never formed: a
    gather, an [E, R, 12] product and a scatter-add per iteration), with
    the damped 6×6 diagonal blocks as block-Jacobi preconditioner. The
    iterations run as a host loop of device ops with no host read. With
    ``mesh`` (as ``pgo_step``) g, the diagonal blocks, the cost and every
    H·v are reduced over ``axis_name``; the vectors and the CG scalars are
    the same on every shard."""
    n = poses.q.shape[0]
    dev, dt = poses.q.device, poses.q.dtype
    r, J = _linearize_sparse(poses, edges, dof4)
    Ji, Jj = J[..., :6], J[..., 6:]

    ij = torch.cat([edges.i, edges.j], -1)

    def scatter_pair(vi, vj):
        """Per-pose sums of the edges' i-side and j-side terms, in an
        order-independent sum (``segsum.index_sum``), over every shard."""
        return _sum_over_shards(torch.cat([vi, vj], ij.ndim - 1), ij, n, mesh, axis_name)

    g = scatter_pair(torch.einsum("...eai,...ea->...ei", Ji, r),
                     torch.einsum("...eai,...ea->...ei", Jj, r))
    diag = scatter_pair(torch.einsum("...eai,...eaj->...eij", Ji, Ji),
                        torch.einsum("...eai,...eaj->...eij", Jj, Jj))
    cost = 0.5 * torch.sum(r * r, dim=(-2, -1))
    if mesh is not None:
        cost = mesh.replicated(mesh.psum(cost, axis_name))

    eye6 = torch.eye(6, dtype=dt, device=dev)
    anchor = torch.zeros((n, 1, 1), dtype=dt, device=dev)
    anchor[anchor_idx] = anchor_w
    d_damp = diag + anchor * eye6 + lm_lambda * (diag * eye6 + 1e-3 * eye6)
    M_inv, _ = torch.linalg.inv_ex(d_damp + 1e-6 * eye6[None])
    extra = d_damp - diag       # damping + anchor, per pose block

    def hv(v):
        jv = (torch.einsum("...eai,...ei->...ea", Ji, v[edges.i])
              + torch.einsum("...eai,...ei->...ea", Jj, v[edges.j]))
        out = scatter_pair(torch.einsum("...eai,...ea->...ei", Ji, jv),
                           torch.einsum("...eai,...ea->...ei", Jj, jv))
        return out + torch.einsum("nij,nj->ni", extra, v)

    b = -g
    x = torch.zeros((n, 6), dtype=dt, device=dev)
    res_ = b
    p = torch.einsum("nij,nj->ni", M_inv, b)
    rz = torch.sum(b * p)
    for _ in range(cg_iters):
        hp = hv(p)
        alpha = rz / torch.clamp(torch.sum(p * hp), min=1e-20)
        x = x + alpha * p
        res_ = res_ - alpha * hp
        z = torch.einsum("nij,nj->ni", M_inv, res_)
        rz_new = torch.sum(res_ * z)
        beta = rz_new / torch.clamp(rz, min=1e-20)
        p = z + beta * p
        rz = rz_new
    return _retract_all(poses, x, dof4), cost


# ``solver="auto"`` takes the dense Cholesky up to this many poses and PCG
# beyond. A port-only rule (the JAX package switches above 512). On an H100
# 80GB the dense step was faster than PCG at every ring it fitted, 256 to
# 12288 poses (3.4 against 17.0 s a GN step at 12288), and peaked at 12.0
# bytes per entry of the (6n)^2 Hessian: 65 GB at 12288 poses; at 16384 it
# ran out of device memory (utils/pgo_ladder.py; ROADMAP's standing
# deviations). So the switch is set by the card's memory, not by time. The
# mesh form assembles H as the one-device step does (accumulators of the
# pose pairs' count, not of H's size), so the same bound holds with a mesh
AUTO_DENSE_MAX_POSES = 12288


def pad_edges(edges: PoseGraphEdges, multiple: int) -> PoseGraphEdges:
    """The edges padded to a multiple of ``multiple`` with identity-
    quaternion zero-weight edges on pose 0 (a zero quaternion would feed
    ``log`` a zero rotation and NaN-poison the reduction)."""
    pad = (-edges.i.shape[0]) % multiple
    z = torch.zeros((pad,), dtype=edges.i.dtype, device=edges.i.device)
    return PoseGraphEdges(
        i=torch.cat([edges.i, z]), j=torch.cat([edges.j, z]),
        z_q=torch.cat([edges.z_q, Pose.identity((pad,), edges.z_q.dtype, edges.z_q.device).q]),
        z_t=torch.cat([edges.z_t, edges.z_t.new_zeros((pad, 3))]),
        weight=torch.cat([edges.weight, edges.weight.new_zeros((pad, 6))]))


def optimize_pose_graph(poses: Pose, edges: PoseGraphEdges, iters: int = 10,
                        anchor_idx: int = 0, mesh=None, dof4: bool = False,
                        solver: str = "auto", cg_iters: int | None = None) -> Pose:
    """Full PGO: ``iters`` damped GN steps.

    ``solver``: 'dense' (``pgo_step``), 'cg' (``pgo_step_cg``) or 'auto'
    (cg beyond ``AUTO_DENSE_MAX_POSES``, where the dense step's memory,
    which grows with the square of the poses, passes an 80 GB card's). ``cg_iters`` None sizes the PCG to the
    chain-propagation bound n + n/4 (information moves about one pose per
    iteration along a sequential graph).

    With ``mesh`` the edges, padded by ``pad_edges`` to a multiple of the
    shard count, are sharded over every mesh axis and each step's
    normal-equation sums are reduced across all of them (on a 2-D (host,
    factor) mesh over both axes at once): the result has the bits of the
    one-device solve of the padded edges."""
    n = poses.q.shape[0]
    if solver == "auto":
        solver = "cg" if n > AUTO_DENSE_MAX_POSES else "dense"
    cg_eff = (n + n // 4) if cg_iters is None else cg_iters
    kw = {}
    if mesh is not None:
        edges = PoseGraphEdges(*(mesh.shard(x) for x in pad_edges(edges, mesh.size)))
        kw = {"mesh": mesh, "axis_name": data_axes(mesh)}
    for _ in range(iters):
        if solver == "cg":
            poses, _ = pgo_step_cg(poses, edges, anchor_idx=anchor_idx,
                                   cg_iters=cg_eff, dof4=dof4, **kw)
        else:
            poses, _ = pgo_step(poses, edges, anchor_idx=anchor_idx, dof4=dof4, **kw)
    return poses
