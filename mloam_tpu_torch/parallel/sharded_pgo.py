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

The JAX package shards the edges over a device mesh and reduces the normal
equations with ``psum``; that distributed form is ROADMAP A14 and a mesh
raises ``NotImplementedError`` here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mloam_tpu_torch.core import rotations as rot
from mloam_tpu_torch.core import se3
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.ops.segsum import index_sum


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
    """Per-edge residuals [E, R] and Jacobians [E, R, 12] (w.r.t. the
    perturbations of T_i then T_j), kept in block form."""
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
    """[E] pose indices -> [E, 6] flat tangent indices."""
    return ii[:, None] * 6 + torch.arange(6, device=ii.device)[None, :]


def _linearize_edges(poses: Pose, edges: PoseGraphEdges, dof4: bool = False):
    """Dense (H, g, cost) over the full N·6 tangent."""
    n = poses.q.shape[0]
    dim = n * 6
    r, J = _linearize_sparse(poses, edges, dof4)
    Ji, Jj = J[:, :, :6], J[:, :, 6:]
    # the four block sets, keyed by their (row pose, column pose) pair, are
    # summed per pair in one order-independent sum (``segsum.index_sum``)
    # over the pairs' ranks in sorted order, and each pair's sum is written
    # into its block of H: no accumulator of H's size
    ri = torch.cat([edges.i, edges.j, edges.i, edges.j])
    ci = torch.cat([edges.i, edges.j, edges.j, edges.i])
    JiTJj = torch.einsum("eai,eaj->eij", Ji, Jj)
    blks = torch.cat([torch.einsum("eai,eaj->eij", Ji, Ji),
                      torch.einsum("eai,eaj->eij", Jj, Jj),
                      JiTJj, JiTJj.transpose(-1, -2)])
    key, order = torch.sort(ri * n + ci)
    first = torch.ones_like(key)
    first[1:] = key[1:] != key[:-1]
    pair = torch.empty_like(key).scatter_(0, order, torch.cumsum(first, 0) - 1)
    sums = index_sum(blks, pair, key.shape[0])
    H = torch.zeros((n, 6, n, 6), dtype=blks.dtype, device=blks.device)
    H[ri, :, ci, :] = sums[pair]    # a pair's members write the same sum
    bi, bj = _blocks(edges.i), _blocks(edges.j)
    g = index_sum(torch.cat([torch.einsum("eai,ea->ei", Ji, r),
                             torch.einsum("eai,ea->ei", Jj, r)]).reshape(-1),
                  torch.cat([bi, bj]).reshape(-1), dim)
    return H.reshape(dim, dim), g, 0.5 * torch.sum(r * r)


def _retract_all(poses: Pose, dx: torch.Tensor, dof4: bool) -> Pose:
    return (boxplus_dof4 if dof4 else se3.boxplus)(poses, dx)


def pgo_step(poses: Pose, edges: PoseGraphEdges, anchor_idx: int = 0,
             anchor_w: float = 1e3, lm_lambda: float = 1e-3,
             dof4: bool = False):
    """One damped GN step over all poses, dense: a strong absolute prior on
    ``anchor_idx`` fixes the gauge, Marquardt damping on diag(H), one
    Cholesky. ``dof4``: (x, y, z, yaw) variables with 4-row edge residuals
    and a yaw-only retraction. Returns (new poses, cost)."""
    n = poses.q.shape[0]
    dim = n * 6
    H, g, cost = _linearize_edges(poses, edges, dof4)
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
                cg_iters: int = 32, dof4: bool = False):
    """One damped GN step solved matrix-free by preconditioned conjugate
    gradients over the block-sparse normal equations (H never formed: a
    gather, an [E, R, 12] product and a scatter-add per iteration), with
    the damped 6×6 diagonal blocks as block-Jacobi preconditioner. The
    iterations run as a host loop of device ops with no host read."""
    n = poses.q.shape[0]
    dev, dt = poses.q.device, poses.q.dtype
    r, J = _linearize_sparse(poses, edges, dof4)
    Ji, Jj = J[:, :, :6], J[:, :, 6:]

    ij = torch.cat([edges.i, edges.j])

    def scatter_pair(vi, vj):
        """Per-pose sums of the edges' i-side and j-side terms, in an
        order-independent sum (``segsum.index_sum``)."""
        return index_sum(torch.cat([vi, vj]), ij, n)

    g = scatter_pair(torch.einsum("eai,ea->ei", Ji, r),
                     torch.einsum("eai,ea->ei", Jj, r))
    diag = scatter_pair(torch.einsum("eai,eaj->eij", Ji, Ji),
                        torch.einsum("eai,eaj->eij", Jj, Jj))
    cost = 0.5 * torch.sum(r * r)

    eye6 = torch.eye(6, dtype=dt, device=dev)
    anchor = torch.zeros((n, 1, 1), dtype=dt, device=dev)
    anchor[anchor_idx] = anchor_w
    d_damp = diag + anchor * eye6 + lm_lambda * (diag * eye6 + 1e-3 * eye6)
    M_inv, _ = torch.linalg.inv_ex(d_damp + 1e-6 * eye6[None])
    extra = d_damp - diag       # damping + anchor, per pose block

    def hv(v):
        jv = (torch.einsum("eai,ei->ea", Ji, v[edges.i])
              + torch.einsum("eai,ei->ea", Jj, v[edges.j]))
        out = scatter_pair(torch.einsum("eai,ea->ei", Ji, jv),
                           torch.einsum("eai,ea->ei", Jj, jv))
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
# deviations). So the switch is set by the card's memory, not by time
AUTO_DENSE_MAX_POSES = 12288


def optimize_pose_graph(poses: Pose, edges: PoseGraphEdges, iters: int = 10,
                        anchor_idx: int = 0, mesh=None, dof4: bool = False,
                        solver: str = "auto", cg_iters: int | None = None) -> Pose:
    """Full PGO: ``iters`` damped GN steps.

    ``solver``: 'dense' (``pgo_step``), 'cg' (``pgo_step_cg``) or 'auto'
    (cg beyond ``AUTO_DENSE_MAX_POSES``, where the dense step's memory,
    which grows with the square of the poses, passes an 80 GB card's). ``cg_iters`` None sizes the PCG to the
    chain-propagation bound n + n/4 (information moves about one pose per
    iteration along a sequential graph)."""
    if mesh is not None:
        raise NotImplementedError(
            "optimize_pose_graph(mesh=...): the edge-sharded PGO across "
            "devices is not ported yet (ROADMAP A14)")
    n = poses.q.shape[0]
    if solver == "auto":
        solver = "cg" if n > AUTO_DENSE_MAX_POSES else "dense"
    cg_eff = (n + n // 4) if cg_iters is None else cg_iters
    for _ in range(iters):
        if solver == "cg":
            poses, _ = pgo_step_cg(poses, edges, anchor_idx=anchor_idx,
                                   cg_iters=cg_eff, dof4=dof4)
        else:
            poses, _ = pgo_step(poses, edges, anchor_idx=anchor_idx, dof4=dof4)
    return poses
