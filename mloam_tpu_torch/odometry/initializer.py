"""Motion-based multi-LiDAR extrinsic initialization (hand-eye calibration).

Counterpart of ``mloam_tpu/odometry/initializer.py``: screw-motion
consistency filtering, rotation from the stacked quaternion linear system
``(L(q_ref) - R(q_l)) q_ext = 0`` solved by SVD with Huber-weighted rows and
a second-smallest-singular-value convergence gate, translation from the
linear system ``(R_ref - I) t_ext = R_ext t_l - t_ref``, plus the planar
4-DoF variant.

Fixed-capacity motion-pair buffers with masks: a masked pair is a zero row
block of the stacked system, kept in place so the shapes never change. The
sign of the smallest singular vector is free; it is fixed by ``q[0] >= 0``,
as in the JAX package. ``torch.linalg.svd`` synchronises the host on CUDA;
the pipeline calls it once per ``calib.pair_stride`` sweeps, in the
transient calibration phase only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mloam_tpu_torch.core import rotations as rot
from mloam_tpu_torch.core.se3 import Pose


class MotionBuffer(NamedTuple):
    """Paired incremental motions of the reference lidar and one target
    lidar, fixed capacity."""

    ref_q: torch.Tensor  # [N, 4]
    ref_t: torch.Tensor  # [N, 3]
    tgt_q: torch.Tensor  # [N, 4]
    tgt_t: torch.Tensor  # [N, 3]
    mask: torch.Tensor   # [N] bool
    head: torch.Tensor   # scalar int32 write cursor

    @staticmethod
    def empty(n: int, device=None) -> "MotionBuffer":
        ident = rot.quat_identity(device=device).expand(n, 4).clone()
        return MotionBuffer(
            ref_q=ident,
            ref_t=torch.zeros((n, 3), device=device),
            tgt_q=ident.clone(),
            tgt_t=torch.zeros((n, 3), device=device),
            mask=torch.zeros((n,), dtype=torch.bool, device=device),
            head=torch.tensor(0, dtype=torch.int32, device=device),
        )


def screw_consistent(ref: Pose, tgt: Pose, eps_r: float = 0.05,
                     eps_t: float = 0.1) -> torch.Tensor:
    """Screw-motion congruence test: rigidly mounted sensors see the same
    rotation angle and the same screw translation d = t·axis."""
    log_r, log_t = rot.so3_log(ref.q), rot.so3_log(tgt.q)
    ang_r = torch.linalg.norm(log_r, dim=-1)
    ang_t = torch.linalg.norm(log_t, dim=-1)
    axis_r = log_r / torch.clamp(ang_r[..., None], min=1e-9)
    axis_t = log_t / torch.clamp(ang_t[..., None], min=1e-9)
    d_r = torch.sum(ref.t * axis_r, -1)
    d_t = torch.sum(tgt.t * axis_t, -1)
    return (torch.abs(ang_r - ang_t) < eps_r) & (torch.abs(d_r - d_t) < eps_t)


def add_pair(buf: MotionBuffer, ref: Pose, tgt: Pose,
             eps_r: float = 0.05, eps_t: float = 0.1) -> MotionBuffer:
    """Append one motion pair if screw-consistent (ring overwrite at
    capacity: the freshest pairs are kept). Branch-free on the device."""
    ok = screw_consistent(ref, tgt, eps_r, eps_t)
    n = buf.mask.shape[0]
    slot = (torch.arange(n, device=buf.mask.device) == buf.head % n) & ok

    def write(arr, v):
        return torch.where(slot[:, None], v[None, :], arr)

    return MotionBuffer(
        ref_q=write(buf.ref_q, ref.q),
        ref_t=write(buf.ref_t, ref.t),
        tgt_q=write(buf.tgt_q, tgt.q),
        tgt_t=write(buf.tgt_t, tgt.t),
        mask=buf.mask | slot,
        head=torch.where(ok, buf.head + 1, buf.head),
    )


def quat_left_matrix(q: torch.Tensor) -> torch.Tensor:
    """L(q): q ⊗ p = L(q) p, scalar-first. [..., 4] -> [..., 4, 4]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m = torch.stack([
        w, -x, -y, -z,
        x, w, -z, y,
        y, z, w, -x,
        z, -y, x, w,
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (4, 4))


def quat_right_matrix(q: torch.Tensor) -> torch.Tensor:
    """R(q): p ⊗ q = R(q) p, scalar-first."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m = torch.stack([
        w, -x, -y, -z,
        x, w, z, -y,
        y, -z, w, x,
        z, y, -x, w,
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (4, 4))


class RotationSolution(NamedTuple):
    q_ext: torch.Tensor       # [4]
    sigma2: torch.Tensor      # second-smallest singular value (gate)
    converged: torch.Tensor   # bool


def solve_rotation(buf: MotionBuffer, sv_threshold: float = 0.25,
                   irls_rounds: int = 2) -> RotationSolution:
    """SVD of the Huber-weighted stacked system (L(q_ref) - R(q_tgt)) q = 0.

    Convergence gate: second-smallest singular value > threshold (the
    rotation is fully observable only with rotations about >= 2 axes).
    """
    A_blocks = quat_left_matrix(buf.ref_q) - quat_right_matrix(buf.tgt_q)  # [N,4,4]
    m = buf.mask.to(A_blocks.dtype)
    w = m
    for _ in range(irls_rounds):
        A = (A_blocks * w[:, None, None]).reshape(-1, 4)
        _, s, vh = torch.linalg.svd(A, full_matrices=False)
        q = vh[3]
        # angular residual per pair -> huber reweight
        res = torch.linalg.norm(torch.einsum("nij,j->ni", A_blocks, q), dim=-1)
        ang = 2.0 * res  # small-angle proportionality
        delta = 0.1
        w = m * torch.where(ang <= delta, 1.0,
                            delta / torch.clamp(ang, min=1e-12))

    q = q * torch.where(q[0] < 0, -1.0, 1.0)
    n_valid = torch.sum(buf.mask)
    return RotationSolution(
        q_ext=rot.quat_normalize(q),
        sigma2=s[2],
        converged=(s[2] > sv_threshold) & (n_valid >= 10),
    )


def _normal_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Least squares of the stacked [N, m, d] blocks against [N, m]."""
    d = A.shape[-1]
    AtA = torch.einsum("nij,nik->jk", A, A)
    Atb = torch.einsum("nij,ni->j", A, b)
    eye = torch.eye(d, dtype=A.dtype, device=A.device)
    return torch.linalg.solve(AtA + 1e-6 * eye, Atb)


def solve_translation(buf: MotionBuffer, q_ext: torch.Tensor) -> torch.Tensor:
    """LSQ of (R_ref - I) t_ext = R_ext t_tgt - t_ref over valid pairs."""
    R_ref = rot.quat_to_matrix(buf.ref_q)            # [N, 3, 3]
    eye = torch.eye(3, dtype=R_ref.dtype, device=R_ref.device)
    mf = buf.mask.to(R_ref.dtype)
    A = (R_ref - eye) * mf[:, None, None]
    b = (rot.quat_rotate(q_ext[None], buf.tgt_t) - buf.ref_t) * mf[:, None]
    return _normal_solve(A, b)


def solve_translation_planar(buf: MotionBuffer, q_ext: torch.Tensor):
    """Planar 4-DoF variant: solves (x, y, yaw) with z unobservable.

    Unknowns [tx, ty, cosγ, sinγ] (the unit constraint relaxed to LSQ, then
    normalized). From (R_ref - I) t_X = R_yaw(γ) u - t_ref with
    u = R_0 t_tgt:  J1 [tx,ty] - [[ux,-uy],[uy,ux]] [cosγ,sinγ] = -t_ref|xy.
    Returns (t_ext as [3] with z = 0, yaw adjustment quaternion [4]).
    """
    R_ref = rot.quat_to_matrix(buf.ref_q)
    u = rot.quat_rotate(q_ext[None], buf.tgt_t)
    eye2 = torch.eye(2, dtype=R_ref.dtype, device=R_ref.device)
    J1 = R_ref[:, :2, :2] - eye2                        # [N, 2, 2]
    J2 = torch.stack([
        torch.stack([u[:, 0], -u[:, 1]], -1),
        torch.stack([u[:, 1], u[:, 0]], -1),
    ], dim=1)                                            # [N, 2, 2]
    mf = buf.mask.to(R_ref.dtype)
    A = torch.cat([J1, -J2], dim=-1) * mf[:, None, None]  # [N, 2, 4]
    b = -buf.ref_t[:, :2] * mf[:, None]
    x = _normal_solve(A, b)
    t_xy = torch.cat([x[:2], torch.zeros_like(x[:1])])
    ab = x[2:] / torch.clamp(torch.linalg.norm(x[2:]), min=1e-9)
    yaw = torch.atan2(ab[1], ab[0])
    z_axis = torch.tensor([0.0, 0.0, 1.0], dtype=x.dtype, device=x.device)
    return t_xy, rot.so3_exp_quat(z_axis * yaw)


def calibrate(buf: MotionBuffer, planar: bool = False,
              sv_threshold: float = 0.25) -> tuple[Pose, RotationSolution]:
    """Full init: rotation then translation. Returns (extrinsic base<-lidar,
    rotation diagnostics)."""
    rsol = solve_rotation(buf, sv_threshold=0.05 if planar else sv_threshold)
    if planar:
        t_xy, q_yaw = solve_translation_planar(buf, rsol.q_ext)
        q = rot.quat_normalize(rot.quat_multiply(q_yaw, rsol.q_ext))
        return Pose(q, t_xy), rsol
    return Pose(rsol.q_ext, solve_translation(buf, rsol.q_ext)), rsol
