"""SE(3) pose algebra on a NamedTuple of tensors.

Counterpart of ``mloam_tpu/core/se3.py``: quaternion + translation with
compose/inverse/log/exp, Lie-algebra mean pose and slerp interpolation for
motion de-skew.

Tangent convention: xi = [rho (trans), phi (rot)] in R^6, *right* perturbation
  T ⊞ xi = T ∘ Exp(xi).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mloam_tpu_torch.core import rotations as rot


class Pose(NamedTuple):
    """Batched SE(3) pose: q [..., 4] scalar-first quaternion, t [..., 3]."""

    q: torch.Tensor
    t: torch.Tensor

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device=None) -> "Pose":
        batch_shape = tuple(batch_shape)
        q = rot.quat_identity(dtype, device).expand(batch_shape + (4,)).clone()
        t = torch.zeros(batch_shape + (3,), dtype=dtype, device=device)
        return Pose(q, t)

    @property
    def batch_shape(self):
        return tuple(self.q.shape[:-1])

    def matrix(self) -> torch.Tensor:
        """[..., 4, 4] homogeneous transform."""
        R = rot.quat_to_matrix(self.q)
        top = torch.cat([R, self.t[..., :, None]], dim=-1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=self.q.dtype,
                              device=self.q.device).expand(top.shape[:-2] + (1, 4))
        return torch.cat([top, bottom], dim=-2)


def from_matrix(T: torch.Tensor) -> Pose:
    return Pose(rot.matrix_to_quat(T[..., :3, :3]), T[..., :3, 3])


def compose(a: Pose, b: Pose) -> Pose:
    """a ∘ b (apply b first, then a)."""
    return Pose(
        rot.quat_normalize(rot.quat_multiply(a.q, b.q)),
        rot.quat_rotate(a.q, b.t) + a.t,
    )


def inverse(p: Pose) -> Pose:
    qinv = rot.quat_conjugate(p.q)
    return Pose(qinv, -rot.quat_rotate(qinv, p.t))


def relative(a: Pose, b: Pose) -> Pose:
    """a⁻¹ ∘ b."""
    return compose(inverse(a), b)


def transform_points(p: Pose, pts: torch.Tensor) -> torch.Tensor:
    """Apply pose to points [..., 3] (pose batch dims broadcast)."""
    return rot.quat_rotate(p.q[..., None, :], pts) + p.t[..., None, :]


def exp(xi: torch.Tensor) -> Pose:
    """se(3) exp: xi = [rho, phi] [..., 6] -> Pose, t = J_l(phi) rho."""
    rho, phi = xi[..., :3], xi[..., 3:]
    q = rot.so3_exp_quat(phi)
    J = rot.so3_left_jacobian(phi)
    t = (J @ rho[..., None])[..., 0]
    return Pose(q, t)


def log(p: Pose) -> torch.Tensor:
    """Pose -> [..., 6] = [rho, phi] with t = J_l(phi) rho."""
    phi = rot.so3_log(p.q)
    Jinv = rot.so3_left_jacobian_inv(phi)
    rho = (Jinv @ p.t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def boxplus(p: Pose, xi: torch.Tensor) -> Pose:
    """Right-perturbation retraction T ∘ Exp(xi)."""
    return compose(p, exp(xi))


def boxminus(a: Pose, b: Pose) -> torch.Tensor:
    """Log(b⁻¹ ∘ a): tangent taking b to a under right perturbation."""
    return log(relative(b, a))


def adjoint(p: Pose) -> torch.Tensor:
    """[..., 6, 6] adjoint Ad_T = [[R, [t]ₓR], [0, R]], tangent order
    [rho, phi]."""
    R = rot.quat_to_matrix(p.q)
    tR = rot.skew(p.t) @ R
    Z = torch.zeros_like(R)
    top = torch.cat([R, tR], dim=-1)
    bot = torch.cat([Z, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def interpolate(p0: Pose, p1: Pose, s) -> Pose:
    """Pose interpolation: slerp rotation, lerp translation."""
    s = torch.as_tensor(s, dtype=p0.q.dtype, device=p0.q.device)
    q = rot.quat_slerp(p0.q, p1.q, s)
    t = p0.t + s[..., None] * (p1.t - p0.t)
    return Pose(q, t)


def scale(p: Pose, s) -> Pose:
    """Fractional pose: identity-to-p interpolation by factor s in [0,1]."""
    return interpolate(
        Pose.identity(p.batch_shape, p.q.dtype, p.q.device), p, s)


def mean_pose(poses: Pose, weights: torch.Tensor | None = None,
              iters: int = 5) -> Pose:
    """Weighted Lie mean over the leading axis (iterated tangent mean, a
    fixed number of rounds)."""
    n = poses.q.shape[0]
    if weights is None:
        weights = torch.ones((n,), dtype=poses.q.dtype, device=poses.q.device)
    w = weights / torch.clamp(torch.sum(weights), min=1e-12)

    mu = Pose(poses.q[0], poses.t[0])
    for _ in range(iters):
        xi = boxminus(poses, Pose(mu.q[None], mu.t[None]))
        delta = torch.sum(w[:, None] * xi, dim=0)
        mu = boxplus(mu, delta)
    return mu


def tangent_scatter(poses: Pose, mu: Pose,
                    weights: torch.Tensor | None = None) -> torch.Tensor:
    """6x6 scatter (covariance) of poses about mu in the tangent space at mu."""
    n = poses.q.shape[0]
    if weights is None:
        weights = torch.ones((n,), dtype=poses.q.dtype, device=poses.q.device)
    w = weights / torch.clamp(torch.sum(weights), min=1e-12)
    xi = boxminus(poses, Pose(mu.q[None], mu.t[None]))
    return torch.einsum("n,ni,nj->ij", w, xi, xi)
