"""The plain reference of the pose-graph cells: damped Gauss-Newton over
keyframe poses, written from the problem's definition and independent of
the program under test.

Poses are rotation matrices and translations. An edge i -> j with measured
relative pose Z has the residual

    r = w * Log(Z^-1 T_i^-1 T_j),   Log = [Jl(phi)^-1 t, phi],

and a pose moves by the right perturbation T Exp(xi), xi = [rho, phi],
Exp = (exp(phi), Jl(phi) rho). Each edge's Jacobian [6, 12] is taken by
autograd of that one edge's residual (``torch.func.vmap`` of ``jacrev``);
the dense normal equations are summed with ``index_add_``; pose ``anchor``
carries a prior of weight ``anchor_w`` on its diagonal,
Marquardt damping ``lm_lambda * (diag + 1e-3)`` and a jitter of 1e-8 are
added to the diagonal, and each step is one ``torch.linalg.solve``.

Nothing here imports the program; it runs in any floating dtype (float64
for the comparison, float32 for the control).
"""

from __future__ import annotations

import torch

# below this squared angle the closed forms give way to their series
_SMALL = 1e-4


def hat(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _coeffs(phi: torch.Tensor):
    """(theta^2, sin(th)/th, (1-cos th)/th^2, (th-sin th)/th^3) of rotation
    vectors, each by its series near 0 (the closed forms' branch fed a safe
    angle there, so no derivative is NaN)."""
    t2 = torch.sum(phi * phi, -1)
    small = t2 < _SMALL
    t2s = torch.where(small, torch.ones_like(t2), t2)
    th = torch.sqrt(t2s)
    a = torch.where(small, 1 - t2 / 6 + t2 * t2 / 120, torch.sin(th) / th)
    b = torch.where(small, 0.5 - t2 / 24 + t2 * t2 / 720,
                    2 * torch.sin(th / 2) ** 2 / t2s)
    c = torch.where(small, 1 / 6 - t2 / 120 + t2 * t2 / 5040, (th - torch.sin(th)) / (t2s * th))
    return t2, a, b, c


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    _, a, b, _ = _coeffs(phi)
    K = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    _, _, b, c = _coeffs(phi)
    K = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + b[..., None, None] * K + c[..., None, None] * (K @ K)


def left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    t2 = torch.sum(phi * phi, -1)
    small = t2 < _SMALL
    t2s = torch.where(small, torch.ones_like(t2), t2)
    th = torch.sqrt(t2s)
    d = torch.where(small, 1 / 12 + t2 / 720 + t2 * t2 / 30240,
                    1 / t2s - (1 + torch.cos(th)) / (2 * th * torch.sin(th)))
    K = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye - 0.5 * K + d[..., None, None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation vectors of rotation matrices (angles below pi)."""
    v = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], -1)
    c = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1)
    s2 = torch.sum(v * v, -1)
    small = s2 < _SMALL * _SMALL
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    k = torch.where(small, 1 + s2 / 6, torch.atan2(s, c) / s)
    return k[..., None] * v


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrices of (w, x, y, z) quaternions (normalised first)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)], -2)


def perturb(R, t, xi):
    """T Exp(xi): the pose (R, t) moved by xi = [rho, phi] on the right."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return (R @ so3_exp(phi),
            t + (R @ (left_jacobian(phi) @ rho[..., None]))[..., 0])


def edge_residual(xi, Ri, ti, Rj, tj, Zr, Zt):
    """[6] unweighted residual Log(Z^-1 Ti^-1 Tj) of one edge, its poses
    moved by xi = [xi_i, xi_j]."""
    Ri, ti = perturb(Ri, ti, xi[:6])
    Rj, tj = perturb(Rj, tj, xi[6:])
    R = Zr.transpose(-1, -2) @ (Ri.transpose(-1, -2) @ Rj)
    t = Zr.transpose(-1, -2) @ (Ri.transpose(-1, -2) @ (tj - ti) - Zt)
    phi = so3_log(R)
    return torch.cat([left_jacobian_inv(phi) @ t, phi], -1)


_edge_jac = torch.func.vmap(torch.func.jacrev(edge_residual),
                            in_dims=(None, 0, 0, 0, 0, 0, 0))
_edge_res = torch.func.vmap(edge_residual, in_dims=(None, 0, 0, 0, 0, 0, 0))


class Graph:
    """A pose graph's edges in the reference's dtype: i, j [E], Z as
    (Zr [E, 3, 3], Zt [E, 3]) from the measured quaternions, weight [E, 6]."""

    def __init__(self, i, j, z_q, z_t, weight, dtype):
        self.i, self.j = i.long(), j.long()
        self.Zr = quat_to_matrix(z_q.to(dtype))
        self.Zt = z_t.to(dtype)
        self.w = weight.to(dtype)


def linearize(R, t, g: Graph):
    """Weighted residuals [E, 6] and Jacobians [E, 6, 12] of every edge."""
    args = (R[g.i], t[g.i], R[g.j], t[g.j], g.Zr, g.Zt)
    xi0 = torch.zeros(12, dtype=R.dtype, device=R.device)
    r = _edge_res(xi0, *args)
    J = _edge_jac(xi0, *args)
    return g.w * r, g.w[..., None] * J


def step(R, t, g: Graph, anchor: int = 0, anchor_w: float = 1e3, lm_lambda: float = 1e-3):
    """One damped Gauss-Newton step over every pose: (R, t) moved."""
    n = R.shape[0]
    dim = 6 * n
    r, J = linearize(R, t, g)
    Ji, Jj = J[..., :6], J[..., 6:]
    Jit, Jjt = Ji.transpose(-1, -2), Jj.transpose(-1, -2)
    ar = torch.arange(6, device=R.device)
    ri = (6 * g.i)[:, None] + ar          # [E, 6] tangent rows of pose i
    rj = (6 * g.j)[:, None] + ar

    def flat(rows, cols):                 # [E, 36] flat indices into H
        return (rows[:, :, None] * dim + cols[:, None, :]).reshape(-1)

    H = torch.zeros(dim * dim, dtype=R.dtype, device=R.device)
    H.index_add_(0, flat(ri, ri), (Jit @ Ji).reshape(-1))
    H.index_add_(0, flat(rj, rj), (Jjt @ Jj).reshape(-1))
    H.index_add_(0, flat(ri, rj), (Jit @ Jj).reshape(-1))
    H.index_add_(0, flat(rj, ri), (Jjt @ Ji).reshape(-1))
    H = H.view(dim, dim)
    b = torch.zeros(dim, dtype=R.dtype, device=R.device)
    b.index_add_(0, ri.reshape(-1), (Jit @ r[..., None]).reshape(-1))
    b.index_add_(0, rj.reshape(-1), (Jjt @ r[..., None]).reshape(-1))
    d = H.diagonal()
    d[6 * anchor:6 * anchor + 6] += anchor_w
    d += lm_lambda * (d + 1e-3)
    d += 1e-8
    dx = -torch.linalg.solve(H, b)
    del H
    return perturb(R, t, dx.view(n, 6))


def solve(R, t, g: Graph, steps: int):
    """``steps`` damped Gauss-Newton steps from (R, t)."""
    for _ in range(steps):
        R, t = step(R, t, g)
    return R, t


def pose_gaps(R_a, t_a, R_b, t_b):
    """Per pose: translation gap (m) and the angle (rad) of the rotation
    taking one to the other, in float64."""
    R_a, t_a, R_b, t_b = (x.double() for x in (R_a, t_a, R_b, t_b))
    dt = torch.linalg.norm(t_a - t_b, dim=-1)
    M = R_b.transpose(-1, -2) @ R_a
    v = 0.5 * torch.stack([M[..., 2, 1] - M[..., 1, 2], M[..., 0, 2] - M[..., 2, 0],
                           M[..., 1, 0] - M[..., 0, 1]], -1)
    c = 0.5 * (M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2] - 1)
    return dt, torch.atan2(torch.linalg.norm(v, dim=-1), c)
