"""Quaternion / SO(3) primitives.

Convention: quaternions are stored as ``[w, x, y, z]`` (scalar first), unit
norm, acting on column vectors by ``R(q) @ v``. All functions are plain torch,
broadcast over leading batch dimensions, differentiable (forward and reverse)
and free of data-dependent Python branches.

Counterpart of ``mloam_tpu/core/rotations.py``, function by function.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    # filled on the device: a tensor built from a host list (or an element
    # set from a Python number) is a copy from pageable memory, which waits
    # for the device's stream
    q = torch.zeros((4,), dtype=dtype, device=device)
    q[:1].fill_(1.0)
    return q


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=_EPS)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b (both [..., 4], scalar-first)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # written out: broadcasts like jnp.cross and stays cheap under func
    # transforms
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v [..., 3] by quaternions q [..., 4].

    Uses the 15-mul expansion (t = 2 q_v x v; v' = v + w t + q_v x t).
    """
    qw = q[..., :1]
    qv = q[..., 1:]
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] -> [..., 3, 3] rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] scalar-first quaternion (branch-free Shepperd).

    Computes all four candidate quaternions and selects the numerically best
    (largest pivot) by gather — no data-dependent branching.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)

    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4 candidates, 4]
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = quat_normalize(q)
    # canonicalize sign: w >= 0
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def so3_exp_quat(phi: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> quaternion; Taylor-safe near 0."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    half = 0.5 * theta
    small = theta2 < 1e-8
    # sin(t/2)/t: exact vs 2nd-order Taylor 0.5 - t^2/48
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return quat_normalize(torch.cat([w, k * phi], dim=-1))


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [..., 4] -> axis-angle [..., 3]; Taylor-safe near identity.

    AD-safe at the identity: the vector norm is guarded with the double-where
    pattern so jacfwd/jacrev produce finite derivatives when v == 0 (a plain
    ``norm`` has a NaN gradient at zero, which would poison GN linearizations
    of priors evaluated exactly at their linearization point).
    """
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)  # shortest arc
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vnorm2 = torch.sum(v * v, dim=-1, keepdim=True)
    small = vnorm2 < 1e-12
    vnorm_safe = torch.sqrt(torch.where(small, torch.ones_like(vnorm2), vnorm2))
    theta = 2.0 * torch.atan2(vnorm_safe, w)
    # theta/vnorm ~ 2/w - 2 vnorm^2/(3 w^3) near zero (atan2 series)
    wc = torch.clamp(w, min=0.5)
    scale = torch.where(
        small,
        2.0 / wc - 2.0 * vnorm2 / (3.0 * wc ** 3),
        theta / vnorm_safe,
    )
    return scale * v


def so3_exp_matrix(phi: torch.Tensor) -> torch.Tensor:
    return quat_to_matrix(so3_exp_quat(phi))


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, s) -> torch.Tensor:
    """Spherical interpolation from q0 (s=0) to q1 (s=1); shortest arc.

    Implemented via the Lie-algebra form q0 ⊗ exp(s·log(q0⁻¹⊗q1)).
    """
    s = torch.as_tensor(s, dtype=q0.dtype, device=q0.device)
    dq = quat_multiply(quat_conjugate(q0), q1)
    phi = so3_log(dq)
    return quat_multiply(q0, so3_exp_quat(s[..., None] * phi))


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l of SO(3) at phi [..., 3] -> [..., 3, 3].

    J_l = I + (1-cosθ)/θ² [φ]ₓ + (θ-sinθ)/θ³ [φ]ₓ²  (Taylor-safe).
    """
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    S = skew(phi)
    S2 = S @ S
    small = theta2 < 1e-8
    a = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS))
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / torch.clamp(theta2 * theta, min=_EPS))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + a * S + b * S2


def so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian J_l⁻¹ (Taylor-safe)."""
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    S = skew(phi)
    S2 = S @ S
    small = theta2 < 1e-8
    half = 0.5 * theta
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half), min=_EPS))
        / torch.clamp(theta2, min=_EPS),
    )
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye - 0.5 * S + cot_term * S2
