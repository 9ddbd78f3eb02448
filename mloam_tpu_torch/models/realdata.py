"""Robust fitting with the product solver, and the stand-in problems the
port's checks run it on.

Counterpart of ``mloam_tpu/models/realdata.py``: ``fit_robust`` (the
reference's ``ceres_robust_curve_fitting.cpp``: an exponential or a quintic
fitted with trivial / huber / gm losses, or gnc_gm with the reference's
outer μ schedule) on ``solver/gauss_newton``, and ``load_xy``. The JAX
package's three programs (``curve``, ``nonconvex``, ``bal``) read the
reference's data files, which are not in this repository; they are not
here. In their place the checks run the solvers on problems made from a
seed: ``synthetic_curve`` (exp(0.3x + 0.1) with outliers),
``synthetic_quintic`` (4x⁵ − 2x⁴ + 3x³ − 4x² + 5x − 6 with heavy outliers)
and ``synthetic_bal`` (a ring of Snavely cameras around a point cloud, the
shape of ``problem-49-7776-pre.txt`` by default).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mloam_tpu_torch import resolve_device
from mloam_tpu_torch.solver import robust
from mloam_tpu_torch.solver.bal import snavely_residual
from mloam_tpu_torch.solver.gauss_newton import gauss_newton

CURVE_GT = (0.3, 0.1)
QUINTIC_GT = (4.0, -2.0, 3.0, -4.0, 5.0, -6.0)


def load_xy(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(x, y) float32 columns of a comma-separated file with one header
    line (the reference's ``data_*_fitting.txt`` format)."""
    d = np.loadtxt(path, delimiter=",", skiprows=1)
    return d[:, 0].astype(np.float32), d[:, 1].astype(np.float32)


def fit_robust(x: np.ndarray, y: np.ndarray, model: str, loss: str,
               scale: float, iters: int = 30, p_init=None,
               device=None) -> np.ndarray:
    """Fit with the product ``gauss_newton``. ``model``: 'exp' (params m, c)
    or 'quintic' (6 coefficients, highest power first). GNC runs the
    reference's outer schedule: one fixed-μ solve of 10 iterations per outer
    round, μ₀ → μ/1.4 until μ < 1, then a final polish at μ = 1, from the
    adaptive seed μ₀ = max(100 · max r² / c², 6) (the reference's own
    commented-out rule with 100x headroom: the shipped μ₀ = 6 is not near
    convex on such data); ``iters`` is the other losses' iteration count."""
    device = resolve_device(device)
    xj = torch.as_tensor(np.asarray(x, np.float32), device=device)
    yj = torch.as_tensor(np.asarray(y, np.float32), device=device)
    if model == "exp":
        dim = 2

        def predict(p):
            return torch.exp(p[0] * xj + p[1])
    elif model == "quintic":
        dim = 6
        powers = torch.stack([xj ** k for k in (5, 4, 3, 2, 1, 0)], -1)

        def predict(p):
            return powers @ p
    else:
        raise ValueError(model)
    p0 = (torch.zeros(dim, device=device) if p_init is None
          else torch.as_tensor(np.asarray(p_init, np.float32), device=device))

    def residual_fn(p, mu=1.0):
        r = yj - predict(p)
        w = robust.loss_weight(r * r, loss, delta=scale, gm_c=scale, gnc_mu=mu)
        return r, w

    def retract(p, dx):
        return p + dx

    def const(m):
        return lambda i: m

    if loss == "gnc_gm":
        p = p0
        r0, _ = residual_fn(p, 1.0)
        mu = max(100.0 * float(torch.max(r0 * r0)) / (scale * scale), 6.0)
        while mu >= 1.0:
            p = gauss_newton(residual_fn, p, retract, dim=dim, iters=10,
                             mu_schedule=const(mu)).x
            mu /= 1.4
        p = gauss_newton(residual_fn, p, retract, dim=dim, iters=10,
                         mu_schedule=const(1.0)).x
        return p.cpu().numpy()
    st = gauss_newton(lambda p: residual_fn(p), p0, retract, dim=dim, iters=iters)
    return st.x.cpu().numpy()


def synthetic_curve(seed: int = 0, n: int = 201, noise: float = 0.2,
                    outlier_share: float = 0.05):
    """(x, y) float32: y = exp(0.3 x + 0.1) + N(0, noise²) on x in [0, 5],
    with a share of the samples moved by ±U(2, 6) (the shape of the
    reference's ``data_curve_fitting.txt``)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 5.0, n)
    y = np.exp(CURVE_GT[0] * x + CURVE_GT[1]) + noise * rng.standard_normal(n)
    out = rng.random(n) < outlier_share
    y[out] += rng.choice([-1.0, 1.0], out.sum()) * rng.uniform(2.0, 6.0, out.sum())
    return x.astype(np.float32), y.astype(np.float32)


def synthetic_quintic(seed: int = 0, n: int = 401, noise: float = 0.5,
                      outlier_share: float = 0.1):
    """(x, y) float32 on x in [-2, 2]: the quintic plus N(0, noise²) (median
    |r| ~0.34), and a share of the samples moved by ±10^U(1, 5) (outliers to
    1e5, as in the reference's ``data_non_convex_fitting.txt``)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-2.0, 2.0, n)
    y = np.polyval(QUINTIC_GT, x) + noise * rng.standard_normal(n)
    out = rng.random(n) < outlier_share
    y[out] += rng.choice([-1.0, 1.0], out.sum()) * 10.0 ** rng.uniform(1, 5, out.sum())
    return x.astype(np.float32), y.astype(np.float32)


def _look_at(center: np.ndarray) -> np.ndarray:
    """World-to-camera rotation of a camera at ``center`` whose -z axis
    points at the origin (BAL's negative-z convention)."""
    z = center / np.linalg.norm(center)
    x = np.cross([0.0, 0.0, 1.0], z)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z])


def _angle_axis(R: np.ndarray) -> np.ndarray:
    ang = math.acos(np.clip((np.trace(R) - 1) / 2, -1, 1))
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return v * (ang / (2 * math.sin(ang))) if ang > 1e-9 else 0.5 * v


def synthetic_bal(seed: int = 0, n_cams: int = 49, n_pts: int = 7776,
                  n_obs: int = 31843, pixel_noise: float = 0.65,
                  rot_noise: float = 0.02, pos_noise: float = 0.2):
    """A BAL problem from a seed: ``n_cams`` Snavely cameras on a ring of
    radius 20 m (heights ±2 m, f ≈ 800, k1 ≈ -0.05, k2 ≈ 0.01) looking at
    ``n_pts`` points in a 5 m ball, each point seen by 4 or 5 cameras two
    ring steps apart (``n_obs`` observations in all), observed with
    ``pixel_noise`` px. The initial parameters are the truth perturbed
    (rotation ``rot_noise`` rad, translation and points ``pos_noise`` m,
    focal 1 %), as a bundler's initial estimate is. Returns numpy
    (cams [C, 9], pts [P, 3], cam_idx, pt_idx, obs [N, 2]) of the initial
    problem, and the true (cams, pts)."""
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(n_cams) / n_cams
    centers = np.stack([20 * np.cos(ang), 20 * np.sin(ang),
                        rng.uniform(-2, 2, n_cams)], -1)
    cams = np.zeros((n_cams, 9))
    for c in range(n_cams):
        R = _look_at(centers[c])
        cams[c, :3] = _angle_axis(R)
        cams[c, 3:6] = -R @ centers[c]
    cams[:, 6] = rng.uniform(780, 820, n_cams)
    cams[:, 7] = rng.uniform(-0.06, -0.04, n_cams)
    cams[:, 8] = rng.uniform(0.005, 0.015, n_cams)
    d = rng.standard_normal((n_pts, 3))
    pts = d / np.linalg.norm(d, axis=1, keepdims=True) * 5 * rng.random((n_pts, 1)) ** (1 / 3)
    k = np.full(n_pts, n_obs // n_pts)
    k[rng.permutation(n_pts)[:n_obs - k.sum()]] += 1
    start = rng.integers(0, n_cams, n_pts)
    pt_idx = np.repeat(np.arange(n_pts), k)
    within = np.arange(k.sum()) - np.repeat(np.cumsum(k) - k, k)
    cam_idx = (np.repeat(start, k) + 2 * within) % n_cams
    proj = snavely_residual(torch.as_tensor(cams[cam_idx]), torch.as_tensor(pts[pt_idx]),
                            torch.zeros((len(pt_idx), 2), dtype=torch.float64)).numpy()
    obs = proj + pixel_noise * rng.standard_normal(proj.shape)
    init = cams.copy()
    init[:, :3] += rot_noise * rng.standard_normal((n_cams, 3))
    init[:, 3:6] += pos_noise * rng.standard_normal((n_cams, 3))
    init[:, 6] *= 1 + 0.01 * rng.standard_normal(n_cams)
    init_pts = pts + pos_noise * rng.standard_normal(pts.shape)
    return (init, init_pts, cam_idx, pt_idx, obs), (cams, pts)
