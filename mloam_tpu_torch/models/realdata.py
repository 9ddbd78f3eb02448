"""Real-data validation programs: the solver stack on the reference's data
files, read from a directory the caller names.

Counterpart of ``mloam_tpu/models/realdata.py``. Programs (the summary lands
in ``results_torch/realdata/summary.json`` under the current directory):

  curve      robust exponential fit y = exp(m x + c) on
             ``data_curve_fitting.txt`` (ground truth m = 0.3, c = 0.1, the
             reference program's ``ceres_robust_curve_fitting.cpp:84-85``):
             trivial 1.0, huber 0.5, gm 1.0 (warm-started from huber's fit)
             and gnc_gm 1.0 with the reference's outer μ schedule.
  nonconvex  robust quintic fit on ``data_non_convex_fitting.txt`` (ground
             truth 4x⁵ − 2x⁴ + 3x³ − 4x² + 5x − 6): trivial 1.0, huber 2.0,
             gm 5.0 (warm from huber) and gnc_gm 5.0.
  bal        bundle adjustment on ``problem-49-7776-pre.txt`` (the reference's
             ``bundle_adjuster.cc``): 25 LM iterations with the trivial loss,
             25 with huber at scale 2.0, and the observation-sharded
             assembly against the dense one on a mesh (the CLI passes the
             stacked 8-shard mesh, ``parallel/mesh.make_mesh(8)``; the JAX
             program shards over every device it sees when there are two or
             more).

The data directory has no default, and a missing file raises
``FileNotFoundError`` naming it: nothing is made up in its place. Besides
the programs, ``fit_robust`` (the curve fits' solver) and stand-in problems
made from a seed in the reference files' shapes, which the checks write in
the reference's formats: ``synthetic_curve`` (exp(0.3x + 0.1) with
outliers), ``synthetic_quintic`` (the quintic with heavy outliers) and
``synthetic_bal`` (a ring of Snavely cameras around a point cloud, the shape
of ``problem-49-7776-pre.txt`` by default).

Usage (runs on the GPU unless ``--device cpu``):
    python -m mloam_tpu_torch.models.realdata {curve,nonconvex,bal,all} --data-dir DIR
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from mloam_tpu_torch import resolve_device
from mloam_tpu_torch.parallel import mesh as M
from mloam_tpu_torch.solver import bal as BAL
from mloam_tpu_torch.solver import robust
from mloam_tpu_torch.solver.gauss_newton import gauss_newton

CURVE_GT = (0.3, 0.1)
QUINTIC_GT = (4.0, -2.0, 3.0, -4.0, 5.0, -6.0)
CURVE_FILE = "data_curve_fitting.txt"
NONCONVEX_FILE = "data_non_convex_fitting.txt"
BAL_FILE = "problem-49-7776-pre.txt"
# (loss, scale) in the order the programs fit them; gm starts from huber's fit
CURVE_LOSSES = (("trivial", 1.0), ("huber", 0.5), ("gm", 1.0), ("gnc_gm", 1.0))
QUINTIC_LOSSES = (("trivial", 1.0), ("huber", 2.0), ("gm", 5.0), ("gnc_gm", 5.0))
BAL_ITERS = 25
BAL_HUBER_SCALE = 2.0
OUTDIR = "results_torch"


def load_xy(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(x, y) float32 columns of a comma-separated file with one header
    line (the reference's ``data_*_fitting.txt`` format)."""
    d = np.loadtxt(path, delimiter=",", skiprows=1)
    return d[:, 0].astype(np.float32), d[:, 1].astype(np.float32)


def write_xy(path: str, x, y):
    """Write (x, y) in the format ``load_xy`` reads: a header line, then one
    ``x,y`` line a sample, float32 values exactly (9 significant digits)."""
    with open(path, "w") as f:
        f.write("x,y\n")
        f.write("".join(f"{a:.9g},{b:.9g}\n" for a, b in
                        zip(np.asarray(x, np.float32), np.asarray(y, np.float32))))


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
    proj = BAL.snavely_residual(torch.as_tensor(cams[cam_idx]), torch.as_tensor(pts[pt_idx]),
                            torch.zeros((len(pt_idx), 2), dtype=torch.float64)).numpy()
    obs = proj + pixel_noise * rng.standard_normal(proj.shape)
    init = cams.copy()
    init[:, :3] += rot_noise * rng.standard_normal((n_cams, 3))
    init[:, 3:6] += pos_noise * rng.standard_normal((n_cams, 3))
    init[:, 6] *= 1 + 0.01 * rng.standard_normal(n_cams)
    init_pts = pts + pos_noise * rng.standard_normal(pts.shape)
    return (init, init_pts, cam_idx, pt_idx, obs), (cams, pts)


# ----------------------------------------------------------------- programs

def _data_file(data_dir: str, name: str) -> str:
    path = os.path.join(data_dir, name)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {name} in the data directory {data_dir!r}: {path}")
    return path


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)


def _ladder(x, y, model: str, losses, device) -> list:
    """[(loss, params)] fitted in ``losses`` order; gm starts from huber's
    fit (plain GM stalls from the cold start, the part Ceres's warm state
    plays in the reference), gnc_gm from the cold start."""
    fits, warm = [], None
    for loss, scale in losses:
        p = fit_robust(x, y, model, loss, scale, p_init=warm if loss == "gm" else None,
                       device=device)
        if loss == "huber":
            warm = p
        fits.append((loss, p))
    return fits


def curve_program(data_dir: str, device=None) -> dict:
    """The robust exponential fits of ``data_curve_fitting.txt``: m, c and
    their distance from the ground truth for each loss."""
    device = resolve_device(device)
    x, y = load_xy(_data_file(data_dir, CURVE_FILE))
    out = {"n": int(x.size), "gt": CURVE_GT, "fits": {}, "device": _device_name(device)}
    for loss, p in _ladder(x, y, "exp", CURVE_LOSSES, device):
        err = float(np.hypot(p[0] - CURVE_GT[0], p[1] - CURVE_GT[1]))
        out["fits"][loss] = {"m": float(p[0]), "c": float(p[1]), "param_err": err}
        print(f"  curve {loss:8s} m={p[0]:.4f} c={p[1]:.4f} err={err:.4f}", flush=True)
    return out


def nonconvex_program(data_dir: str, device=None) -> dict:
    """The robust quintic fits of ``data_non_convex_fitting.txt``: the
    coefficients and their largest distance from the ground truth for each
    loss (the squared-residual losses scaled to the inlier band)."""
    device = resolve_device(device)
    x, y = load_xy(_data_file(data_dir, NONCONVEX_FILE))
    out = {"n": int(x.size), "gt": QUINTIC_GT, "fits": {}, "device": _device_name(device)}
    for loss, p in _ladder(x, y, "quintic", QUINTIC_LOSSES, device):
        err = float(np.max(np.abs(p - np.asarray(QUINTIC_GT))))
        out["fits"][loss] = {"coeffs": [float(v) for v in p], "max_coeff_err": err}
        print(f"  quintic {loss:8s} max|dcoef|={err:.3f} coeffs={np.round(p, 2)}",
              flush=True)
    return out


def bal_program(data_dir: str, mesh=None, device=None, histories: dict | None = None) -> dict:
    """``problem-49-7776-pre.txt``: LM with point-Schur elimination, trivial
    and huber; with ``mesh`` the observation-sharded assembly's largest
    error relative to the dense assembly, block by block. ``histories``,
    when given, receives the two LM cost histories ("trivial", "huber")."""
    device = resolve_device(device)
    prob = BAL.load_bal(_data_file(data_dir, BAL_FILE), device=device)
    out = {"cams": int(prob.cams.shape[0]), "pts": int(prob.pts.shape[0]),
           "obs": int(prob.obs.shape[0])}
    t0 = time.perf_counter()
    _, _, hist = BAL.solve_bal(prob, iters=BAL_ITERS)
    out["initial_cost"] = float(hist[0])
    out["final_cost"] = float(hist[-1])
    out["lm_iters"] = len(hist) - 1
    out["wall_s"] = time.perf_counter() - t0
    print(f"  bal trivial: {hist[0]:.4e} -> {hist[-1]:.4e} ({out['wall_s']:.1f}s)", flush=True)
    _, _, hist_h = BAL.solve_bal(prob, iters=BAL_ITERS, loss="huber",
                                 loss_scale=BAL_HUBER_SCALE)
    out["huber_final_cost"] = float(hist_h[-1])
    if histories is not None:
        histories.update(trivial=hist, huber=hist_h)
    print(f"  bal huber:   {hist_h[0]:.4e} -> {hist_h[-1]:.4e}", flush=True)
    if mesh is not None:
        d = BAL.dense_assemble(prob.cams, prob.pts, prob, "trivial", 1.0, 1.0)
        s = BAL.make_sharded_assemble(mesh)(prob.cams, prob.pts, prob, "trivial", 1.0, 1.0)
        out["sharded_assembly_rel_err"] = [
            float((a - b).abs().max() / (1e-9 + a.abs().max())) for a, b in zip(d, s)]
        print(f"  sharded assembly rel err: {max(out['sharded_assembly_rel_err']):.2e}",
              flush=True)
    out["device"] = _device_name(device)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m mloam_tpu_torch.models.realdata")
    ap.add_argument("program", choices=("curve", "nonconvex", "bal", "all"))
    ap.add_argument("--data-dir", required=True,
                    help=f"directory holding {CURVE_FILE}, {NONCONVEX_FILE} and {BAL_FILE}")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    res = {}
    if a.program in ("curve", "all"):
        print(f"curve fitting ({CURVE_FILE}):", flush=True)
        res["curve"] = curve_program(a.data_dir, device)
    if a.program in ("nonconvex", "all"):
        print(f"non-convex quintic ({NONCONVEX_FILE}):", flush=True)
        res["nonconvex"] = nonconvex_program(a.data_dir, device)
    if a.program in ("bal", "all"):
        print(f"bundle adjustment ({BAL_FILE}):", flush=True)
        res["bal"] = bal_program(a.data_dir, M.make_mesh(8, device=device), device)
    d = os.path.join(OUTDIR, "realdata")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "summary.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(f"wrote {d}/summary.json", flush=True)
    return res


if __name__ == "__main__":
    main()
