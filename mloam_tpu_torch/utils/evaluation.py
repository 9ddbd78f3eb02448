"""Trajectory evaluation: ATE/RPE with Umeyama alignment + TUM-format I/O.

In-repo replacement for the external rpg_trajectory_evaluation pipeline the
reference shells out to (``estimator/script/run_mloam.py:83-163``), and for
``SaveStatistics``'s TUM dumps (``estimator/src/save_statistics.hpp:45-65``).
Numpy-based (host-side analysis, not a device program).
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares SE(3) (optionally Sim(3)) alignment est -> gt.
    est, gt: [N, 3]. Returns (R, t, s)."""
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    e = est - mu_e
    g = gt - mu_g
    cov = g.T @ e / est.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (e * e).sum() / est.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(est_t: np.ndarray, gt_t: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error (RMSE over positions), SE(3)-aligned."""
    est_t = np.asarray(est_t, np.float64)
    gt_t = np.asarray(gt_t, np.float64)
    if align:
        R, t, s = umeyama_alignment(est_t, gt_t)
        est_t = (s * (R @ est_t.T)).T + t
    err = est_t - gt_t
    return float(np.sqrt((err * err).sum(-1).mean()))


def rpe(est_T: np.ndarray, gt_T: np.ndarray, delta: int = 1):
    """Relative pose error over [N, 4, 4] homogeneous trajectories.
    Returns (trans_rmse, rot_rmse_deg)."""
    n = est_T.shape[0] - delta
    terr, rerr = [], []
    for i in range(n):
        de = np.linalg.inv(est_T[i]) @ est_T[i + delta]
        dg = np.linalg.inv(gt_T[i]) @ gt_T[i + delta]
        e = np.linalg.inv(dg) @ de
        terr.append(np.linalg.norm(e[:3, 3]))
        c = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        rerr.append(np.degrees(np.arccos(c)))
    return float(np.sqrt(np.mean(np.square(terr)))), float(
        np.sqrt(np.mean(np.square(rerr)))
    )


def save_tum(path: str, times: np.ndarray, t: np.ndarray, q_wxyz: np.ndarray):
    """TUM format: time x y z qx qy qz qw."""
    with open(path, "w") as f:
        for i in range(len(times)):
            qw, qx, qy, qz = q_wxyz[i]
            x, y, z = t[i]
            f.write(f"{times[i]:.6f} {x:.6f} {y:.6f} {z:.6f} "
                    f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}\n")


def load_tum(path: str):
    data = np.loadtxt(path)
    times = data[:, 0]
    t = data[:, 1:4]
    qxyzw = data[:, 4:8]
    q_wxyz = np.concatenate([qxyzw[:, 3:4], qxyzw[:, :3]], axis=1)
    return times, t, q_wxyz
