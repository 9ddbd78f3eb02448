"""End-to-end odometry on a simulated sequence with ATE report.

Usage: python -m mloam_tpu_torch.models.run_synthetic [n_frames]

Runs on the GPU; ``run(..., device="cpu")`` runs the plain versions on the
CPU (slow at full width — meant for small configurations in tests).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from mloam_tpu_torch import resolve_device
from mloam_tpu_torch.core.rangeimage import RangeImage
from mloam_tpu_torch.models import platforms
from mloam_tpu_torch.models.pipeline import OdometryPipeline
from mloam_tpu_torch.sim import world as W
from mloam_tpu_torch.utils import evaluation, timing


def render(cfg, n_frames: int, seed: int = 0, device=None):
    device = resolve_device(device)
    w = W.make_world(torch.Generator().manual_seed(seed), device=device)
    traj = W.make_trajectory(torch.Generator().manual_seed(seed + 1),
                             device=device)
    model = cfg.rig.models[0]
    return W.render_sequence(w, traj, model, n_frames, device=device)


def run(n_frames: int = 40, seed: int = 0, verbose: bool = True,
        device=None, cfg=None):
    device = resolve_device(device)
    if cfg is None:
        cfg = platforms.synthetic(n_lidars=1)
    imgs, gt_poses = render(cfg, n_frames, seed, device)
    pipe = OdometryPipeline(cfg, device=device)

    timing.reset()
    est_t, est_q = [], []
    t_start = time.perf_counter()
    for i in range(n_frames):
        img = RangeImage(*(f[i] for f in imgs))
        with timing.timer("odom_process"):   # synchronises the device
            out = pipe.process([img])
        est_t.append(out.pose.t.cpu().numpy())
        est_q.append(out.pose.q.cpu().numpy())
    wall = time.perf_counter() - t_start

    est_t = np.stack(est_t)
    est_q = np.stack(est_q)
    gt_t = gt_poses.t[:n_frames].cpu().numpy()
    ate = evaluation.ate_rmse(est_t, gt_t)
    per_frame = np.asarray(timing._registry["odom_process"])
    # steady state: sweeps after the window is warm
    steady = per_frame[cfg.odometry.window_size + 1:]
    fps = 1.0 / float(np.mean(steady)) if steady.size else 0.0
    if verbose:
        print(timing.report())
        print(f"frames={n_frames} wall={wall:.1f}s steady-state fps={fps:.2f} "
              f"device={device}")
        print(f"ATE RMSE = {ate*100:.2f} cm over "
              f"{np.linalg.norm(np.diff(gt_t, axis=0), axis=1).sum():.1f} m path")
    return {
        "ate_m": ate, "fps": float(fps), "n_frames": n_frames,
        "steady_ms_median": float(np.median(steady) * 1e3) if steady.size else None,
        "est_t": est_t, "est_q": est_q, "gt_t": gt_t,
        "device": str(device),
    }


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    run(n)
