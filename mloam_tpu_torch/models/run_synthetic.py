"""End-to-end odometry (and, with ``mapping=True``, keyframe mapping) on a
simulated sequence with ATE report.

Usage: python -m mloam_tpu_torch.models.run_synthetic [n_frames] [--mapping]

Runs on the GPU; ``run(..., device="cpu")`` runs the plain versions on the
CPU (slow at full width — meant for small configurations in tests).

A multi-LiDAR rig renders one sequence per lidar through its extrinsic
(``render_rig``); ``run`` either installs those extrinsics (known rig) or
leaves them to the online calibration, and returns the per-sweep
ESTIMATE_EXTRINSIC mode and extrinsic error beside ATE.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from mloam_tpu_torch import resolve_device
from mloam_tpu_torch.core import se3
from mloam_tpu_torch.core.rangeimage import RangeImage
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.models import platforms
from mloam_tpu_torch.models.pipeline import FullPipeline, OdometryPipeline
from mloam_tpu_torch.sim import world as W
from mloam_tpu_torch.utils import evaluation, timing


def render_rig(cfg, n_frames: int, seed: int = 0, extrinsics: Pose | None = None,
               wobble: float = 0.0, device=None):
    """Render one sequence per lidar of ``cfg``'s rig: lidar l mounted at
    ``extrinsics[l]`` (base <- lidar, [L]; identity for all when None).
    Returns (a list of L RangeImages stacked [F, ...], gt base poses [F])."""
    device = resolve_device(device)
    L = cfg.rig.n_lidars
    w = W.make_world(torch.Generator().manual_seed(seed), device=device)
    traj = W.make_trajectory(torch.Generator().manual_seed(seed + 1),
                             wobble=wobble, device=device)
    if extrinsics is None:
        extrinsics = Pose.identity((L,), device=device)
    seqs = [W.render_sequence(
        w, traj, cfg.rig.models[l], n_frames,
        extrinsic=Pose(extrinsics.q[l].to(device), extrinsics.t[l].to(device)),
        device=device) for l in range(L)]
    return [imgs for imgs, _ in seqs], seqs[0][1]


def render(cfg, n_frames: int, seed: int = 0, device=None):
    """The reference lidar's sequence alone: (stacked RangeImage, gt)."""
    imgs, gt = render_rig(cfg, n_frames, seed, device=device)
    return imgs[0], gt


def extrinsic_errors(est: Pose, true: Pose) -> list[tuple[float, float]]:
    """(rotation rad, translation m) error of each non-reference extrinsic."""
    e = se3.boxminus(Pose(est.q[1:], est.t[1:]),
                     Pose(true.q[1:].to(est.q.device), true.t[1:].to(est.q.device)))
    e = e.cpu().numpy()
    # tangent layout: [:3] = rho (translation), [3:] = phi (rotation)
    return [(float(np.linalg.norm(x[3:])), float(np.linalg.norm(x[:3])))
            for x in e]


def run(n_frames: int = 40, seed: int = 0, verbose: bool = True,
        device=None, cfg=None, extrinsics: Pose | None = None,
        install_extrinsics: bool = True, wobble: float = 0.0, on_sweep=None,
        mapping: bool = False):
    """Render and run one sequence. A rig (``cfg.rig.n_lidars > 1``) is
    rendered at ``extrinsics`` along a trajectory with ``wobble``;
    ``install_extrinsics`` hands them to the pipeline before the first sweep
    (a known rig), otherwise they are left to the online calibration of the
    configured ``extrinsic_mode``. ``mapping`` runs the ``FullPipeline``
    (odometry + keyframe mapping) and adds the map-frame trajectory, its ATE
    and which sweeps were mapped. ``on_sweep(i, out, pipe)``, when given, is
    called after each sweep, outside its timer."""
    device = resolve_device(device)
    if cfg is None:
        cfg = platforms.synthetic(n_lidars=1)
    L = cfg.rig.n_lidars
    if extrinsics is None:
        extrinsics = Pose.identity((L,), device=device)
    seqs, gt_poses = render_rig(cfg, n_frames, seed, extrinsics, wobble, device)
    pipe = (FullPipeline if mapping else OdometryPipeline)(cfg, device=device)
    odom = pipe.odom if mapping else pipe
    if L > 1 and install_extrinsics:
        odom.set_extrinsics(extrinsics)

    timing.reset()
    est_t, est_q, modes, ext_err, map_t, mapped = [], [], [], [], [], []
    t_start = time.perf_counter()
    for i in range(n_frames):
        frames = [RangeImage(*(f[i] for f in imgs)) for imgs in seqs]
        with timing.timer("odom_process"):   # synchronises the device
            out = pipe.process(frames)
        if mapping:
            map_t.append(out.map_pose.t.cpu().numpy())
            mapped.append(out.mapped)
        o = out.odom if mapping else out
        est_t.append(o.pose.t.cpu().numpy())
        est_q.append(o.pose.q.cpu().numpy())
        modes.append(o.ext_mode)
        if L > 1:
            ext_err.append(extrinsic_errors(o.extrinsics, extrinsics))
        if on_sweep is not None:
            on_sweep(i, out, pipe)
    wall = time.perf_counter() - t_start

    est_t = np.stack(est_t)
    est_q = np.stack(est_q)
    gt_t = gt_poses.t[:n_frames].cpu().numpy()
    ate = evaluation.ate_rmse(est_t, gt_t)
    per_frame = np.asarray(timing._registry["odom_process"])
    # steady state: sweeps after the window is warm
    steady = per_frame[cfg.odometry.window_size + 1:]
    fps = 1.0 / float(np.mean(steady)) if steady.size else 0.0
    res = {
        "ate_m": ate, "fps": float(fps), "n_frames": n_frames,
        "steady_ms_median": float(np.median(steady) * 1e3) if steady.size else None,
        "est_t": est_t, "est_q": est_q, "gt_t": gt_t,
        "gt_q": gt_poses.q[:n_frames].cpu().numpy(),
        "sweep_ms": (per_frame * 1e3).tolist(), "modes": modes, "ext_err": ext_err,
        "device": str(device),
    }
    if mapping:
        res.update(map_est_t=np.stack(map_t), mapped=mapped,
                   map_ate_m=evaluation.ate_rmse(np.stack(map_t), gt_t))
    if verbose:
        print(timing.report())
        print(f"frames={n_frames} lidars={L} wall={wall:.1f}s "
              f"steady-state fps={fps:.2f} device={device}")
        print(f"ATE RMSE = {ate*100:.2f} cm over "
              f"{np.linalg.norm(np.diff(gt_t, axis=0), axis=1).sum():.1f} m path")
        if mapping:
            print(f"map ATE RMSE = {res['map_ate_m']*100:.2f} cm")
    return res


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--mapping"]
    run(int(args[0]) if args else 40, mapping="--mapping" in sys.argv[1:])
