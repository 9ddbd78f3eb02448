"""End-to-end odometry (with ``mapping=True`` keyframe mapping, with
``slam=True`` mapping and loop closure, on a loop course of
``LOOP_COURSES`` from the command line) on a simulated sequence with ATE
report.

Usage: python -m mloam_tpu_torch.models.run_synthetic [n_frames] [--mapping]
       python -m mloam_tpu_torch.models.run_synthetic --slam [n_frames [floor|drift]]

Runs on the GPU; ``run(..., device="cpu")`` runs the plain versions on the
CPU (slow at full width — meant for small configurations in tests).

A multi-LiDAR rig renders one sequence per lidar through its extrinsic
(``render_rig``); ``run`` either installs those extrinsics (known rig) or
leaves them to the online calibration, and returns the per-sweep
ESTIMATE_EXTRINSIC mode and extrinsic error beside ATE.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from mloam_tpu_torch import resolve_device
from mloam_tpu_torch.core import se3
from mloam_tpu_torch.core.rangeimage import RangeImage
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.models import platforms
from mloam_tpu_torch.models.pipeline import (FullPipeline, OdometryPipeline,
                                             SlamPipeline)
from mloam_tpu_torch.sim import world as W
from mloam_tpu_torch.utils import evaluation, timing


# Loop courses for ``run(slam=True)``: "floor" is the floor course of the JAX
# package's tests/test_slam_e2e.py:26-55, "drift" the slam pass of its
# bench.py:295-340 (on ``realtime_tuned``, under range noise), "experiment"
# the course of its ``experiments slam --traj loop`` (models/experiments.py:
# 513-538, at the program's default noise 0.02 m and seed 0)
LOOP_COURSES = {
    "floor": {"frames": 110, "seed": 3, "tuned": False,
              "mapping": {"skip_frames": 2},
              "loop": {"num_exclude_recent": 8, "capacity": 64},
              "course": {"world": {"extent": 30.0, "n_walls": 20, "n_poles": 10},
                         "loop": {"radius": 6.0, "period_s": 10.0}}},
    "drift": {"frames": 130, "seed": 5, "tuned": True,
              "mapping": {"surround_radius": 15.0, "surround_rebuild_dist": 3.0},
              "loop": {"num_exclude_recent": 10, "capacity": 256},
              "course": {"world": {"extent": 30.0, "n_walls": 24, "n_poles": 12},
                         "loop": {"radius": 8.0, "period_s": 12.0},
                         "noise_std": 0.03, "noise_seed": 77}},
    "experiment": {"frames": 30, "seed": 0, "tuned": False,
                   "mapping": {"surround_radius": 15.0, "surround_rebuild_dist": 3.0},
                   "loop": {"num_exclude_recent": 10, "capacity": 256,
                            "use_global_registration": True},
                   "course": {"world": {"extent": 30.0, "n_walls": 24, "n_poles": 12},
                              "loop": {"radius": 8.0, "period_s": 12.0},
                              "noise_std": 0.02, "noise_seed": 1000}},
}


def loop_course(name: str, cfg=None):
    """(config, sweeps, world seed, ``run`` course keywords) of the loop
    course ``name`` on ``cfg`` (``synthetic(1)`` when None; the drift course
    tunes it with ``realtime_tuned``): keyframes every 0.5 m, each one
    entering the loop graph, loops gated at 10 m."""
    c = LOOP_COURSES[name]
    cfg = cfg or platforms.synthetic(n_lidars=1)
    if c["tuned"]:
        cfg = platforms.realtime_tuned(cfg)
    cfg = dataclasses.replace(
        cfg,
        mapping=dataclasses.replace(cfg.mapping, keyframe_dist=0.5, **c["mapping"]),
        loop=dataclasses.replace(cfg.loop, skip_interval=1,
                                 loop_distance_threshold=10.0, **c["loop"]))
    return cfg, c["frames"], c["seed"], c["course"]


def render_rig(cfg, n_frames: int, seed: int = 0, extrinsics: Pose | None = None,
               wobble: float = 0.0, device=None, world: dict | None = None,
               loop: dict | None = None, noise_std: float = 0.0,
               noise_seed: int = 1234):
    """Render one sequence per lidar of ``cfg``'s rig: lidar l mounted at
    ``extrinsics[l]`` (base <- lidar, [L]; identity for all when None).
    ``world`` holds ``make_world`` keywords; ``loop`` the keywords of
    ``make_loop_trajectory`` (a loop course) in place of the seeded
    trajectory; ``noise_std`` adds range noise (lidar l's draw seeded with
    ``noise_seed + 1000 * l``). Returns (a list of L RangeImages stacked
    [F, ...], gt base poses [F])."""
    device = resolve_device(device)
    L = cfg.rig.n_lidars
    w = W.make_world(torch.Generator().manual_seed(seed), device=device, **(world or {}))
    if loop is not None:
        traj = W.make_loop_trajectory(wobble=wobble, device=device, **loop)
    else:
        traj = W.make_trajectory(torch.Generator().manual_seed(seed + 1),
                                 wobble=wobble, device=device)
    if extrinsics is None:
        extrinsics = Pose.identity((L,), device=device)
    seqs = [W.render_sequence(
        w, traj, cfg.rig.models[l], n_frames,
        extrinsic=Pose(extrinsics.q[l].to(device), extrinsics.t[l].to(device)),
        device=device, noise_std=noise_std, noise_seed=noise_seed + 1000 * l)
        for l in range(L)]
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
        mapping: bool = False, slam: bool = False, **course):
    """Render and run one sequence. A rig (``cfg.rig.n_lidars > 1``) is
    rendered at ``extrinsics`` along a trajectory with ``wobble``;
    ``install_extrinsics`` hands them to the pipeline before the first sweep
    (a known rig), otherwise they are left to the online calibration of the
    configured ``extrinsic_mode``. ``course`` takes ``render_rig``'s
    ``world``, ``loop``, ``noise_std`` and ``noise_seed``. ``mapping`` runs
    the ``FullPipeline`` (odometry + keyframe mapping) and adds the
    map-frame trajectory, its ATE and which sweeps were mapped. ``slam``
    runs the ``SlamPipeline`` and adds, besides the mapping's results, the
    mapped sweep of each keyframe in the loop graph (a keyframe enters the
    graph at the sweep after its own, and the last may enter at the
    end-of-run flush), the odometry-frame and the loop-corrected
    keyframe trajectories with their ATE against those sweeps' truth,
    ``n_loops`` and the sweep times split into keyframe / mapped /
    pass-through sweeps. ``on_sweep(i, out, pipe)``, when given, is called
    after each sweep, outside its timer."""
    device = resolve_device(device)
    if cfg is None:
        cfg = platforms.synthetic(n_lidars=1)
    L = cfg.rig.n_lidars
    if extrinsics is None:
        extrinsics = Pose.identity((L,), device=device)
    seqs, gt_poses = render_rig(cfg, n_frames, seed, extrinsics, wobble, device, **course)
    if slam:
        pipe = SlamPipeline(cfg, device=device)
        odom = pipe.full.odom
    else:
        pipe = (FullPipeline if mapping else OdometryPipeline)(cfg, device=device)
        odom = pipe.odom if mapping else pipe
    if L > 1 and install_extrinsics:
        odom.set_extrinsics(extrinsics)

    timing.reset()
    est_t, est_q, modes, ext_err, map_t, map_q, mapped = [], [], [], [], [], [], []
    kinds, kf_gt_idx, prev_kf, last_mapped = [], [], 0, -1
    t_start = time.perf_counter()
    for i in range(n_frames):
        frames = [RangeImage(*(f[i] for f in imgs)) for imgs in seqs]
        with timing.timer("odom_process", sync=True):   # waits for the device
            out = pipe.process(frames)
        full = out.full if slam else out
        if mapping or slam:
            map_t.append(full.map_pose.t.cpu().numpy())
            map_q.append(full.map_pose.q.cpu().numpy())
            mapped.append(full.mapped)
        if slam:
            is_kf = pipe.loop_kf_count != prev_kf
            prev_kf = pipe.loop_kf_count
            if is_kf:
                kf_gt_idx.append(last_mapped)
            kinds.append("keyframe" if is_kf else "mapped" if full.mapped else "pass")
            if full.mapped:
                last_mapped = i
        o = full.odom if (mapping or slam) else out
        est_t.append(o.pose.t.cpu().numpy())
        est_q.append(o.pose.q.cpu().numpy())
        modes.append(o.ext_mode)
        if L > 1:
            ext_err.append(extrinsic_errors(o.extrinsics, extrinsics))
        if on_sweep is not None:
            on_sweep(i, out, pipe)
    wall = time.perf_counter() - t_start
    if slam:
        pipe.flush()
        if pipe.loop_kf_count != prev_kf:
            kf_gt_idx.append(last_mapped)

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
    if mapping or slam:
        res.update(map_est_t=np.stack(map_t), map_est_q=np.stack(map_q), mapped=mapped,
                   map_ate_m=evaluation.ate_rmse(np.stack(map_t), gt_t))
    if slam:
        corr_t, corr_q = pipe.corrected_trajectory()
        n = len(kf_gt_idx)
        kf_gt = gt_t[np.asarray(kf_gt_idx, dtype=np.int64)]
        odom_kf_t = pipe.loop_state.odom_poses.t[:n].cpu().numpy()
        sweep_ms = np.asarray(res["sweep_ms"])
        res.update(
            kf_gt_idx=kf_gt_idx, kf_odom_t=odom_kf_t, kf_corr_t=corr_t,
            kf_corr_q=corr_q, n_loops=pipe.n_loops, n_detections=pipe.n_detections,
            kf_ate_odom_m=evaluation.ate_rmse(odom_kf_t, kf_gt) if n else None,
            kf_ate_corr_m=evaluation.ate_rmse(corr_t, kf_gt) if n else None,
            sweep_kinds=kinds,
            sweep_ms_by_kind={k: sweep_ms[[x == k for x in kinds]].tolist()
                              for k in ("keyframe", "mapped", "pass")})
    if verbose:
        print(timing.report())
        print(f"frames={n_frames} lidars={L} wall={wall:.1f}s "
              f"steady-state fps={fps:.2f} device={device}")
        print(f"ATE RMSE = {ate*100:.2f} cm over "
              f"{np.linalg.norm(np.diff(gt_t, axis=0), axis=1).sum():.1f} m path")
        if mapping or slam:
            print(f"map ATE RMSE = {res['map_ate_m']*100:.2f} cm")
        if slam:
            print(f"loops={res['n_loops']} keyframes={len(res['kf_gt_idx'])} "
                  f"keyframe ATE odom={res['kf_ate_odom_m']} corrected={res['kf_ate_corr_m']}")
    return res


if __name__ == "__main__":
    flags = {"--mapping", "--slam"}
    args = [a for a in sys.argv[1:] if a not in flags]
    if "--slam" in sys.argv[1:]:
        cfg, n, seed, course = loop_course(args[1] if len(args) > 1 else "floor")
        run(int(args[0]) if args else n, seed=seed, cfg=cfg, slam=True, **course)
    else:
        run(int(args[0]) if args else 40, mapping="--mapping" in sys.argv[1:])
