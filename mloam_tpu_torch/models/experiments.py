"""Batch experiment programs.

Counterpart of ``mloam_tpu/models/experiments.py`` (the reference's
``estimator/script/run_mloam.py`` programs, :207-283): ``single`` (one run +
ATE), ``mc`` (Monte-Carlo over trials and cells, :95-163), ``inject_ext``
(extrinsic perturbation levels gt/ref/cad/ini/inj, :167-205), ``calib``
(the online calibration lifecycle), ``slam`` (odometry + mapping + loop
closure with every observability artifact), ``corridor`` (degenerate
geometry, remap armed and disarmed), ``dynamic`` (robust losses under
moving objects), ``long`` (endurance), on simulated sequences with the
in-repo evaluation, and ``scaling`` (the distributed pose-graph solvers on
stacked meshes: the nested-dissection step on 1-D and 2-D layouts and the
edge-sharded PCG, against the dense one-device step; the collectives each
mesh counts per GN iteration; on the card, the ms of one shard's work and of
the separator solve, and the scaling report: the JAX program's four
efficiency rows from the collectives the meshes count and the card's shard
ms over an HGX H100 node's published fabric figures, and the PCG's legacy
model).

Usage (the JAX program's arguments and defaults; runs on the GPU):
    python -m mloam_tpu_torch.models.experiments single --frames 40
    python -m mloam_tpu_torch.models.experiments mc --trials 3 --frames 30
    python -m mloam_tpu_torch.models.experiments calib
    python -m mloam_tpu_torch.models.experiments slam --traj loop --frames 260
    python -m mloam_tpu_torch.models.experiments long
    python -m mloam_tpu_torch.models.experiments scaling --poses 1024
    python -m mloam_tpu_torch.models.experiments plot results_torch/long
Results land in ``results_torch/<program>/`` (never in ``results/``, the JAX
package's records): TUM trajectories, summary JSON, PCD maps, and the plots'
inputs (``plots.json`` + ``plots.npz``). The PNGs are drawn from those by
the ``plot`` program, which needs matplotlib; the programs themselves do
not, so they run where matplotlib is not installed.

Each program is a measurement (``measure_<program>``: runs the pipeline and
returns a result whose ``"summary"`` has the JAX program's keys) and a writer
(``write_<program>``). The worlds come from the port's ``torch.Generator``,
so the figures are the port's own draw of the same distributions; the two
fixed perturbation directions of ``inject_ext`` are the JAX package's
constants. ``configure`` (identity by default) is applied to each preset a
program starts from: the tests shrink the sensor and the caps with it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from mloam_tpu_torch import config as C
from mloam_tpu_torch import resolve_device
from mloam_tpu_torch.core import se3
from mloam_tpu_torch.core.rangeimage import RangeImage
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.models import platforms, run_synthetic
from mloam_tpu_torch.models.pipeline import FullPipeline, OdometryPipeline
from mloam_tpu_torch.parallel import dd_pgo as DD
from mloam_tpu_torch.parallel import mesh as M
from mloam_tpu_torch.parallel import scaling_model as SM
from mloam_tpu_torch.parallel import sharded_pgo as PG
from mloam_tpu_torch.sim import world as W
from mloam_tpu_torch.utils import evaluation, timing, viz

# extrinsic perturbation levels: tangent-norm magnitudes mirroring the
# reference's gt/ref/cad/ini/inj ladder (run_mloam.py:167-205)
PERTURBATION_LEVELS = {
    "gt": 0.0,
    "ref": 0.01,
    "cad": 0.05,
    "ini": 0.10,
    "inj": 0.20,
}

# the fixed unit directions of inject_ext, translation (m) and rotation
# (rad): the JAX package's jax.random.normal(PRNGKey(42 / 43), (3,)),
# normalised (mloam_tpu/models/experiments.py:215-218), kept as constants
D_RHO = (-0.05112989619374275, 0.8438342213630676, 0.5341624021530151)
D_PHI = (0.08726877719163895, 0.19950197637081146, 0.9760036468505859)

# the second lidar's extrinsic of the dual-rig programs, and the calib
# program's rig (the JAX programs' constants)
X_TANGENT = (0.25, -0.1, 0.05, 0.05, -0.03, 0.5)
CALIB_TANGENTS = (X_TANGENT, (-0.2, 0.15, -0.05, -0.04, 0.06, -0.4),
                  (0.1, 0.3, 0.02, 0.03, -0.05, 1.0))

TIMING_NOTE = ("stages exclude the first 12 frames (warm-up; the first sweep "
               "builds the CUDA kernels if they are not built yet); "
               "odom_process waits for the device at each end of a sweep, the "
               "stages inside it read the host clock only (the host's time to "
               "issue each stage)")

OUTDIR = "results_torch"


def _identity(cfg):
    return cfg


def _pose(tangent, device) -> Pose:
    return se3.exp(torch.tensor(tangent, dtype=torch.float32, device=device))


def _rig(poses: list[Pose]) -> Pose:
    return Pose(torch.stack([p.q for p in poses]), torch.stack([p.t for p in poses]))


def _frame(seqs, i):
    return [RangeImage(*(f[i] for f in imgs)) for imgs in seqs]


def _platform(device) -> str:
    return torch.device(device).type


def run_sequence(cfg, n_frames: int, seed: int = 0, n_lidars: int = 1,
                 ext_true: Pose | None = None, pipe=None,
                 noise_std: float = 0.02, device=None):
    """Render + run one sequence through ``FullPipeline`` (or ``pipe``);
    returns the metrics and the map-frame trajectory.

    World of ``seed``, trajectory of ``seed + 1`` (wobble 0.05), lidar l
    mounted at ``ext_true`` for l > 0 (identity when None), gaussian range
    noise ``noise_std`` (0.02 m, about a real VLP-16's) drawn from
    ``seed + 1000 + 1000 l``. Stage timers restart after the first
    ``min(12, n_frames // 4)`` sweeps."""
    device = resolve_device(device)
    ext = ext_true if ext_true is not None else Pose.identity(device=device)
    exts = _rig([Pose.identity(device=device)]
                + [Pose(ext.q.to(device), ext.t.to(device))] * (n_lidars - 1))
    seqs, gt = run_synthetic.render_rig(cfg, n_frames, seed, exts, wobble=0.05,
                                        device=device, noise_std=noise_std,
                                        noise_seed=seed + 1000)
    model = cfg.rig.models[0]
    pipe = pipe or FullPipeline(cfg, device=device)
    est_t, est_q = [], []
    warm_cut = min(12, max(n_frames // 4, 1))
    t0 = time.perf_counter()
    for i in range(n_frames):
        if i == warm_cut:
            timing.reset()
        with timing.timer("odom_process", sync=True):   # waits for the device
            out = pipe.process(_frame(seqs, i))
        est_t.append(out.map_pose.t)
        est_q.append(out.map_pose.q)
    wall = time.perf_counter() - t0
    est = torch.cat([torch.stack(est_t), torch.stack(est_q)], dim=1).cpu().numpy()
    gt_t = gt.t[:n_frames].cpu().numpy()
    return {
        "ate_m": evaluation.ate_rmse(est[:, :3], gt_t),
        "wall_s": wall,
        "fps": n_frames / wall,
        "est_t": est[:, :3],
        "est_q": est[:, 3:],
        "times": np.arange(n_frames) * model.scan_period,
        "gt_t": gt_t,
        "gt_q": gt.q[:n_frames].cpu().numpy(),
        "pipe": pipe,
    }


# ---------------------------------------------------------------- artifacts

class Plots:
    """The plots of one program as data: each entry names a ``utils/viz``
    function, its PNG and its arguments (arrays in ``plots.npz``, the rest in
    ``plots.json``). ``draw`` renders them; only it needs matplotlib."""

    def __init__(self):
        self.calls, self.arrays = [], {}

    def add(self, fn: str, png: str, **kwargs):
        args = {}
        for k, v in kwargs.items():
            if isinstance(v, np.ndarray):
                key = f"{len(self.calls)}_{k}"
                self.arrays[key] = v
                args[k] = {"array": key}
            else:
                args[k] = v
        self.calls.append({"fn": fn, "png": png, "args": args})

    def save(self, d: str):
        with open(os.path.join(d, "plots.json"), "w") as f:
            json.dump(self.calls, f, indent=2)
        np.savez_compressed(os.path.join(d, "plots.npz"), **self.arrays)


def draw(d: str) -> list[str]:
    """Draw the PNGs a program's writer recorded in directory ``d``;
    returns their paths."""
    with open(os.path.join(d, "plots.json")) as f:
        calls = json.load(f)
    with np.load(os.path.join(d, "plots.npz")) as z:
        arrays = dict(z)
    out = []
    for c in calls:
        kw = {k: arrays[v["array"]] if isinstance(v, dict) else v
              for k, v in c["args"].items()}
        if "loops" in kw or "loop_edges" in kw:
            key = "loops" if "loops" in kw else "loop_edges"
            kw[key] = [tuple(e) for e in kw[key]]
        path = os.path.join(d, c["png"])
        getattr(viz, c["fn"])(path, **kw)
        out.append(path)
    return out


def _outdir(program: str, root: str = OUTDIR) -> str:
    d = os.path.join(root, program)
    os.makedirs(d, exist_ok=True)
    return d


def _write_json(d: str, name: str, obj):
    with open(os.path.join(d, name), "w") as f:
        json.dump(obj, f, indent=2)


# ------------------------------------------------------------------ single

def measure_single(frames: int = 30, seed: int = 0, lidars: int = 1, device=None,
                   configure=_identity):
    cfg = configure(platforms.synthetic(n_lidars=lidars))
    res = run_sequence(cfg, frames, seed=seed, n_lidars=lidars, device=device)
    res["summary"] = {"ate_m": res["ate_m"], "fps": res["fps"], "frames": frames,
                      "seed": seed, "timing_note": TIMING_NOTE,
                      "timing": timing.all_stats()}
    return res


def write_single(res, root: str = OUTDIR) -> str:
    d = _outdir("single", root)
    seed = res["summary"]["seed"]
    evaluation.save_tum(os.path.join(d, f"traj_est_seed{seed}.tum"),
                        res["times"], res["est_t"], res["est_q"])
    plots = Plots()
    plots.add("plot_trajectory", f"traj_seed{seed}.png", est_t=res["est_t"],
              gt_t=res["gt_t"], title=f"single seed={seed}")
    plots.save(d)
    _write_json(d, "summary.json", res["summary"])
    return d


# ---------------------------------------------------------------------- mc

def mc_cells(configure=_identity) -> dict:
    """{single, dual} x {default, realtime_tuned}: name -> (config, lidars).
    The dual cells run fixed calibrated extrinsics (mode 0)."""
    cells = {}
    for rig in (1, 2):
        for preset in ("default", "tuned"):
            cfg = configure(platforms.synthetic(n_lidars=rig, extrinsic_mode=0))
            if preset == "tuned":
                cfg = platforms.realtime_tuned(cfg)
            cells[f"{'single' if rig == 1 else 'dual'}_{preset}"] = (cfg, rig)
    return cells


def measure_mc(trials: int = 5, frames: int = 30, device=None, configure=_identity):
    """Monte-Carlo over the reference's sweep shape (``run_mloam.py:95-163``):
    ``trials`` disjoint world / trajectory seeds (100 + trial) in each cell
    of ``mc_cells``; per-cell ATE mean / std / max."""
    device = resolve_device(device)
    X = _pose(X_TANGENT, device)
    summary = {"trials": trials, "frames": frames, "platform": _platform(device),
               "cells": {}}
    trajs = []
    for name, (cfg, rig) in mc_cells(configure).items():
        ates, fpss = [], []
        for trial in range(trials):
            pipe = FullPipeline(cfg, device=device)
            if rig > 1:
                pipe.odom.set_extrinsics(_rig([Pose.identity(device=device), X]))
            res = run_sequence(cfg, frames, seed=100 + trial, n_lidars=rig,
                               ext_true=X, pipe=pipe, device=device)
            ates.append(res["ate_m"])
            fpss.append(res["fps"])
            if name == "single_default":
                trajs.append((res["times"], res["est_t"], res["est_q"]))
            print(f"{name} trial {trial}: ATE {res['ate_m']*100:.2f} cm", flush=True)
        summary["cells"][name] = {
            "ate_mean_m": float(np.mean(ates)),
            "ate_std_m": float(np.std(ates)),
            "ate_max_m": float(np.max(ates)),
            "ate_per_trial_m": [round(float(a), 5) for a in ates],
            # host wall-clock including the per-sweep synchronisation and the
            # renders: not a measurement of the pipeline's speed
            "host_wall_fps_not_perf": float(np.mean(fpss)),
        }
    return {"summary": summary, "trajs": trajs}


def write_mc(res, root: str = OUTDIR) -> str:
    d = _outdir("mc", root)
    for trial, (times, t, q) in enumerate(res["trajs"]):
        evaluation.save_tum(os.path.join(d, f"traj_trial{trial}.tum"), times, t, q)
    _write_json(d, "summary.json", res["summary"])
    return d


# -------------------------------------------------------------- inject_ext

def measure_inject_ext(frames: int = 30, seed: int = 0, trials: int = 3,
                       levels=tuple(PERTURBATION_LEVELS), device=None,
                       configure=_identity):
    """Extrinsic-perturbation ladder on the dual rig (mode 0) with an
    uncertainty-aware A/B: every level runs with the mapper given the
    perturbation's covariance (ua) and without (off). Each level perturbs
    along the fixed unit directions ``D_RHO`` / ``D_PHI`` scaled by its
    magnitude, over ``trials`` seeds (``seed + 10 trial``)."""
    device = resolve_device(device)
    X_true = _pose(X_TANGENT, device)
    d_rho = torch.tensor(D_RHO, device=device)
    d_phi = torch.tensor(D_PHI, device=device)
    summary = {}
    for level in levels:
        mag = PERTURBATION_LEVELS[level]
        X_used = se3.boxplus(X_true, torch.cat([mag * d_rho, mag * d_phi]))
        entry = {"perturb_trans_m": float(mag), "perturb_rot_rad": float(mag)}
        for ua in (False, True):
            cfg = configure(platforms.synthetic(n_lidars=2, extrinsic_mode=0))
            if ua:
                cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(
                    cfg.mapping, ext_cov_prior_diag=(max(mag, 1e-4) ** 2,) * 6))
            ates = []
            for trial in range(trials):
                pipe = FullPipeline(cfg, device=device)
                pipe.odom.set_extrinsics(_rig([Pose.identity(device=device), X_used]))
                res = run_sequence(cfg, frames, seed=seed + 10 * trial, n_lidars=2,
                                   ext_true=X_true, pipe=pipe, device=device)
                ates.append(res["ate_m"])
            k = "ua" if ua else "off"
            entry[f"ate_m_{k}"] = float(np.mean(ates))
            entry[f"ate_m_{k}_std"] = float(np.std(ates))
            entry[f"ate_m_{k}_per_trial"] = [float(a) for a in ates]
        summary[level] = entry
        print(f"{level}: perturb {mag:.2f} -> ATE {entry['ate_m_off']*100:.2f} cm (ua off)"
              f" / {entry['ate_m_ua']*100:.2f} cm (ua on)", flush=True)
    return {"summary": summary}


def write_inject_ext(res, root: str = OUTDIR) -> str:
    d = _outdir("inject_ext", root)
    _write_json(d, "summary.json", res["summary"])
    return d


# ------------------------------------------------------------------- calib

def measure_calib(frames: int = 90, seed: int = 0, lidars: int = 2, device=None,
                  configure=_identity):
    """The online calibration lifecycle (ESTIMATE_EXTRINSIC 2 -> 1 -> 0) of
    an L-lidar rig (at least 2; 4 is the Hercules rig with three unknown
    extrinsics) from a fully unknown start, along rotation-rich motion
    (wobble 0.25): the mode transitions, the per-sweep extrinsic error trace
    and the final error and covariance."""
    device = resolve_device(device)
    L = max(lidars, 2)
    X_true = _rig([Pose.identity(device=device)]
                  + [_pose(x, device) for x in CALIB_TANGENTS[:L - 1]])
    cfg = configure(platforms.synthetic(n_lidars=L, extrinsic_mode=2))
    pipe = FullPipeline(cfg, device=device)
    seqs, _ = run_synthetic.render_rig(cfg, frames, seed, X_true, wobble=0.25,
                                       device=device)
    trace, transitions = [], {}
    for i in range(frames):
        out = pipe.process(_frame(seqs, i))
        mode = int(out.odom.ext_mode)
        errs = run_synthetic.extrinsic_errors(out.odom.extrinsics, X_true)
        trace.append({"frame": i, "mode": mode,
                      "rot_err_rad": [e[0] for e in errs],
                      "pos_err_m": [e[1] for e in errs]})
        if mode < 2 and "init_done" not in transitions:
            transitions["init_done"] = i          # 2 -> 1 (hand-eye seeded)
        if mode == 0 and "frozen" not in transitions:
            transitions["frozen"] = i             # 1 -> 0 (voting freeze)
    cov = pipe.odom.ext_cov
    summary = {
        "frames": frames, "lidars": L, "final_mode": trace[-1]["mode"],
        "transitions": transitions,
        "final_rot_err_rad": trace[-1]["rot_err_rad"],
        "final_pos_err_m": trace[-1]["pos_err_m"],
        # ext_cov holds the non-reference lidars only: lidar l -> index l-1
        "ext_cov_trace": [float(np.trace(c)) for c in cov] if cov is not None else None,
        "mapper_ext_cov_installed": bool(pipe._ext_cov_installed),
    }
    return {"summary": summary, "trace": trace}


def write_calib(res, root: str = OUTDIR) -> str:
    L = res["summary"]["lidars"]
    d = _outdir("calib" if L == 2 else f"calib_l{L}", root)
    _write_json(d, "extrinsic_trace.json", res["trace"])
    _write_json(d, "summary.json", res["summary"])
    return d


# -------------------------------------------------------------------- slam

def keyframe_map(db):
    """The keyframe map of a ``KeyframeDB`` as numpy (xyz [N, 3], mask [N]):
    every stored keyframe's base-frame surf features through its pose."""
    n = min(int(db.head), db.valid.shape[0])
    xyz = se3.transform_points(Pose(db.poses.q[:n], db.poses.t[:n]), db.surf.xyz[:n])
    return xyz.reshape(-1, 3).cpu().numpy(), db.surf.mask[:n].reshape(-1).cpu().numpy()


def measure_slam(frames: int = 30, seed: int = 0, lidars: int = 1, traj: str = "wander",
                 noise: float = 0.02, device=None, configure=_identity):
    """Odometry + mapping + loop closure, through ``run_synthetic.run``.
    ``traj="loop"``: the revisiting circular course with material drift
    (``run_synthetic.LOOP_COURSES["experiment"]``: a 15 m surround map
    on a course of radius 8 m, so revisits fall outside the scan-to-map
    basin: the regime the loop module exists for); ``"wander"``: the seeded
    trajectory with a keyframe every 5 cm. A rig runs fixed extrinsics, lidar
    l at the calibrated extrinsic scaled by l. Keyframe ATE is taken at each
    keyframe's mapped sweep."""
    device = resolve_device(device)
    base = configure(platforms.synthetic(n_lidars=lidars))
    if traj == "loop":
        cfg, _, _, course = run_synthetic.loop_course("experiment", base)
        wobble = 0.0
        course = {k: v for k, v in course.items() if not k.startswith("noise")}
    else:
        cfg = dataclasses.replace(
            base,
            mapping=dataclasses.replace(base.mapping, keyframe_dist=0.05,
                                        keyframe_angle_deg=0.5),
            loop=dataclasses.replace(base.loop, skip_interval=2, num_exclude_recent=3))
        course, wobble = {}, 0.05
    L = cfg.rig.n_lidars
    X = _pose(X_TANGENT, device)
    exts = _rig([Pose.identity(device=device) if l == 0 else se3.scale(X, float(l))
                 for l in range(L)])
    keep = {}

    def on_sweep(i, out, pipe):
        keep["pipe"] = pipe

    res = run_synthetic.run(frames, seed=seed, verbose=False, device=device, cfg=cfg,
                            extrinsics=exts, wobble=wobble, on_sweep=on_sweep,
                            slam=True, noise_std=noise, noise_seed=seed + 1000,
                            **course)
    pipe = keep["pipe"]
    db = pipe.full.mapper_state.db
    n_kf = int(db.head)
    kf_ate = {}
    if res["kf_gt_idx"] and pipe.n_loops > 0:
        kf_ate = {"kf_ate_odom_m": float(res["kf_ate_odom_m"]),
                  "kf_ate_corrected_m": float(res["kf_ate_corr_m"])}
    summary = {"ate_m": float(res["map_ate_m"]), "frames": frames, "traj": traj,
               "keyframes": n_kf, "loops": pipe.n_loops, **kf_ate,
               "platform": _platform(device),
               "timing_note": "stages over every sweep (the first builds the CUDA "
                              "kernels if they are not built yet); "
                              "odom_process waits for the device at each end "
                              "of a sweep, the stages read the host clock only",
               "timing": timing.all_stats()}
    map_xyz, map_mask = keyframe_map(db)
    count = pipe.loop_kf_count
    ls = pipe.loop_state
    res.update(summary=summary, map_xyz=map_xyz, map_mask=map_mask,
               kf_t=ls.poses.t[:count].cpu().numpy(),
               loop_edges=[(int(a), int(b)) for a, b, v in zip(
                   ls.loop_i.tolist(), ls.loop_j.tolist(), ls.loop_valid.tolist()) if v],
               scan_context=ls.sc_db.desc[count - 1].cpu().numpy() if count else None,
               times=np.arange(frames) * cfg.rig.models[0].scan_period)
    return res


def write_slam(res, root: str = OUTDIR, lidars: int = 1) -> str:
    s = res["summary"]
    d = _outdir("slam" if lidars == 1 else f"slam_l{lidars}", root)
    evaluation.save_tum(os.path.join(d, "traj_est.tum"), res["times"],
                        res["map_est_t"], res["map_est_q"])
    plots = Plots()
    plots.add("plot_trajectory", "trajectory.png", est_t=res["map_est_t"],
              gt_t=res["gt_t"], title=f"slam {s['traj']}")
    if res["map_xyz"].shape[0]:
        viz.export_map_pcd(os.path.join(d, "map.pcd"), res["map_xyz"], res["map_mask"])
        plots.add("plot_map", "map.png", xyz=res["map_xyz"], mask=res["map_mask"],
                  traj_t=res["map_est_t"])
    if res["scan_context"] is not None:
        plots.add("plot_pose_graph", "pose_graph.png", node_t=res["kf_t"],
                  loop_edges=[list(e) for e in res["loop_edges"]])
        plots.add("plot_scan_context", "scan_context.png", descriptor=res["scan_context"])
    plots.save(d)
    _write_json(d, "summary.json", s)
    return d


# ---------------------------------------------------------------- corridor

CORRIDOR_COMP_START = 15      # the companion's first sweep
CORRIDOR_THRESHOLD = 175.0    # the armed window's remap threshold


def _without_project_prior(cfg):
    return dataclasses.replace(cfg, odometry=dataclasses.replace(
        cfg.odometry, remap_project_prior=False))


def corridor_course(frames: int, noise: float, seed: int, device=None,
                    configure=_identity):
    """The degenerate tunnel of the JAX ``corridor`` program: the config
    (20 m range, tracker skipped on the steady path), the rendered sweeps
    (3 m ceiling, sensor mounted 1.2 m up, straight at 2 m/s, a companion
    in 3-of-10 bursts from sweep 15) and the ground truth in the sensor's
    frame."""
    device = resolve_device(device)
    base = configure(platforms.synthetic(n_lidars=1))
    model = base.rig.models[0]._replace(max_range=20.0)
    base = dataclasses.replace(
        base, rig=dataclasses.replace(base.rig, models=(model,)),
        tracker=dataclasses.replace(base.tracker, skip_steady=True))
    w = W.make_corridor_world(wall_height=3.0, ceiling=True, device=device)
    mount = Pose(torch.tensor([1.0, 0.0, 0.0, 0.0], device=device),
                 torch.tensor([0.0, 0.0, 1.2], device=device))
    traj = W.make_straight_trajectory(speed=2.0, wobble=0.02, device=device)
    imgs, gt = W.render_sequence(
        w, traj, model, frames, noise_std=noise, noise_seed=seed + 1000,
        extrinsic=mount, device=device,
        companions=torch.tensor([[5.0, 0.8, 0.12]], device=device),
        companion_frames=(CORRIDOR_COMP_START, frames), companion_period=(3, 10))
    # the pipeline estimates the sensor's trajectory: express the truth there
    g = se3.compose(Pose(gt.q[:frames], gt.t[:frames]), mount)
    g0 = Pose(g.q[:1].expand(frames, 4), g.t[:1].expand(frames, 3))
    gt_rel = se3.compose(se3.inverse(g0), g).t.cpu().numpy()
    return base, imgs, gt_rel



def measure_corridor(frames: int = 30, noise: float = 0.01, seed: int = 0, device=None,
                     configure=_identity):
    """Degenerate geometry: the corridor with a co-moving companion, run
    with the window's remap armed (threshold 175) and disarmed, then
    ``FullPipeline`` on ``indoor_degenerate`` (the mapper's gate). Per-axis
    error envelopes, the per-block eigenvalue trace, the per-sweep count of
    frozen directions, the mapper's eigenvalue floor and engagement."""
    device = resolve_device(device)
    base, imgs, gt_rel = corridor_course(frames, noise, seed, device, configure)
    thr_on, comp_start = CORRIDOR_THRESHOLD, CORRIDOR_COMP_START
    summary = {"frames": frames, "noise_std": noise,
               "companion": {"offset_xy": [5.0, 0.8], "radius": 0.12,
                             "from_frame": comp_start, "burst_on_period": [3, 10]},
               "eig_threshold": thr_on,
               "remap_max_freeze": base.odometry.remap_max_freeze,
               # where the threshold comes from: the JAX package's probe
               "floors_measured": {
                   "corridor_window_e0_band": [60, 160],
                   "rich_window_e0_min": 231.7,
                   "probe": "the JAX package's demos/calibrate_eig.py @ noise 0.01"}}
    ests = {}
    for label, thr in (("remap_on", thr_on), ("remap_off", 0.0)):
        cfg = dataclasses.replace(base, odometry=dataclasses.replace(
            base.odometry, eig_threshold=thr))
        pipe = OdometryPipeline(cfg, device=device)
        est, frozen, e0, eig_at = [], [], [], {}
        zero = torch.zeros((), device=device)
        for i in range(frames):
            out = pipe.process([RangeImage(*(f[i] for f in imgs))])
            est.append(out.pose.t)
            solved = out.win_frozen is not None
            # the trace deficit of the projector the solve applied
            frozen.append(out.win_frozen.sum() if solved else zero)
            e0.append(out.win_eig_shared[0] if solved else zero + float("inf"))
            if solved and i % 10 == 9 and out.win_eig is not None:
                eig_at[i] = out.win_eig
        est = torch.stack(est).cpu().numpy()
        frozen = torch.stack(frozen).cpu().numpy().astype(float).tolist()
        would = (torch.stack(e0) < thr_on).cpu().numpy().tolist()
        err = est - gt_rel
        eng = frozen[comp_start:]
        summary[label] = {
            "ex_final_m": float(err[-1, 0]),
            "ex_max_m": float(np.abs(err[:, 0]).max()),
            "ey_max_m": float(np.abs(err[:, 1]).max()),
            "ez_max_m": float(np.abs(err[:, 2]).max()),
            "frozen_dirs_per_frame": frozen,
            "engaged_frames": int(sum(1 for f in eng if f > 0)),
            "candidate_frames": int(sum(would[comp_start:])),
            "eig_min_trace": [[i] + np.round(v.cpu().numpy(), 2).tolist()
                              for i, v in eig_at.items()],
        }
        ests[label] = est
        print(f"{label}: ex_final={err[-1, 0]:+.2f} m ey_max={np.abs(err[:, 1]).max():.3f} m "
              f"engaged={summary[label]['engaged_frames']}/{len(eng)} frames", flush=True)

    # the mapper's scan-to-map degeneracy probe on the same tunnel
    # (lidar_mapper_keyframe.cpp:1172-1204, MAP_EIG_THRE)
    full_cfg = platforms.indoor_degenerate(base)
    fp = FullPipeline(full_cfg, device=device)
    map_eig, map_frozen, est_full = [], [], []
    for i in range(frames):
        fout = fp.process([RangeImage(*(f[i] for f in imgs))])
        est_full.append(fout.map_pose.t)
        if fout.mapped and fout.map_eig_min is not None:
            map_eig.append(fout.map_eig_min)
            map_frozen.append(torch.as_tensor(fout.map_frozen, device=device).float())
    map_eig = torch.stack(map_eig).cpu().numpy().tolist() if map_eig else []
    map_frozen = torch.stack(map_frozen).cpu().numpy().tolist() if map_frozen else []
    cut = len(map_eig) // 4
    eig_in, frozen_in = map_eig[cut:], map_frozen[cut:]
    err_full = torch.stack(est_full).cpu().numpy() - gt_rel
    mthr = full_cfg.mapping.eig_threshold
    summary["mapper"] = {
        "eig_threshold": mthr,
        "eig_min_floor": float(np.min(eig_in)) if eig_in else None,
        "eig_min_median": float(np.median(eig_in)) if eig_in else None,
        "candidate_sweeps": int(sum(1 for e in eig_in if e < mthr)),
        "engaged_sweeps": int(sum(1 for f in frozen_in if f > 0.5)),
        "mapped_sweeps": len(eig_in),
        "full_pipeline_ex_max_m": float(np.abs(err_full[:, 0]).max()),
        "full_pipeline_ez_max_m": float(np.abs(err_full[:, 2]).max()),
    }
    return {"summary": summary, "est": ests, "gt_rel": gt_rel}


def write_corridor(res, root: str = OUTDIR) -> str:
    d = _outdir("corridor", root)
    plots = Plots()
    for label, est in res["est"].items():
        plots.add("plot_trajectory", f"trajectory_{label}.png", est_t=est,
                  gt_t=res["gt_rel"], title=f"corridor {label}")
    plots.save(d)
    _write_json(d, "summary.json", res["summary"])
    return d


# ----------------------------------------------------------------- dynamic

DYNAMIC_MOVERS = ([[5.0, 2.0, 0.6], [-3.0, 6.0, 0.6], [7.0, -4.0, 0.5]],
                  [[0.0, 2.5]] * 3,
                  [[-1.2, -0.5], [0.8, -1.4], [-0.6, 1.3]])


def measure_dynamic(frames: int = 60, seed: int = 0, noise: float = 0.02, device=None,
                    configure=_identity):
    """Robust losses under moving objects: three pillar-sized movers cross
    the rich world; huber / gm / gnc_gm (c 0.12) with and without them."""
    device = resolve_device(device)
    base = configure(platforms.synthetic(n_lidars=1))
    w = W.make_world(torch.Generator().manual_seed(seed), device=device)
    traj = W.make_trajectory(torch.Generator().manual_seed(seed + 1), wobble=0.05,
                             device=device)
    movers = tuple(torch.tensor(x, device=device) for x in DYNAMIC_MOVERS)
    summary = {"frames": frames, "noise_std": noise, "gm_c": 0.12, "modes": {}}
    ests = {}
    for with_movers in (True, False):
        imgs, gt = W.render_sequence(w, traj, base.rig.models[0], frames,
                                     noise_std=noise, noise_seed=seed + 1000,
                                     movers=movers if with_movers else None,
                                     device=device)
        gt_t = gt.t[:frames].cpu().numpy()
        for mode in ("huber", "gm", "gnc_gm"):
            pipe = OdometryPipeline(C.with_loss_mode(base, mode, gm_c=0.12), device=device)
            est = torch.stack([pipe.process([RangeImage(*(f[i] for f in imgs))]).pose.t
                               for i in range(frames)]).cpu().numpy()
            ate = evaluation.ate_rmse(est, gt_t)
            key = f"{mode}{'_movers' if with_movers else ''}"
            summary["modes"][key] = {"ate_m": float(ate)}
            print(f"{key:16s} ate={ate*100:.2f} cm", flush=True)
            if with_movers:
                ests[key] = (est, gt_t)
    return {"summary": summary, "est": ests}


def write_dynamic(res, root: str = OUTDIR) -> str:
    d = _outdir("dynamic", root)
    plots = Plots()
    for key, (est, gt_t) in res["est"].items():
        plots.add("plot_trajectory", f"traj_{key}.png", est_t=est, gt_t=gt_t,
                  title=f"dynamic {key}")
    plots.save(d)
    _write_json(d, "summary.json", res["summary"])
    return d


# -------------------------------------------------------------------- long

def drift_trace(est_t: np.ndarray, gt_t: np.ndarray, gt_q: np.ndarray):
    """Unaligned drift: the estimate against the truth expressed in the
    first true pose's frame (the estimate starts there), as per-sweep
    position errors and the error at the end of each 100-sweep segment."""
    gt = Pose(torch.from_numpy(np.asarray(gt_q, np.float32)),
              torch.from_numpy(np.asarray(gt_t, np.float32)))
    n = gt.t.shape[0]
    g0 = Pose(gt.q[:1].expand(n, 4), gt.t[:1].expand(n, 3))
    gt_rel = se3.compose(se3.inverse(g0), gt).t.numpy()
    err = np.linalg.norm(est_t - gt_rel, axis=1)
    seg = [float(err[min(k + 99, len(err) - 1)]) for k in range(0, len(err), 100)]
    return gt_rel, err, seg


def measure_long(frames: int = 500, seed: int = 0, lidars: int = 1, noise: float = 0.02,
                 kf_dist: float | None = None, map_every: int | None = None,
                 device=None, configure=_identity):
    """Endurance: hundreds of sweeps under range noise, watching the
    marginal prior's consistency (drift must stay sublinear) and the
    keyframe ring."""
    device = resolve_device(device)
    cfg = configure(platforms.synthetic(n_lidars=lidars))
    if kf_dist:
        cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(
            cfg.mapping, keyframe_dist=kf_dist,
            skip_frames=map_every or cfg.mapping.skip_frames))
    res = run_sequence(cfg, frames, seed=seed, n_lidars=lidars, noise_std=noise,
                       device=device)
    gt_rel, err, seg = drift_trace(res["est_t"], res["gt_t"], res["gt_q"])
    n_kf = int(res["pipe"].mapper_state.db.head)
    res.update(gt_rel=gt_rel, summary={
        "frames": frames, "noise_std": noise,
        "ate_m": res["ate_m"], "fps": res["fps"],
        "err_final_m": float(err[-1]), "err_max_m": float(err.max()),
        "err_end_of_each_100": seg,
        "keyframes_inserted": n_kf,
        "keyframe_ring_wrapped": bool(n_kf > cfg.mapping.max_keyframes),
        "platform": _platform(res["pipe"].device),
        "timing_note": TIMING_NOTE,
        "timing": timing.all_stats(),
    })
    return res


def write_long(res, root: str = OUTDIR) -> str:
    d = _outdir("long", root)
    s = res["summary"]
    evaluation.save_tum(os.path.join(d, "traj_est.tum"), res["times"],
                        res["est_t"], res["est_q"])
    plots = Plots()
    plots.add("plot_trajectory", "trajectory.png", est_t=res["est_t"],
              gt_t=res["gt_rel"], title=f"long {s['frames']}f noise={s['noise_std']}")
    plots.save(d)
    _write_json(d, "summary.json", s)
    return d


# ----------------------------------------------------------------- scaling

def scaling_meshes(device) -> dict:
    """The JAX program's layouts, as stacked meshes: 8 shards in 1-D, 2 hosts
    x 4 and 2 hosts x 8."""
    return {"dd_8dev_1d": M.make_mesh(8, device=device),
            "dd_8dev_2x4": M.make_multihost_mesh(2, 4, device=device),
            "dd_16dev_2x8": M.make_multihost_mesh(2, 8, device=device)}


def _per_gn(mesh, iters: int) -> dict:
    return {k: {"calls": v["calls"] / iters, "bytes": v["bytes"] / iters}
            for k, v in mesh.collectives.items()}


def _card_ms(fn, reps: int = 10) -> float:
    """Device ms per call of ``fn`` (CUDA events around ``reps`` calls after
    one warm call)."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def dd_card_ms(poses, edges, mesh, map_shard=None, assoc_chunk: int | None = None) -> dict:
    """On the card: one GN step of ``optimize_pose_graph_dd`` on ``mesh``
    (every shard, stacked), one shard's linearization and interior
    elimination alone (shard 0's inputs; with ``map_shard``, a BA map
    ``DD.MapShard`` attached, its rows of shard 0 re-associated in the step,
    ``assoc_chunk`` rows at a time), and the separator solve (the damped
    Cholesky of the reduced system and its solve). The counterpart of the
    JAX package's ``demos/profile_dd_shard.py``."""
    part = DD.mesh_partition(edges, poses.q.shape[0], mesh)
    local, ez, _, ms_dev = DD._prepare_device_inputs(part, edges, None, map_shard, mesh)
    nd = mesh.ndim
    first = tuple([0] * nd)

    def one(x):
        return x[first][None] if isinstance(x, torch.Tensor) and x.ndim > nd else x

    shard0 = DD.DDPartition(*(one(x) if f not in ("sep_idx", "sep_mask") else x
                              for f, x in zip(DD.DDPartition._fields, local)))
    ez0 = tuple(one(x) for x in ez)
    ms0 = (None if ms_dev is None
           else tuple(type(rows)(*(one(x) for x in rows)) for rows in ms_dev))
    # the reduced separator system as the step builds it (the damping and a
    # strong diagonal stand in for the anchor: a Cholesky's time does not
    # depend on the values)
    S, g, sd, *_ = DD.shard_system(poses, local, ez, None, None, nd=nd)
    dims = tuple(range(nd))
    Sd = S.sum(dims) + torch.diag_embed(1e-3 * (sd.sum(dims) + 1e-3))
    Sd = Sd + 1e3 * torch.eye(Sd.shape[-1], device=Sd.device)
    gred = g.sum(dims)

    def sep_solve():
        L, _ = torch.linalg.cholesky_ex(Sd)
        return torch.cholesky_solve(gred[:, None], L)

    return {"step_ms_all_shards": _card_ms(lambda: DD.dd_pgo_step(
                poses, local, ez, None, ms_dev, mesh, assoc_chunk=assoc_chunk)),
            "shard_ms_per_gn": _card_ms(lambda: DD.shard_system(
                poses, shard0, ez0, None, ms0, assoc_chunk=assoc_chunk, nd=1)),
            "sep_solve_ms_per_gn": _card_ms(sep_solve),
            "separator_dim": int(Sd.shape[-1]),
            "interiors": int(part.int_idx.shape[1]),
            "owned_sep": int(part.own_rows.shape[1])}


# the scaling program's BA map: the JAX report's deployment shape
# (``scaling_model.py:294-296``) and association chunk
SCALING_BA_POINTS, SCALING_BA_MAP, SCALING_BA_CHUNK = 1024, 4096, 8
SCALING_REPORT_POSES = 1024


def cg_legacy_model(n_poses: int, n_edges: int, counted: dict, pcg_ms: float | None,
                    cg_iters_run: int, fabric=None) -> dict:
    """Counterpart of the JAX program's ``_pgo_comm_compute_model`` (the
    edge-sharded PCG step's analytic model): that formula's bytes per GN
    iteration, N·168 + 4 + cg_iters·N·24, at its own cg_iters (max(N/8, 32))
    and at the run's, beside the bytes and calls the mesh counted in the run
    (``counted``: per GN iteration, by collective and axes). With the card's
    ms of one PCG GN iteration on one device and a ``fabric``, rows for 8
    shards within a node and 16 over two nodes: the compute term that ms
    over the shards (as the JAX formula divides its FLOPs), the counted
    collectives on the node's fabric (8) or all between nodes (16, as the JAX
    formula charges them), through ``efficiency_from_card_ms``."""

    def formula(cg):
        return n_poses * (24 + 144) + 4 + cg * n_poses * 24

    cg_model = max(n_poses // 8, 32)
    calls = sum(v["calls"] for v in counted.values())
    nbytes = sum(v["bytes"] for v in counted.values())
    out = {"bytes_psum_per_gn_iter": formula(cg_model), "cg_iters_model": cg_model,
           "bytes_formula_at_run_cg_iters": formula(cg_iters_run),
           "cg_iters_run": cg_iters_run,
           "counted_per_gn": {"bytes": nbytes, "calls": calls, "by_axes": counted},
           "pcg_ms_per_gn_one_device": pcg_ms}
    if pcg_ms is None or fabric is None:
        return out
    for name, shards, shape in (("intra_8gpu", 8, [8]), ("inter_2node", 16, [2, 8])):
        on = {"bytes": nbytes, "count": calls}
        off = {"bytes": 0, "count": 0}
        meas = {"mesh": {"shape": shape},
                # a shard's edge rows (z_q, z_t, weight), the DD rows' definition
                "input_bytes_per_device": -(-n_edges // shards) * (4 + 3 + 6) * 4,
                "collectives_per_gn": ({"intra": on, "inter": off} if len(shape) == 1
                                       else {"intra": off, "inter": on})}
        out[name] = {"shards": shards, **SM.efficiency_from_card_ms(
            meas, pcg_ms / shards, 0.0, fabric)}
    return out


def measure_scaling(poses: int = 256, device=None) -> dict:
    """The JAX ``scaling`` program's measured rows on stacked meshes: the
    nested-dissection solve (8 GN iterations) on each layout of
    ``scaling_meshes``, its error and its largest deviation from 8 dense
    one-device steps, gated as the JAX program gates (deviation < 1e-2 m, no
    worse than dense + 5 mm), and the edge-sharded PCG on 8 shards (< half
    the initial error); each mesh's collectives per GN iteration; the PCG's
    legacy model (``cg_legacy_model``). On a GPU also the card's ms
    (``dd_card_ms``, 1-D layout, bare and with the BA map), one PCG GN
    iteration's ms, and the DD report (``scaling_model.dd_scaling_report``)
    over ``hgx_h100`` at the one-rank NCCL latency floor measured here.
    ``card_ms`` is measured at the report's one-node shape, 1024 poses on 8
    shards, whatever ``poses`` is."""
    device = resolve_device(device)
    n_poses = poses
    poses0, edges, gt = SM.make_survey_graph(n_poses, noise=0.02, device=device)
    iters = 8

    def err(p):
        return float(torch.linalg.norm(p.t - gt.t, dim=1).mean())

    err0 = err(poses0)
    ref = poses0
    for _ in range(iters):
        ref, _ = PG.pgo_step(ref, edges)
    err_ref = err(ref)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    results, collectives = {}, {}
    meshes = scaling_meshes(device)
    for name, mesh in meshes.items():
        out, _ = DD.optimize_pose_graph_dd(poses0, edges, mesh, iters=iters)
        err1 = err(out)
        exact = float((out.t - ref.t).abs().max())
        mesh.reset_counts()
        sync()
        t0 = time.perf_counter()
        out, _ = DD.optimize_pose_graph_dd(poses0, edges, mesh, iters=iters)
        sync()
        dt = time.perf_counter() - t0
        results[name] = {"wall_s": dt, "err_m": err1, "max_dev_from_dense_m": exact}
        collectives[name] = _per_gn(mesh, iters)
        if not exact < 1e-2:
            raise AssertionError(f"{name}: DD not exact vs dense ({exact})")
        # convergence belongs to the graph; the solver must match the dense basin
        if not err1 < err_ref + 5e-3:
            raise AssertionError(f"{name}: DD worse than dense ({err1} against {err_ref})")
        print(f"{name}: exact-vs-dense {exact:.2e} m, err {err0:.3f}->{err1:.3f} m "
              f"(dense {err_ref:.3f}), wall {dt * 1e3:.0f} ms", flush=True)

    mesh = meshes["dd_8dev_1d"]
    cg_iters = max(n_poses // 4, 32)
    mesh.reset_counts()
    out = PG.optimize_pose_graph(poses0, edges, iters=iters, mesh=mesh, solver="cg",
                                 cg_iters=cg_iters)
    err_cg = err(out)
    results["cg_8dev"] = {"err_m": err_cg, "cg_iters": cg_iters}
    collectives["cg_8dev"] = _per_gn(mesh, iters)
    if not err_cg < 0.5 * err0:
        raise AssertionError(f"cg_8dev: error {err_cg} not under half of {err0}")
    card_ms = model = pcg_ms = fabric = None
    if device.type == "cuda":
        fabric = SM.hgx_h100(SM.nccl_latency_floor_s(device))
        # one shard's ms at the report's one-node shape (1024 poses, 8 shards)
        rp, re_, rg = ((poses0, edges, gt) if n_poses == SCALING_REPORT_POSES
                       else SM.make_survey_graph(SCALING_REPORT_POSES, noise=0.02,
                                                 device=device))
        card_ms = {"pgo": dd_card_ms(rp, re_, meshes["dd_8dev_1d"])}
        ms = SM.survey_ba_map(rg, SCALING_BA_POINTS, SCALING_BA_MAP)
        card_ms["ba"] = dd_card_ms(rp, re_, meshes["dd_8dev_1d"], map_shard=ms,
                                   assoc_chunk=SCALING_BA_CHUNK)
        del ms, rp, re_, rg
        # the separator solve's cost does not depend on the values: the BA
        # row takes the PGO one, as the JAX program does
        card_ms["ba"]["sep_solve_ms_per_gn"] = card_ms["pgo"]["sep_solve_ms_per_gn"]
        model = SM.dd_scaling_report(fabric, card_ms, SCALING_BA_POINTS, SCALING_BA_MAP,
                                     device=device)
        pcg_ms = _card_ms(lambda: PG.pgo_step_cg(poses0, edges, cg_iters=cg_iters), reps=3)
    summary = {
        "poses": n_poses, "edges": int(edges.i.shape[0]), "gn_iters": iters,
        "platform": _platform(device),
        "measured": results,
        # calls and bytes (one shard's contribution) by collective and axes
        "collectives_per_gn": collectives,
        "card_ms": card_ms,
        # the DD report on the card (scaling_model.dd_scaling_report): the JAX
        # program's four rows from the card's shard ms and a fabric's
        # published figures; None on the CPU
        "model": model,
        "model_cg_legacy": cg_legacy_model(n_poses, int(edges.i.shape[0]),
                                           collectives["cg_8dev"], pcg_ms, cg_iters, fabric),
        "device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
    }
    return {"summary": summary}


def write_scaling(res, root: str = OUTDIR) -> str:
    d = _outdir("scaling", root)
    _write_json(d, "summary.json", res["summary"])
    return d


# -------------------------------------------------------------------- main

def _print(summary, keys):
    print(json.dumps({k: summary[k] for k in keys if k in summary}))


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="program", required=True)
    for name in ("single", "mc", "calib", "inject_ext", "scaling", "slam", "long",
                 "corridor", "dynamic"):
        p = sub.add_parser(name)
        # calib needs runway: hand-eye pair accumulation + sigma2 gate
        # (~40 sweeps at wobble 0.25), then n_calib_samples voting sweeps
        p.add_argument("--frames", type=int,
                       default={"calib": 90, "long": 500}.get(name, 30))
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--lidars", type=int, default=1)
        if name in ("mc", "inject_ext"):
            p.add_argument("--trials", type=int, default=5 if name == "mc" else 3)
        if name == "scaling":
            p.add_argument("--poses", type=int, default=256)
        if name == "slam":
            p.add_argument("--traj", choices=("wander", "loop"), default="wander")
        if name in ("slam", "long", "dynamic"):
            p.add_argument("--noise", type=float, default=0.02)
        if name == "corridor":
            # the remap threshold is calibrated at the 0.01 operating point
            p.add_argument("--noise", type=float, default=0.01)
            # the JAX program's CORR_PP=0: the remap leaves the window's
            # marginalization prior unprojected
            p.add_argument("--no-project-prior", action="store_true")
        if name == "dynamic":
            p.set_defaults(frames=60)
        if name == "long":
            # --kf_dist 0.1 --map_every 1 --frames 560 crosses the 512-slot
            # keyframe ring cap
            p.add_argument("--kf_dist", type=float, default=None)
            p.add_argument("--map_every", type=int, default=None)
    p = sub.add_parser("plot", help="draw a program's PNGs from its output directory "
                                    "(needs matplotlib)")
    p.add_argument("dir")
    a = ap.parse_args(argv)
    if a.program == "plot":
        for path in draw(a.dir):
            print(path)
    elif a.program == "single":
        res = measure_single(a.frames, a.seed, a.lidars)
        write_single(res)
        _print(res["summary"], ("ate_m", "fps"))
    elif a.program == "mc":
        res = measure_mc(a.trials, a.frames)
        write_mc(res)
        print(json.dumps({k: round(v["ate_mean_m"], 4)
                          for k, v in res["summary"]["cells"].items()}))
    elif a.program == "inject_ext":
        res = measure_inject_ext(a.frames, a.seed, a.trials)
        write_inject_ext(res)
        print(json.dumps(res["summary"]))
    elif a.program == "calib":
        res = measure_calib(a.frames, a.seed, a.lidars)
        write_calib(res)
        print(json.dumps(res["summary"]))
    elif a.program == "scaling":
        res = measure_scaling(a.poses)
        write_scaling(res)
        print(json.dumps(res["summary"]["measured"]))
        print(json.dumps({k: {e: v.get(e) for e in ("efficiency_per_iter_measured",
                                                     "efficiency_full_solve_measured")}
                          for k, v in (res["summary"]["model"] or {}).items()}))
    elif a.program == "slam":
        res = measure_slam(a.frames, a.seed, a.lidars, a.traj, a.noise)
        write_slam(res, lidars=a.lidars)
        _print(res["summary"], ("ate_m", "keyframes", "loops", "kf_ate_odom_m",
                                "kf_ate_corrected_m"))
    elif a.program == "corridor":
        res = measure_corridor(a.frames, a.noise, a.seed,
                               configure=(_without_project_prior if a.no_project_prior
                                          else _identity))
        write_corridor(res)
        print(json.dumps({k: {kk: vv for kk, vv in v.items()
                              if kk not in ("eig_min_trace", "frozen_dirs_per_frame")}
                          for k, v in res["summary"].items()
                          if isinstance(v, dict) and "ex_final_m" in v}))
    elif a.program == "dynamic":
        res = measure_dynamic(a.frames, a.seed, a.noise)
        write_dynamic(res)
        print(json.dumps(res["summary"]["modes"]))
    elif a.program == "long":
        res = measure_long(a.frames, a.seed, a.lidars, a.noise, a.kf_dist, a.map_every)
        write_long(res)
        _print(res["summary"], ("ate_m", "err_final_m", "keyframes_inserted"))


if __name__ == "__main__":
    main()
