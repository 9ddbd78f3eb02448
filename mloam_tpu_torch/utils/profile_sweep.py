"""Where one steady sweep spends its time on the GPU.

    python -m mloam_tpu_torch.utils.profile_sweep [n_sweeps] [trace.json] [--mapping | --slam]
        [--rig dual | hercules [--unrolled]]

Warms the single-LiDAR pipeline at the full width of the synthetic platform
(with ``--rig``: the dual synthetic rig, or the four-lidar Hercules rig, in
mode 0 with the calibration program's extrinsics installed; their steady
sweeps run the batched frontend, or with ``--unrolled`` one frontend per
lidar, as a rig of mixed sensor models does),
then drives ``OdometryPipeline.process`` (with ``--mapping``:
``FullPipeline.process``, warmed until its map holds keyframes; every
second sweep is then mapped) on fresh sweeps: ``n_sweeps``
untraced with ``sync_timing`` on, whose wall time and stage times (the
pipeline's own ``utils/timing`` spans, each waiting for the device at its
entry and exit, so a stage's time holds its device work) are printed;
``n_sweeps`` untraced with the stage timers reading the host clock only (the
pipeline's default), whose wall time is printed beside; and ``n_sweeps``
under ``torch.profiler`` (``sync_timing`` on), from which come the
device-busy time and idle share, the device ops per sweep and the kernels
and host ops that take most time.

With ``--slam``: ``SlamPipeline`` on the floor loop course (mapping every
third sweep, keyframes every 0.5 m, 4 recent keyframes excluded, the
correlation seed on), warmed until its keyframe sweeps submit detections;
then every sweep is traced on its own until ``n_sweeps`` of each kind were:
the keyframe sweep (the sweep after a keyframe, which adds it to the loop
graph and submits a detection), the mapped sweep and the pass-through sweep;
for each kind its device ops, device-busy ms, traced wall ms and idle share
(no stage time is read there, so the stage timers keep the default).

One JSON object per line. Needs a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import torch

from mloam_tpu_torch import resolve_device
from mloam_tpu_torch.core import se3
from mloam_tpu_torch.core.rangeimage import RangeImage
from mloam_tpu_torch.models import experiments, platforms, run_synthetic
from mloam_tpu_torch.models.pipeline import FullPipeline, OdometryPipeline, SlamPipeline
from mloam_tpu_torch.utils import timing


def _device_kernels(prof) -> dict:
    """{kernel name: [launches, device µs]} of a profiler run."""
    kernels = {}
    for ev in prof.events():
        if getattr(ev, "device_type", None) is not None and "CUDA" in str(ev.device_type):
            k = kernels.setdefault(ev.name, [0, 0.0])
            k[0] += 1
            k[1] += ev.device_time if hasattr(ev, "device_time") else ev.cuda_time
    return kernels


def _traced(fn):
    """(result, profiler, traced wall ms) of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, prof, (time.perf_counter() - t0) * 1e3


def slam_main(n_sweeps: int = 3):
    """Trace keyframe, mapped and pass-through sweeps of ``SlamPipeline``."""
    dev = resolve_device(None)
    cfg = platforms.synthetic(n_lidars=1)
    cfg = dataclasses.replace(
        cfg,
        mapping=dataclasses.replace(cfg.mapping, keyframe_dist=0.5, skip_frames=3),
        loop=dataclasses.replace(cfg.loop, skip_interval=1, num_exclude_recent=4,
                                 loop_distance_threshold=10.0, capacity=64))
    n_total = 40 + 9 * n_sweeps
    seqs, _ = run_synthetic.render_rig(
        cfg, n_total, seed=3, device=dev, world={"extent": 30.0, "n_walls": 20, "n_poles": 10},
        loop={"radius": 6.0, "period_s": 10.0})
    frames = iter(RangeImage(*(f[i] for f in seqs[0])) for i in range(n_total))
    pipe = SlamPipeline(cfg, device=dev)
    while pipe.n_detections == 0:
        pipe.process([next(frames)])
    seen = {"keyframe": [], "mapped": [], "pass": []}
    for f in frames:
        if min(len(v) for v in seen.values()) >= n_sweeps:
            break
        kf0, det0 = pipe.loop_kf_count, pipe.n_detections
        out, prof, wall_ms = _traced(lambda: pipe.process([f]))
        kind = ("keyframe" if pipe.n_detections != det0 or pipe.loop_kf_count != kf0
                else "mapped" if out.full.mapped else "pass")
        kernels = _device_kernels(prof)
        busy_ms = sum(v[1] for v in kernels.values()) / 1e3
        seen[kind].append({"device_ops": sum(v[0] for v in kernels.values()),
                           "device_busy_ms": busy_ms, "wall_ms_traced": wall_ms,
                           "device_idle_share": 1.0 - busy_ms / wall_ms,
                           "detection_submitted": pipe.n_detections != det0})
    print(json.dumps({"slam_sweeps": seen, "n_loops": pipe.n_loops,
                      "device": torch.cuda.get_device_name(0)}), flush=True)


RIGS = {"dual": lambda: platforms.synthetic(n_lidars=2, extrinsic_mode=0),
        "hercules": lambda: platforms.vehicle_hercules(extrinsic_mode=0)}


def main(n_sweeps: int = 3, trace_path: str | None = None, mapping: bool = False,
         rig: str | None = None, unrolled: bool = False):
    dev = resolve_device(None)
    cfg = RIGS[rig]() if rig else platforms.synthetic(n_lidars=1)
    L = cfg.rig.n_lidars
    ext = se3.exp(torch.tensor([[0.0] * 6] + [list(x) for x in
                                              experiments.CALIB_TANGENTS[:L - 1]],
                               device=dev))
    warm = cfg.odometry.window_size + 3
    n_total = warm + 3 * n_sweeps
    seqs, _ = run_synthetic.render_rig(cfg, n_total, seed=0, extrinsics=ext, device=dev)
    frames = iter([RangeImage(*(f[i] for f in imgs)) for imgs in seqs]
                  for i in range(n_total))
    pipe = (FullPipeline if mapping else OdometryPipeline)(cfg, device=dev, sync_timing=True)
    odom = pipe.odom if mapping else pipe
    if L > 1:
        odom.set_extrinsics(ext)
    if unrolled:
        odom._uniform_rig = False
    stages = ("odom_mea_pre", "odom_tracker", "odom_solver") + (("map_step",) if mapping else ())
    for _ in range(warm):
        pipe.process(next(frames))

    def untraced_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_sweeps):
            pipe.process(next(frames))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n_sweeps

    timing.reset()
    wall_ms = untraced_ms()
    stage_ms = {k: [x * 1e3 for x in timing._registry[k]] for k in stages}
    pipe.sync_timing = odom.sync_timing = False
    wall_ms_host_timers = untraced_ms()
    pipe.sync_timing = odom.sync_timing = True
    print(json.dumps({
        "untraced_sweeps": n_sweeps,
        "wall_ms_per_sweep_untraced": wall_ms,
        "wall_ms_per_sweep_untraced_host_timers": wall_ms_host_timers,
        "mapping": mapping, "lidars": L, "batched_frontend": odom._uniform_rig,
        "stage_ms": stage_ms,
        "device": torch.cuda.get_device_name(0)}), flush=True)

    def sweeps():
        for _ in range(n_sweeps):
            pipe.process(next(frames))

    _, prof, wall_ms = _traced(sweeps)
    wall_ms /= n_sweeps
    kernels = _device_kernels(prof)
    total_us = sum(v[1] for v in kernels.values())
    launches = sum(v[0] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:15]
    print(json.dumps({
        "profiled_sweeps": n_sweeps,
        "wall_ms_per_sweep_traced": wall_ms,
        "device_busy_ms_per_sweep": total_us / 1e3 / n_sweeps,
        "device_idle_share": 1.0 - (total_us / 1e3 / n_sweeps) / wall_ms,
        "device_ops_per_sweep": launches / n_sweeps,
        "top_kernels": [{"name": k[:90], "count_per_sweep": v[0] / n_sweeps,
                         "device_ms_per_sweep": v[1] / 1e3 / n_sweeps}
                        for k, v in top],
    }), flush=True)
    cpu_top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:12]
    print(json.dumps({"top_host_ops": [
        {"name": e.key[:60], "calls_per_sweep": e.count / n_sweeps,
         "self_cpu_ms_per_sweep": e.self_cpu_time_total / 1e3 / n_sweeps}
        for e in cpu_top]}), flush=True)
    if trace_path:
        prof.export_chrome_trace(trace_path)


if __name__ == "__main__":
    argv = sys.argv[1:]
    rig = None
    if "--rig" in argv:
        i = argv.index("--rig")
        rig = argv[i + 1]
        if rig not in RIGS:
            sys.exit(f"--rig takes one of {sorted(RIGS)}, not {rig!r}")
        del argv[i:i + 2]
    flags = {"--mapping", "--slam", "--unrolled"}
    args = [a for a in argv if a not in flags]
    if "--slam" in argv:
        slam_main(int(args[0]) if args else 3)
    else:
        main(int(args[0]) if args else 3, args[1] if len(args) > 1 else None,
             mapping="--mapping" in argv, rig=rig, unrolled="--unrolled" in argv)
