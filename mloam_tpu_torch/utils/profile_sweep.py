"""Where one steady sweep spends its time on the GPU.

    python -m mloam_tpu_torch.utils.profile_sweep [n_sweeps] [trace.json] [--mapping]

Warms the single-LiDAR pipeline at the full width of the synthetic platform,
then drives ``OdometryPipeline.process`` (with ``--mapping``:
``FullPipeline.process``, warmed until its map holds keyframes; every
second sweep is then mapped) on fresh sweeps: ``n_sweeps``
untraced, whose wall time and stage times (the pipeline's own
``utils/timing`` spans) are printed, and ``n_sweeps`` under
``torch.profiler``, from which come the device-busy time and idle share, the
device ops per sweep and the kernels and host ops that take most time. One
JSON object per line. Needs a CUDA device.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from mloam_tpu_torch import resolve_device
from mloam_tpu_torch.core.rangeimage import RangeImage
from mloam_tpu_torch.models import platforms, run_synthetic
from mloam_tpu_torch.models.pipeline import FullPipeline, OdometryPipeline
from mloam_tpu_torch.utils import timing


def main(n_sweeps: int = 3, trace_path: str | None = None, mapping: bool = False):
    dev = resolve_device(None)
    cfg = platforms.synthetic(n_lidars=1)
    warm = cfg.odometry.window_size + 3
    imgs, _ = run_synthetic.render(cfg, warm + 2 * n_sweeps, seed=0, device=dev)
    frames = iter(RangeImage(*(f[i] for f in imgs)) for i in range(imgs[0].shape[0]))
    pipe = (FullPipeline if mapping else OdometryPipeline)(cfg, device=dev)
    stages = ("odom_mea_pre", "odom_tracker", "odom_solver") + (("map_step",) if mapping else ())
    for _ in range(warm):
        pipe.process([next(frames)])

    timing.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_sweeps):
        pipe.process([next(frames)])
    torch.cuda.synchronize()
    print(json.dumps({
        "untraced_sweeps": n_sweeps,
        "wall_ms_per_sweep_untraced": (time.perf_counter() - t0) * 1e3 / n_sweeps,
        "mapping": mapping,
        "stage_ms": {k: [x * 1e3 for x in timing._registry[k]] for k in stages},
        "device": torch.cuda.get_device_name(0)}), flush=True)

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_sweeps):
            pipe.process([next(frames)])
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_sweeps

    kernels = {}
    for ev in prof.events():
        if getattr(ev, "device_type", None) is not None and "CUDA" in str(ev.device_type):
            k = kernels.setdefault(ev.name, [0, 0.0])
            k[0] += 1
            k[1] += ev.device_time if hasattr(ev, "device_time") else ev.cuda_time
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
    args = [a for a in sys.argv[1:] if a != "--mapping"]
    main(int(args[0]) if args else 3, args[1] if len(args) > 1 else None,
         mapping="--mapping" in sys.argv[1:])
