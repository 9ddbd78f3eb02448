"""The benchmark of the PyTorch and CUDA port, one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port, ``mloam_tpu_torch/``. Needs as many CUDA devices as the cell
asks for: without them it exits 2 and prints no result. Prints earlier
lines of detail, the numbers compared beside their limits as the last lines
of standard error, and as the last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``.

The pose-graph cells run the port's PyTorch ops and build no kernel; a cell
that drives one of the port's CUDA kernels builds it on first use into the
port's fixed ``mloam_tpu_torch/_build/`` inside the checkout, so only a
checkout's first run compiles.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from portbench import harness  # noqa: E402


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             pkg=harness.PKG, root=harness.ROOT, t_start: float | None = None) -> dict:
    """Run cell ``name`` on ``device``; the result's fields and the raw
    measurements (``ctx``). No check for a chip here: ``main`` makes it."""
    import torch

    bench = harness.benchmark(root)
    cell = harness.cell_spec(bench, name)
    conf, traffic, limits = harness.cell_files(cell, pkg)
    device = torch.device(device)
    ctx = harness.kind_module(traffic, pkg).run(
        conf, traffic, limits, seed, seconds, trace, device,
        T_START if t_start is None else t_start)
    ctx.update(cell=cell, conf=conf, traffic=traffic,
               device_kind=(torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"))
    specs = harness.cell_metrics(bench, name, trace)
    metrics = harness.read_metrics(specs, ctx, pkg)
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": ctx["device_kind"], "count": int(cell["chips"]),
           "memory_peak_bytes": int(ctx["memory_peak_bytes"])}
    breakdown = None
    if trace:
        from portbench import trace as T
        dev["busy_s"] = T.busy_s(ctx["trace"])
        dev["window_s"] = ctx["trace"].window_s
        breakdown = T.breakdown(ctx["trace"])
    correct = harness.passed(ctx["checks"]) and ctx["failed"] == 0
    return {"correct": correct, "attempted": ctx["attempted"], "failed": ctx["failed"],
            "metrics": metrics, "device": dev, "checks": ctx["checks"],
            "breakdown": breakdown, "ctx": ctx}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    # one process, one host thread for PyTorch's CPU ops: the device does the
    # work, and idle worker threads only add to the host's noise
    torch.set_num_threads(1)
    cell = harness.cell_spec(harness.benchmark(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    r = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0")
    ctx = r["ctx"]
    detail = {k: ctx[k] for k in ("setup_s", "setup_phases", "window", "reference_s", "compared",
                                  "attempted", "memory_peak_bytes") if k in ctx}
    if "trace" in ctx:
        detail["traced_units"] = ctx["trace"].units
        detail["traced_device_ops"] = len(ctx["trace"].device)
    print("portbench detail " + json.dumps(detail, default=str), flush=True)
    bad = harness.loaded_forbidden()
    if bad:
        print(f"portbench: forbidden modules loaded in this process: {bad}", file=sys.stderr)
        return 3
    for k, c in r["checks"].items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(r["correct"], r["attempted"], r["failed"], r["metrics"],
                              r["device"], r["checks"], r["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
