"""The readings the limits of a pose-graph cell are set from, read on the
card at the cell's own size, from the same inputs a run makes.

* The program's (lower) readings: the program's first ``--solves`` solves
  of a drive, chained as a run chains them, each compared with the float64
  reference's solve from the program's start, as a run compares them: the
  first solve by its median pose, the warm solves by their widest.
* The control's (upper) readings: the reference put in the program's place
  and computed in the precision below the configuration's. The port states
  float32 with TF32 off, so the control is the reference in float32 with
  TF32 matrix products on, chained the same way and compared the same way.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--solves 3]

Prints one JSON line a seed, with its worst gaps and the limits in force.
The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import harness


def tf32(on: bool):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def program_gaps(P, conf, traffic, limits, inp, solves: int, device) -> dict:
    """The numbers of the program's first ``solves`` solves, each the worst
    over them."""
    tf32(False)
    solve = P.program_solver(conf, traffic, inp)
    answers = P.chain(solve, inp, 0, solves, None, lambda: torch.cuda.synchronize(device))
    kept = {k: (P.as_matrices(*st), P.as_matrices(*a)) for k, st, a in answers}
    return P.compare(inp, kept, int(traffic["gn_steps"]), device, limits)[0]


def control_gaps(P, traffic, limits, inp, solves: int, device) -> dict:
    """The numbers of the control's first ``solves`` solves: the reference
    in float32 with TF32 matrix products, in the program's place."""
    steps = int(traffic["gn_steps"])
    kept, last = {}, None
    for k in range(solves):
        start = P.as_matrices(inp.q0, inp.t0) if k == 0 else last
        tf32(True)
        last = P.reference_answer(inp, k, start[0], start[1], steps, torch.float32, device)
        tf32(False)
        kept[k] = (start, last)
    return P.compare(inp, kept, steps, device, limits)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--solves", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    cell = harness.cell_spec(harness.benchmark(), args.workload)
    conf, traffic, limits = harness.cell_files(cell)
    P = harness.kind_module(traffic)
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed in seeds + sorted(ctl - set(seeds)):
        inp = P.Inputs(conf, seed, device)
        out = {"workload": args.workload, "seed": seed, "solves": args.solves,
               "limits": limits, "device": torch.cuda.get_device_name(device)}
        if seed in seeds:
            out["program"] = program_gaps(P, conf, traffic, limits, inp, args.solves, device)
        if seed in ctl:
            out["control"] = control_gaps(P, traffic, limits, inp, args.solves, device)
            out["control_fails_a_limit"] = any(out["control"][k] > limits[k] for k in limits)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
