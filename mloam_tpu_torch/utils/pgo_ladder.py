"""Dense Cholesky against PCG on ring pose graphs of growing size, on the GPU.

    python3 -m mloam_tpu_torch.utils.pgo_ladder [--iters K] N [N ...]

For each pose count N: a ring (``ring_graph``) solved by ``K`` damped GN
steps with each solver, the dense step's peak device memory, and the two
solutions' largest difference. A dense solve that runs out of device memory
is reported as such. One JSON line per ring, so that the pose count where
``optimize_pose_graph(solver="auto")`` switches
(``sharded_pgo.AUTO_DENSE_MAX_POSES``) can be read off the card.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch

from mloam_tpu_torch.core import se3
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.parallel import sharded_pgo as PG


def ring_graph(n, device, seed=21, drift_total=None):
    """An n-pose ring (radius 60 m) with noisy sequential edges, loop edges
    every 50 poses, 8 zero-weight padding edges, and a start drifted by a
    per-pose increment (scaled so that the ring drifts as far in total as a
    ring of ``drift_total`` poses when that is given)."""
    g = torch.Generator().manual_seed(seed)
    ang = torch.arange(n) * (2 * math.pi / n)
    xi = torch.zeros(n, 6)
    xi[:, 0], xi[:, 1] = 60 * torch.cos(ang), 60 * torch.sin(ang)
    xi[:, 5] = ang + math.pi / 2
    gt = se3.exp(xi)
    gt = Pose(gt.q, xi[:, :3].clone())
    i = torch.arange(n - 1)
    rel = se3.relative(Pose(gt.q[i], gt.t[i]), Pose(gt.q[i + 1], gt.t[i + 1]))
    rel = se3.compose(rel, se3.exp(5e-4 * torch.randn(n - 1, 6, generator=g)))
    li = torch.arange(0, n - 50, 50)
    lj = li + 50
    lrel = se3.relative(Pose(gt.q[li], gt.t[li]), Pose(gt.q[lj], gt.t[lj]))
    pad = 8
    edges = PG.PoseGraphEdges(
        i=torch.cat([i, li, torch.zeros(pad, dtype=torch.int64)]).to(device),
        j=torch.cat([i + 1, lj, torch.zeros(pad, dtype=torch.int64)]).to(device),
        z_q=torch.cat([rel.q, lrel.q, Pose.identity((pad,)).q]).to(device),
        z_t=torch.cat([rel.t, lrel.t, torch.zeros(pad, 3)]).to(device),
        weight=torch.cat([torch.ones(n - 1, 6), 5 * torch.ones(len(li), 6),
                          torch.zeros(pad, 6)]).to(device))
    step = torch.tensor([0.01, 0.005, 0, 0, 0, 0.0005])
    if drift_total is not None:
        step = step * (drift_total / n)
    drift = se3.exp(torch.outer(torch.arange(n, dtype=torch.float32), step))
    init = se3.compose(gt, drift)
    return Pose(init.q.to(device), init.t.to(device)), edges


def pose_diff(a, b):
    """Largest translation difference (m) and quaternion difference (up to
    sign) between two pose sets."""
    dt = float((a.t - b.t).norm(dim=-1).max())
    dq = float(torch.minimum((a.q - b.q).abs().amax(-1), (a.q + b.q).abs().amax(-1)).max())
    return dt, dq


def timed_solve(init, edges, solver, iters):
    """(poses, ms, peak device bytes) of one ``optimize_pose_graph`` call."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    out = PG.optimize_pose_graph(init, edges, iters=iters, solver=solver)
    torch.cuda.synchronize()
    return (out, (time.perf_counter() - t) * 1e3,
            torch.cuda.max_memory_allocated() - base)


def rung(n, iters, order=("dense", "cg"), drift_total=600):
    """One ring of ``n`` poses: each solver timed in ``order``; a dense
    solve that runs out of device memory is recorded, not raised."""
    init, edges = ring_graph(n, torch.device("cuda"), drift_total=drift_total)
    ms = {"dense": [], "cg": []}
    res, peak = {}, {}
    for solver in order:
        try:
            res[solver], t, peak[solver] = timed_solve(init, edges, solver, iters)
        except (torch.cuda.OutOfMemoryError, RuntimeError) as e:
            # the allocator's own error, or cuSOLVER's failed workspace
            if not isinstance(e, torch.cuda.OutOfMemoryError) and "ALLOC" not in str(e):
                raise
            res[solver], t, peak[solver] = None, None, f"out of memory: {str(e)[:120]}"
            torch.cuda.empty_cache()
        ms[solver].append(t)
    out = {"poses": n, "gn_steps": iters, "cg_iters": n + n // 4,
           "dense_ms": ms["dense"], "cg_ms": ms["cg"], "peak_bytes": peak,
           "auto_takes": "cg" if n > PG.AUTO_DENSE_MAX_POSES else "dense"}
    if res.get("dense") is not None:
        dt, dq = pose_diff(res["cg"], res["dense"])
        out.update(faster="cg" if min(ms["cg"]) < min(ms["dense"]) else "dense",
                   max_abs_diff_t_m=dt, max_abs_diff_q=dq,
                   finite=bool(math.isfinite(dt) and math.isfinite(dq)))
    else:
        out.update(faster="cg", finite=bool(torch.isfinite(res["cg"].t).all()))
    del init, edges, res
    torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("poses", type=int, nargs="+")
    ap.add_argument("--iters", type=int, default=1, help="GN steps a solve")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("pgo_ladder: no CUDA device")
    props = torch.cuda.get_device_properties(0)
    print(json.dumps({"device": props.name, "total_memory_bytes": props.total_memory}))
    rung(256, args.iters)     # warm-up: the first solves of a process pay its set-up
    for n in args.poses:
        print(json.dumps(rung(n, args.iters)), flush=True)


if __name__ == "__main__":
    main()
