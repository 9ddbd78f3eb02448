"""Runner of the traffic kind ``pgo_loops``: the pose-graph solves of M-LOAM's
loop module over one drive, through the port's
``parallel/sharded_pgo.optimize_pose_graph`` on one device.

Each accepted loop closure commits its loop edge and re-solves the whole
keyframe graph with ``gn_steps`` Gauss-Newton steps, warm-started from the
poses of the solve before (the port's ``SlamPipeline._accept_loop``, whose
loop graph keeps fixed loop slots, unused ones weighing 0). Solve s of a
drive has the loops 0..s live; its start is the previous solve's poses, or
for s = 0 the odometry. After the drive's last loop the next drive starts
again from the odometry. Every solve is read back (a synchronise) before
the next starts.

``--trace 0``: ``warm_solves`` solves in set-up, then solves while the
window is open; ``pgo_gn_ms`` is the time from the window's opening to the
end of its last solve over the Gauss-Newton steps of all its solves.
``--trace 1``: ``trace_solves`` solves under the profiler.

After the window the program's state is freed and the reference
(``portbench.ref.pgo``, float64) solves, from the same inputs, the drive's
first solve (from the odometry, which the benchmark made) and
``check_solves`` solves of the window drawn from the seed, each from the
start the program had: the poses of the program's solve before. The first
solve gives the median pose's gaps, the window's the widest (``numbers``);
each is compared with its limit.
"""

from __future__ import annotations

import gc
import importlib
import time

import torch

from portbench import gen, harness
from portbench import trace as T
from portbench.ref import pgo as ref

PROGRAM = "mloam_tpu_torch.parallel.sharded_pgo"
PROGRAM_POSE = "mloam_tpu_torch.core.se3"


class Inputs:
    """The drive's inputs on ``device``: the odometry start, the edges and
    the sqrt-weights of each solve of a drive."""

    def __init__(self, conf: dict, seed: int, device):
        g = gen.drive_graph(conf, seed)
        self.n_solves = int(conf["n_loops"])
        dev = torch.device(device)
        self.q0 = torch.from_numpy(g.start_q).to(dev)
        self.t0 = torch.from_numpy(g.start_t).to(dev)
        self.i = torch.from_numpy(g.i).to(dev)
        self.j = torch.from_numpy(g.j).to(dev)
        self.z_q = torch.from_numpy(g.z_q).to(dev)
        self.z_t = torch.from_numpy(g.z_t).to(dev)
        base = torch.from_numpy(g.weight).to(dev)
        loop = torch.from_numpy(g.loop).to(dev)
        # [S, E, 6]: solve s has the sequential edges and the loops 0..s live
        s = torch.arange(self.n_solves, device=dev)[:, None]
        live = (loop[None] < 0) | (loop[None] <= s)
        self.weights = (base[None] * live)[..., None].expand(-1, -1, 6).contiguous()

    def solve_index(self, k: int) -> int:
        """The drive's solve that the k-th solve of a run is."""
        return k % self.n_solves


def program_solver(conf: dict, traffic: dict, inp: Inputs):
    """solve(k, q, t) -> (q, t): the program's k-th solve of a run from the
    poses (q, t)."""
    pgo = importlib.import_module(PROGRAM)
    Pose = importlib.import_module(PROGRAM_POSE).Pose
    steps, solver = int(traffic["gn_steps"]), conf["solver"]

    def solve(k, q, t):
        s = inp.solve_index(k)
        edges = pgo.PoseGraphEdges(inp.i, inp.j, inp.z_q, inp.z_t, inp.weights[s])
        out = pgo.optimize_pose_graph(Pose(q, t), edges, iters=steps, anchor_idx=0,
                                      solver=solver)
        return out.q, out.t

    return solve


def chain(solve, inp: Inputs, k0: int, count: int, last, sync):
    """``count`` solves from the run's k0-th, each from the one before
    (``last``: the (q, t) the k0-th starts from unless it begins a drive);
    [(k, start, answer)]."""
    out = []
    for k in range(k0, k0 + count):
        start = (inp.q0, inp.t0) if inp.solve_index(k) == 0 or last is None else last
        last = solve(k, *start)
        sync()
        out.append((k, start, last))
    return out


def reference_answer(inp: Inputs, k: int, R0, t0, steps: int, dtype, device):
    """The reference's (R, t) of the run's k-th solve from the poses (R0, t0)."""
    g = ref.Graph(inp.i.to(device), inp.j.to(device), inp.z_q.to(device),
                  inp.z_t.to(device), inp.weights[inp.solve_index(k)].to(device), dtype)
    return ref.solve(R0.to(device, dtype), t0.to(device, dtype), g, steps)


def as_matrices(q, t):
    """(R, t) float64 of (q, t) poses, by the reference's own conversion."""
    return ref.quat_to_matrix(q.double()), t.double()


def gaps(inp: Inputs, k: int, start, answer, steps: int, device):
    """Per pose, the translation (m) and rotation (rad) gap of ``answer``
    (R, t) to the float64 reference's solve from ``start`` (R, t)."""
    R, t = reference_answer(inp, k, start[0], start[1], steps, torch.float64, device)
    return ref.pose_gaps(answer[0].to(device), answer[1].to(device), R, t)


def numbers(inp: Inputs, k: int, dt, dr) -> dict:
    """The numbers one solve gives. A drive's first solve, from the
    odometry, moves the poses by as much as the drift (tens of metres), and
    its widest gap grows with that move in any float32 solve, so it gives the
    median pose's gaps; a warm solve gives the widest."""
    if inp.solve_index(k) == 0:
        return {"start_t_med_m": torch.median(dt).item(),
                "start_r_med_rad": torch.median(dr).item()}
    return {"pose_t_m": torch.max(dt).item(), "pose_r_rad": torch.max(dr).item()}


def compare(inp: Inputs, solves: dict, steps: int, device, limits: dict) -> tuple[dict, int]:
    """({number: worst value over ``solves``}, solves beyond a limit) of
    ``solves`` {k: (start, answer)}, each (R, t)."""
    worst: dict = {}
    failed = 0
    for k in sorted(solves):
        got = numbers(inp, k, *gaps(inp, k, *solves[k], steps, device))
        for name, v in got.items():
            w = worst.get(name, 0.0)
            worst[name] = max(w, v) if v == v and w == w else float("nan")
        failed += not all(v <= limits[name] for name, v in got.items())
    return worst, failed


def checked(n_first: int, n_done: int, count: int, seed: int) -> list[int]:
    """The solves compared: the run's first, and ``count`` drawn from the
    seed among the solves from ``n_first`` on."""
    pool = list(range(n_first, n_done))
    pick = gen.rng(seed, 9).permutation(len(pool))[:count]
    return [0] + sorted(pool[p] for p in pick)


def run(conf: dict, traffic: dict, limits: dict, seed: int, seconds: float,
        trace: bool, device: torch.device, t_start: float) -> dict:
    sync = ((lambda: torch.cuda.synchronize(device)) if device.type == "cuda"
            else (lambda: None))
    # the configuration states float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phases = {"imports_s": time.perf_counter() - t_start}
    inp = Inputs(conf, seed, device)
    sync()
    phases["graph_s"] = time.perf_counter() - t_start - sum(phases.values())
    solve = program_solver(conf, traffic, inp)
    steps = int(traffic["gn_steps"])
    n_warm = int(traffic["warm_solves"])
    answers = chain(solve, inp, 0, n_warm, None, sync)
    res: dict = {"setup_s": time.perf_counter() - t_start}
    phases["warm_s"] = res["setup_s"] - sum(phases.values())
    res["setup_phases"] = phases
    if not trace:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            answers += chain(solve, inp, len(answers), 1, answers[-1][2], sync)
        n = len(answers) - n_warm
        res["window"] = {"solves": n, "steps": n * steps,
                         "seconds": time.perf_counter() - t0}
    else:
        prof: dict = {}
        with T.profiled(sync, prof):
            answers += chain(solve, inp, n_warm, int(traffic["trace_solves"]),
                             answers[-1][2], sync)
        n = len(answers) - n_warm
        res["trace"] = T.collect(prof["prof"], prof["window_s"], n)
        res["traced_steps"] = n * steps
    res["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)

    # every answer back on the host, the program's state freed
    finite = [bool(torch.isfinite(a[0]).all() and torch.isfinite(a[1]).all())
              for _, _, a in answers]
    keep = set(checked(n_warm, len(answers), int(traffic["check_solves"]), seed))
    kept = {k: (as_matrices(*(x.cpu() for x in st)), as_matrices(*(x.cpu() for x in a)))
            for k, st, a in answers if k in keep}
    n_all = len(answers)
    del answers, solve
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    worst, failed = compare(inp, kept, steps, device, limits)
    res["reference_s"] = time.perf_counter() - t
    failed += sum(not f for k, f in enumerate(finite) if k not in kept)
    checks: dict = {}
    for name in limits:
        harness.check(checks, name, worst.get(name, float("nan")), limits)
    res.update(checks=checks, failed=failed, attempted=n_all, compared=sorted(kept))
    return res
