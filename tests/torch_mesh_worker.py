"""One rank of a process mesh, and the case both mesh forms run.

    python tests/torch_mesh_worker.py RANK WORLD DIR HOSTS CHIPS

joins a gloo group of WORLD ranks (``file://DIR/pg``, 60 s timeout on the
join and on every collective), builds a HOSTS x CHIPS ``ProcessMesh`` on the
CPU, runs ``run_case`` on the graph in ``DIR/case.npz`` and writes its
results to ``DIR/rank<RANK>.npz``. ``tests/test_torch_mesh.py`` starts the
ranks and runs ``run_case`` on a stacked mesh of the same shape in its own
process. Not a test module: it imports torch and the port only.
"""

from __future__ import annotations

import datetime
import os
import sys

import numpy as np
import torch

from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.parallel import dd_pgo as DD
from mloam_tpu_torch.parallel import mesh as M
from mloam_tpu_torch.parallel import sharded_pgo as PG

TIMEOUT_S = 60


def load_case(path):
    z = np.load(path)
    poses = Pose(torch.from_numpy(z["q"]), torch.from_numpy(z["t"]))
    edges = PG.PoseGraphEdges(torch.from_numpy(z["i"]), torch.from_numpy(z["j"]),
                              torch.from_numpy(z["zq"]), torch.from_numpy(z["zt"]),
                              torch.from_numpy(z["w"]))
    return poses, edges


def run_case(mesh, poses, edges) -> dict:
    """3 DD steps, 2 dense and 2 PCG mesh PGO steps, and the collectives on
    a [P, 6] ramp: every replicated output, and this process's first
    shard's reduction over the chip axis."""
    out = {}
    p, cost = DD.optimize_pose_graph_dd(poses, edges, mesh, iters=3)
    out["dd_t"], out["dd_q"], out["dd_cost"] = p.t, p.q, cost
    for solver in ("dense", "cg"):
        p = PG.optimize_pose_graph(poses, edges, iters=2, mesh=mesh, solver=solver,
                                   cg_iters=20)
        out[f"{solver}_t"], out[f"{solver}_q"] = p.t, p.q
    axes = M.data_axes(mesh)
    ramp = mesh.shard(torch.arange(mesh.size * 6, dtype=torch.float32).reshape(mesh.size, 6))
    out["gather"] = mesh.replicated(mesh.all_gather(ramp, axes))
    out["psum_all"] = mesh.replicated(mesh.psum(ramp, axes))
    first = (0,) * mesh.ndim
    out["psum_chip"] = mesh.psum(ramp, axes[-1])[first]
    out["pmax_chip"] = mesh.pmax(ramp, axes[-1])[first]
    out["index_sum"] = mesh.replicated(mesh.index_sum(
        ramp * 0.1, torch.zeros(ramp.shape[:-1], dtype=torch.int64), 2, axes))
    return {k: v.detach().numpy() for k, v in out.items()}


def main():
    rank, world, d, hosts, chips = sys.argv[1:6]
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{os.path.join(d, 'pg')}",
                            world_size=int(world), rank=int(rank),
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        mesh = M.make_process_mesh((int(hosts), int(chips)), (M.HOST_AXIS, M.FACTOR_AXIS),
                                   device="cpu", timeout_s=TIMEOUT_S)
        res = run_case(mesh, *load_case(os.path.join(d, "case.npz")))
        res["coords"] = np.asarray(mesh.coords)
        np.savez(os.path.join(d, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
