"""The distributed solvers' scaling report: the collectives a GN iteration of
the nested-dissection solve runs, by fabric, and the efficiency they leave
beside one shard's measured work.

Counterpart of ``mloam_tpu/parallel/scaling_model.py``. The JAX module reads
the collectives and FLOPs from XLA's compiled HLO and applies TPU fabric
constants. Here:

  * the collectives are counted by the mesh itself (``parallel/mesh.py``):
    one GN iteration of the DD program runs on a stacked mesh with its counts
    reset, and each collective is put on a fabric by its axes: ``intra``
    when they leave out ``HOST_AXIS`` (within a node), ``inter`` when they
    include it (it crosses nodes: the counterpart of a replica group that
    crosses a host block). The bytes are those one shard contributes;
  * the compute term is not a FLOP count over a rate but the card's
    measured ms of one shard's GN work and of the separator solve
    (``models/experiments.dd_card_ms``);
  * the fabric is a ``Fabric`` the caller gives: no bandwidth or latency is
    built in. ``hgx_h100`` fills in the published per-GPU figures of an HGX
    H100 node and takes the latency the caller measured.

The efficiencies are a model from published fabric figures and measured
shard ms: no measurement across cards is made (the card's machine has one).
``make_survey_graph`` is the scaling runs' pose graph.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from mloam_tpu_torch import resolve_device
from mloam_tpu_torch.core import se3
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.parallel import dd_pgo as DD
from mloam_tpu_torch.parallel import mesh as M
from mloam_tpu_torch.parallel.sharded_pgo import PoseGraphEdges


def survey_edges(n: int, n_loops: int = 32) -> tuple[np.ndarray, np.ndarray]:
    """(i, j) int64 of the survey graph: sequential edges to the 4
    predecessors, then ``n_loops`` loop closures across the ring."""
    ei, ej = [], []
    for sk in (1, 2, 3, 4):
        ei += list(range(0, n - sk))
        ej += list(range(sk, n))
    for k in range(n_loops):
        a = (k * n) // n_loops
        ei.append(a)
        ej.append((a + n // 2) % n)
    return np.asarray(ei, np.int64), np.asarray(ej, np.int64)


def make_survey_graph(n: int, n_loops: int = 32, noise: float = 0.05,
                      seed: int = 0, device=None):
    """Reference-shaped pose graph: a survey ring (0.5 m steps, one turn)
    with sequential edges to the 4 predecessors (the reference's PGO wiring,
    ``mloam_loop/src/pose_graph.cpp:555-569``) plus ``n_loops`` long-range
    loop closures, all measured exactly. Returns (noisy poses, edges, ground
    truth); the noise is a tangent draw of ``noise`` per pose but the first,
    from a ``torch.Generator`` seeded ``seed``. Built on the CPU in the JAX
    package's order of operations, then moved to ``device``."""
    device = resolve_device(device)
    step_rel = se3.exp(torch.tensor([0.5, 0, 0, 0, 0, 2 * math.pi / n]))
    q = [torch.tensor([1.0, 0, 0, 0])]
    t = [torch.zeros(3)]
    for _ in range(n - 1):
        nxt = se3.compose(Pose(q[-1], t[-1]), step_rel)
        q.append(nxt.q)
        t.append(nxt.t)
    gt = Pose(torch.stack(q), torch.stack(t))
    ei, ej = survey_edges(n, n_loops)
    ei_a, ej_a = torch.from_numpy(ei), torch.from_numpy(ej)
    rel = se3.relative(Pose(gt.q[ei_a], gt.t[ei_a]), Pose(gt.q[ej_a], gt.t[ej_a]))
    edges = PoseGraphEdges(i=ei_a, j=ej_a, z_q=rel.q, z_t=rel.t,
                           weight=torch.ones((ei_a.shape[0], 6)))
    dn = noise * torch.randn((n, 6), generator=torch.Generator().manual_seed(seed))
    dn[0] = 0.0
    noisy = se3.boxplus(gt, dn)

    def dev(p):
        return type(p)(*(x.to(device) for x in p))

    return dev(noisy), dev(edges), dev(gt)


def survey_ba_map(gt: Pose, ba_points: int, ba_map: int, seed: int = 7) -> DD.MapShard:
    """The distributed BA's map: each pose sees ``ba_map`` candidate planes
    (anchors N(0, 5 m) in its body frame, placed by the true pose, random
    unit normals) and ``ba_points`` scan points, the first candidates'
    anchors in its body frame: on their plane at the truth. Drawn on the
    poses' device from a generator seeded ``seed``."""
    dev = gt.q.device
    g = torch.Generator(device=dev).manual_seed(seed)
    n = gt.q.shape[0]
    b = 5.0 * torch.randn((n, ba_map, 3), generator=g, device=dev)
    anc = se3.transform_points(gt, b)
    nrm = torch.randn((n, ba_map, 3), generator=g, device=dev)
    nrm = nrm / torch.linalg.norm(nrm, dim=-1, keepdim=True)
    return DD.MapShard(pts=b[:, :ba_points].contiguous(), anchors=anc, normals=nrm,
                       w=torch.ones((n, ba_points), device=dev),
                       valid=torch.ones((n, ba_map), device=dev))


def _n_hosts(mesh) -> int:
    return mesh.shape[0] if mesh.ndim == 2 else 1


def dd_layout(n_poses: int, mesh, n_loops: int = 32, ba_points: int = 0,
              ba_map: int = 0) -> dict:
    """The shape figures of the DD program on ``mesh`` for the survey graph,
    from the host alone: the partition and the one-time input bytes a shard
    holds (its edges' z_q, z_t and weight; with a BA map, the map rows of
    its interiors and owned separators), the JAX package's formula."""
    ei, ej = survey_edges(n_poses, n_loops)
    part = DD.build_partition(ei, ej, n_poses, mesh.size, n_hosts=_n_hosts(mesh))
    mi, so, em = part.int_idx.shape[1], part.own_rows.shape[1], part.e_i.shape[1]
    input_bytes = em * (4 + 3 + 6) * 4
    if ba_points > 0 and ba_map > 0:
        input_bytes += (mi + so) * (ba_points * 3 + 2 * ba_map * 3 + ba_points + ba_map) * 4
    return {"input_bytes_per_device": int(input_bytes), "n_poses": n_poses,
            "n_edges": int(ei.shape[0]),
            "mesh": {"shape": list(mesh.shape), "axes": list(mesh.axis_names)},
            "partition": {"interior_per_shard": int(mi), "intra_sep_per_host": part.si,
                          "global_sep": part.sg, "owned_sep_per_shard": int(so)},
            "ba": {"points": ba_points, "map_candidates": ba_map}}


def collectives_by_fabric(counts: dict) -> dict:
    """A mesh's counts (``Mesh.collectives``: "op:axis+axis" -> calls,
    bytes) summed by fabric: ``inter`` for the collectives over
    ``HOST_AXIS``, ``intra`` for the rest; the raw counts beside them."""
    out = {"intra": {"bytes": 0, "count": 0}, "inter": {"bytes": 0, "count": 0}}
    for key, c in counts.items():
        axes = key.split(":", 1)[1].split("+")
        fabric = out["inter" if M.HOST_AXIS in axes else "intra"]
        fabric["bytes"] += c["bytes"]
        fabric["count"] += c["calls"]
    out["by_axes"] = {k: dict(v) for k, v in counts.items()}
    return out


def measure_dd_costs(n_poses: int, mesh, n_loops: int = 32, ba_points: int = 0,
                     ba_map: int = 0, dof4: bool = False,
                     assoc_chunk: int | None = None) -> dict:
    """``dd_layout``'s figures and the collectives of ONE GN iteration of the
    DD program on the stacked ``mesh``, by fabric (``collectives_by_fabric``).
    The survey graph, and with ``ba_points`` and ``ba_map`` a BA map of that
    shape (``survey_ba_map``), are materialised on the mesh's device and the
    step runs with the mesh's counts reset."""
    out = dd_layout(n_poses, mesh, n_loops, ba_points, ba_map)
    poses, edges, gt = make_survey_graph(n_poses, n_loops=n_loops, device=mesh.device)
    ms = survey_ba_map(gt, ba_points, ba_map) if ba_points > 0 and ba_map > 0 else None
    part = DD.mesh_partition(edges, n_poses, mesh)
    mesh.reset_counts()
    DD.optimize_pose_graph_dd(poses, edges, mesh, iters=1, dof4=dof4, map_shard=ms,
                              partition=part, assoc_chunk=assoc_chunk)
    out["collectives_per_gn"] = collectives_by_fabric(mesh.collectives)
    return out


@dataclasses.dataclass(frozen=True)
class Fabric:
    """Per-GPU, per-direction bandwidth (bytes/s) within a node (``intra``)
    and between nodes (``inter``), the latency a collective pays on each (s),
    and where each figure comes from."""

    intra_bw: float
    inter_bw: float
    intra_lat_s: float
    inter_lat_s: float
    source: str


def hgx_h100(lat_s: float) -> Fabric:
    """The published per-GPU figures of an HGX H100 node, with the latency
    the caller measured on both fabrics."""
    return Fabric(
        intra_bw=450e9, inter_bw=50e9, intra_lat_s=lat_s, inter_lat_s=lat_s,
        source=("NVIDIA HGX H100 per GPU: NVLink 4, 18 links, 900 GB/s both ways "
                "= 450e9 B/s per direction within a node; one ConnectX-7 NDR "
                "InfiniBand port, 400 Gb/s = 50e9 B/s per direction between "
                f"nodes; latency {lat_s:.3e} s on both, as measured by the caller"))


def nccl_latency_floor_s(device=None, reps: int = 50) -> float:
    """Median seconds, issue to completion, of a 4-byte NCCL all-reduce on
    one rank of this process's GPU: a floor under a collective's latency, not
    a measurement of any fabric (one rank moves no byte between cards). Uses
    the default process group when one exists, else a one-rank group in an
    in-process store, destroyed after."""
    import torch.distributed as dist

    device = resolve_device(device)
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("nccl", store=dist.HashStore(), world_size=1, rank=0)
    try:
        x = torch.ones(1, device=device)
        ts = []
        for _ in range(reps + 5):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            dist.all_reduce(x)
            torch.cuda.synchronize(device)
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts[5:]))
    finally:
        if own:
            dist.destroy_process_group()


def efficiency_from_card_ms(meas: dict, shard_ms: float, sep_solve_ms: float,
                            fabric: Fabric, iters: int = 10) -> dict:
    """The arithmetic of the JAX package's ``efficiency_from_measured_ms``
    with ``fabric`` in place of its TPU constants. Communication per GN
    iteration: each fabric's bytes over its bandwidth plus its count times
    its latency. Two definitions: per GN iteration, overlap-free, (t_shard +
    t_sep) / (t_shard + t_sep + t_comm); and a full solve of ``iters``
    iterations plus the one-time input distribution (a shard's input bytes
    over the slower fabric of the mesh: between nodes when it has more than
    one host)."""
    intra = meas["collectives_per_gn"]["intra"]
    inter = meas["collectives_per_gn"]["inter"]
    t_intra = intra["bytes"] / fabric.intra_bw + intra["count"] * fabric.intra_lat_s
    t_inter = inter["bytes"] / fabric.inter_bw + inter["count"] * fabric.inter_lat_s
    t_comm = t_intra + t_inter
    t_comp = (shard_ms + sep_solve_ms) * 1e-3
    per_iter = t_comp / (t_comp + t_comm)
    shape = meas["mesh"]["shape"]
    n_hosts = shape[0] if len(shape) == 2 else 1
    setup_bw = fabric.inter_bw if n_hosts > 1 else fabric.intra_bw
    setup_bytes = meas.get("input_bytes_per_device", 0.0)
    t_setup = setup_bytes / setup_bw
    full = (iters * t_comp) / (iters * (t_comp + t_comm) + t_setup)
    return {
        "measured_shard_ms_per_gn": shard_ms,
        "measured_sep_solve_ms_per_gn": sep_solve_ms,
        "t_comm_intra_ms_per_gn": t_intra * 1e3,
        "t_comm_inter_ms_per_gn": t_inter * 1e3,
        "efficiency_per_iter_measured": per_iter,
        "efficiency_full_solve_measured": full,
        "full_solve_iters": iters,
        "setup_bytes_assumed": setup_bytes,
        "fabric": dataclasses.asdict(fabric),
    }


# the report's rows: the JAX report's, named for this card's fabrics
# (ici_8chip_ba, dcn_2host_ba, ici_8chip_pgo, dcn_2host_pgo)
REPORT_ROWS = (("intra_8gpu_ba", 1, True), ("inter_2node_ba", 2, True),
               ("intra_8gpu_pgo", 1, False), ("inter_2node_pgo", 2, False))


def dd_scaling_report(fabric: Fabric | None, card_ms: dict | None, ba_points: int = 1024,
                      ba_map: int = 4096, n_poses_chip: int = 1024,
                      n_poses_host: int = 2048, device=None) -> dict:
    """The four rows of the JAX package's report, each a ``measure_dd_costs``
    on a stacked mesh: 1024 poses on 8 shards (one node of 8 GPUs) and 2048
    on 2 x 8 (two nodes), with the BA map (``ba_points`` x ``ba_map``,
    association chunk 8) and without. ``card_ms`` ({"ba": ..., "pgo": ...},
    each with ``shard_ms_per_gn`` and ``sep_solve_ms_per_gn``, from
    ``experiments.dd_card_ms``) and ``fabric`` add each row's efficiencies
    (``efficiency_from_card_ms``); without them a row holds the shape and
    collective figures only."""
    device = resolve_device(device)
    meshes = {1: M.make_mesh(8, device=device), 2: M.make_multihost_mesh(2, 8, device=device)}
    out = {}
    for name, hosts, ba in REPORT_ROWS:
        n = n_poses_chip if hosts == 1 else n_poses_host
        shape = (ba_points, ba_map) if ba else (0, 0)
        meas = measure_dd_costs(n, meshes[hosts], ba_points=shape[0], ba_map=shape[1],
                                assoc_chunk=8 if ba else None)
        kind = "ba" if ba else "pgo"
        if fabric is not None and card_ms is not None and kind in card_ms:
            meas.update(efficiency_from_card_ms(meas, card_ms[kind]["shard_ms_per_gn"],
                                                card_ms[kind]["sep_solve_ms_per_gn"], fabric))
        out[name] = meas
    return out
