"""Save the loop graph behind every loop that ``SlamPipeline`` verifies on a
loop course, so that another implementation of ``try_close_loop`` can be
run on the very graph the port saw.

Usage: python -m mloam_tpu_torch.utils.loop_snapshot OUT.npz [COURSE] [--sweeps N] [--false-only]

Runs ``run_synthetic.run(slam=True)`` on the course (``LOOP_COURSES``,
default ``drift``; ``--sweeps`` overrides its length) on the GPU and prints
one JSON line a verified loop (its edge against the truth of its two
keyframes' sweeps) and the keyframe ATE of the pose graph optimized again
over the odometry and only the loop edges within ``FALSE_EDGE_M`` of the
truth. For each detection that verified (``--false-only``: each whose edge
is further off than that, which keeps a long course's file small), the npz
holds, under the prefix ``d<n>_``: the ``LoopGraphState`` as
``try_close_loop`` received it (the keyframe-indexed arrays cut to the
filled slots and the local map's reach beyond them, ``capacity`` keeping
the full size), the query index, the port's result (candidate, edge
T_cand⁻¹ T_query, scan-context distance, registration cost, inlier share)
and the true relative pose of the two keyframes' sweeps. ``config`` is the
run's ``MloamConfig`` as JSON. The JAX package's side is
``tests/torch_loop_witness.py``, on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from mloam_tpu_torch.core import se3
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.loop import posegraph as PGraph
from mloam_tpu_torch.models import run_synthetic
from mloam_tpu_torch.utils import convert, evaluation

# keyframe-indexed fields of LoopGraphState (sc_db's head and the edge
# slots are kept whole)
KF_FIELDS = ("poses", "odom_poses", "corner", "surf", "valid")

# a verified loop whose edge is further than this from the truth is false
FALSE_EDGE_M = 0.5


def _flat(prefix: str, x, out: dict):
    """Numpy leaves of a nest of named tuples, keyed by their dotted path."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        for f, v in zip(x._fields, x):
            _flat(f"{prefix}.{f}", v, out)
    else:
        out[prefix] = np.asarray(x)


def snapshot(state: PGraph.LoopGraphState, keep: int) -> dict:
    """The state's leaves as numpy, its keyframe axis cut to ``keep``."""
    def cut(x):
        return type(x)(*(a[:keep] for a in x)) if isinstance(x, tuple) else x[:keep]

    st = convert.to_numpy(state)
    db = st.sc_db
    st = st._replace(sc_db=db._replace(desc=db.desc[:keep], ring_key=db.ring_key[:keep],
                                       valid=db.valid[:keep]),
                     **{f: cut(getattr(st, f)) for f in KF_FIELDS})
    out = {}
    _flat("state", st, out)
    return out


def main(path: str, course: str = "drift", n_frames: int | None = None,
         false_only: bool = False):
    cfg, frames, seed, kw = run_synthetic.loop_course(course)
    n_frames = n_frames or frames
    lc = cfg.loop
    real = PGraph.try_close_loop
    saved, pipes = [], []

    def recording(state, query_idx, lcfg, mcfg, use_global_reg=False):
        res = real(state, query_idx, lcfg, mcfg, use_global_reg=use_global_reg)
        found, cand, zq, zt, dist, reg = res
        if bool(found):      # a host read: this script is a diagnostic
            keep = min(int(state.count) + min(lc.history_search_num, 3) + 1,
                       state.valid.shape[0])
            d = snapshot(state, keep)
            d.update(query_idx=np.asarray(query_idx), cand=convert.to_numpy(cand),
                     zq=convert.to_numpy(zq), zt=convert.to_numpy(zt),
                     sc_dist=convert.to_numpy(dist), cost=convert.to_numpy(reg.cost),
                     inlier_frac=convert.to_numpy(reg.inlier_frac))
            saved.append(d)
        return res

    def last_pipe(i, out, pipe):
        pipes[:] = [pipe]

    PGraph.try_close_loop = recording
    try:
        res = run_synthetic.run(n_frames=n_frames, seed=seed, verbose=False, cfg=cfg,
                                slam=True, on_sweep=last_pipe, **kw)
    finally:
        PGraph.try_close_loop = real
    kf = res["kf_gt_idx"]
    gq, gt = torch.from_numpy(res["gt_q"]), torch.from_numpy(res["gt_t"])
    out = {"capacity": np.asarray(lc.capacity), "n_loops": np.asarray(res["n_loops"]),
           "kf_gt_idx": np.asarray(kf),
           "config": np.asarray(json.dumps(dataclasses.asdict(cfg)))}
    false_edges, n_out = set(), 0
    for d in saved:
        q_idx, cand = int(d["query_idx"]), int(d["cand"])
        a, b = kf[cand], kf[q_idx]
        z = se3.relative(Pose(gq[a], gt[a]), Pose(gq[b], gt[b]))
        err = se3.boxminus(Pose(torch.from_numpy(d["zq"]), torch.from_numpy(d["zt"])), z)
        row = {"edge": [cand, q_idx], "sweeps": [int(a), int(b)],
               "trans_err_m": float(err[:3].norm()), "rot_err_rad": float(err[3:].norm()),
               "truth_dist_m": float(z.t.norm()), "inlier_frac": float(d["inlier_frac"]),
               "cost": float(d["cost"]), "sc_dist": float(d["sc_dist"])}
        print(json.dumps(row))
        false = row["trans_err_m"] > FALSE_EDGE_M
        if false:
            false_edges.add((cand, q_idx))
        if false or not false_only:
            d.update(z_true_q=z.q.numpy(), z_true_t=z.t.numpy(), sweeps=np.asarray([a, b]))
            out.update({f"d{n_out}_{k}": v for k, v in d.items()})
            n_out += 1
    np.savez_compressed(path, **out)
    # the pose graph from the odometry poses again, without the false edges
    ls = pipes[0].loop_state
    keep_edge = torch.tensor([bool(v) and (int(i), int(j)) not in false_edges for i, j, v in
                              zip(ls.loop_i.tolist(), ls.loop_j.tolist(),
                                  ls.loop_valid.tolist())], device=ls.loop_valid.device)
    st = PGraph.optimize(ls._replace(loop_valid=keep_edge, poses=ls.odom_poses),
                         iters=lc.pgo_gn_iters, dof4=lc.dof4)
    n = len(kf)
    print(json.dumps({"course": course, "sweeps": n_frames, "n_loops": res["n_loops"],
                      "verified": [[int(d["cand"]), int(d["query_idx"])] for d in saved],
                      "false_loops": sorted(false_edges),
                      "kf_ate_odom_m": res["kf_ate_odom_m"],
                      "kf_ate_corr_m": res["kf_ate_corr_m"],
                      "kf_ate_corr_true_edges_m": evaluation.ate_rmse(
                          st.poses.t[:n].cpu().numpy(), res["gt_t"][np.asarray(kf)]),
                      "saved": n_out, "out": path}))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("course", nargs="?", default="drift", choices=sorted(run_synthetic.LOOP_COURSES))
    ap.add_argument("--sweeps", type=int, default=None)
    ap.add_argument("--false-only", action="store_true")
    a = ap.parse_args()
    main(a.out, a.course, a.sweeps, a.false_only)
