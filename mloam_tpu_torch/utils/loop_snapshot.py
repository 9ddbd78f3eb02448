"""Save the loop graph behind every loop that ``SlamPipeline`` verifies on a
loop course, so that another implementation of ``try_close_loop`` can be
run on the very graph the port saw.

Usage: python -m mloam_tpu_torch.utils.loop_snapshot OUT.npz [floor|drift]

Runs ``run_synthetic.run(slam=True)`` on the course (``LOOP_COURSES``,
default ``drift``) on the GPU. For each detection that verified, the npz
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

import dataclasses
import json
import sys

import numpy as np
import torch

from mloam_tpu_torch.core import se3
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.loop import posegraph as PGraph
from mloam_tpu_torch.models import run_synthetic
from mloam_tpu_torch.utils import convert

# keyframe-indexed fields of LoopGraphState (sc_db's head and the edge
# slots are kept whole)
KF_FIELDS = ("poses", "odom_poses", "corner", "surf", "valid")


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


def main(path: str, course: str = "drift"):
    cfg, n_frames, seed, kw = run_synthetic.loop_course(course)
    lc = cfg.loop
    real = PGraph.try_close_loop
    saved = []

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

    PGraph.try_close_loop = recording
    try:
        res = run_synthetic.run(n_frames=n_frames, seed=seed, verbose=False, cfg=cfg,
                                slam=True, **kw)
    finally:
        PGraph.try_close_loop = real
    kf = res["kf_gt_idx"]
    gq, gt = torch.from_numpy(res["gt_q"]), torch.from_numpy(res["gt_t"])
    out = {"capacity": np.asarray(lc.capacity), "n_loops": np.asarray(res["n_loops"]),
           "kf_gt_idx": np.asarray(kf),
           "config": np.asarray(json.dumps(dataclasses.asdict(cfg)))}
    for n, d in enumerate(saved):
        a, b = kf[int(d["cand"])], kf[int(d["query_idx"])]
        z = se3.relative(Pose(gq[a], gt[a]), Pose(gq[b], gt[b]))
        d.update(z_true_q=z.q.numpy(), z_true_t=z.t.numpy(), sweeps=np.asarray([a, b]))
        out.update({f"d{n}_{k}": v for k, v in d.items()})
    np.savez_compressed(path, **out)
    print(json.dumps({"course": course, "n_loops": res["n_loops"],
                      "verified": [[int(d["cand"]), int(d["query_idx"])] for d in saved],
                      "kf_ate_odom_m": res["kf_ate_odom_m"],
                      "kf_ate_corr_m": res["kf_ate_corr_m"], "out": path}))


if __name__ == "__main__":
    main(*sys.argv[1:])
