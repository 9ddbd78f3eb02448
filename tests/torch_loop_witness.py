"""The JAX package's ``try_close_loop`` on the loop graphs that the port
verified a loop on, as ``mloam_tpu_torch.utils.loop_snapshot`` saved them
from a run on the card (not a test module).

Usage: env JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_loop_witness.py SNAPSHOT.npz

Each saved graph is padded back to its capacity exactly as
``posegraph.init_state`` leaves free slots, and goes through the JAX
package's ``try_close_loop`` (jitted, as its ``SlamPipeline`` runs it) and
the port's, both on the CPU, with the run's configuration. One JSON line a
detection: for the port on the GPU (as saved), the port on the CPU and the
JAX package, whether the loop verified, the candidate, the registration's
cost and inlier share, and the loop edge's error against the truth.
"""

from __future__ import annotations

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mloam_tpu import config as JC
from mloam_tpu.core import se3 as jse3
from mloam_tpu.core.rangeimage import LidarModel as JModel
from mloam_tpu.frontend.features import FeatCloud as JFeatCloud
from mloam_tpu.loop import posegraph as JPG
from mloam_tpu.loop.scancontext import ScanContextDB as JScanContextDB
from mloam_tpu_torch.core import se3
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.loop import posegraph as TPG
from mloam_tpu_torch.utils import convert
from mloam_tpu_torch.utils.loop_snapshot import KF_FIELDS


def _tuples(x):
    """JSON's lists back to the configuration's tuples (hashable, as jit's
    static arguments must be)."""
    if isinstance(x, dict):
        return {k: _tuples(v) for k, v in x.items()}
    if isinstance(x, list):
        return tuple(_tuples(v) for v in x)
    return x


def configs(d: dict):
    """(JAX MloamConfig, port MloamConfig) from the run's configuration."""
    d = _tuples(d)
    sub = {"segmenter": JC.SegmenterConfig, "features": JC.FeatureConfig,
           "tracker": JC.TrackerConfig, "odometry": JC.OdometryConfig,
           "calib": JC.CalibConfig, "mapping": JC.MappingConfig, "loop": JC.LoopConfig}

    def build(cls, vals):
        return cls(**{f.name: vals[f.name] for f in dataclasses.fields(cls) if f.name in vals})

    rig = d["rig"]
    jcfg = JC.MloamConfig(
        rig=JC.LidarRig(models=tuple(JModel(*m) for m in rig["models"]),
                        extrinsic_mode=rig["extrinsic_mode"]),
        **{k: build(cls, d[k]) for k, cls in sub.items()})
    tcfg = convert.config_from_reference(d)
    if convert.config_from_reference(dataclasses.asdict(jcfg)) != tcfg:
        raise SystemExit("the JAX configuration does not carry the run's")
    return jcfg, tcfg


def padded_state(z, prefix: str, capacity: int, tcfg):
    """The saved graph in free slots of a ``capacity``-slot graph, as numpy
    in the port's containers."""
    lc, oc = tcfg.loop, tcfg.odometry
    L = tcfg.rig.n_lidars
    st = convert.to_numpy(TPG.init_state(capacity, L * oc.cap_frame_corner,
                                         L * oc.cap_frame_surf, lc))

    def fill(path, x, kf):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(fill(f"{path}.{f}", v, kf or f in KF_FIELDS
                                  or path.endswith("sc_db") and f != "head")
                             for f, v in zip(x._fields, x)))
        saved = z[f"{prefix}{path}"]
        if not kf:
            return saved
        x = x.copy()
        x[:saved.shape[0]] = saved
        return x

    return fill("state", st, False)


def to_jax(st):
    def pose(p):
        return jse3.Pose(jnp.asarray(p.q), jnp.asarray(p.t))

    return JPG.LoopGraphState(
        pose(st.poses), pose(st.odom_poses), JFeatCloud(*map(jnp.asarray, st.corner)),
        JFeatCloud(*map(jnp.asarray, st.surf)), JScanContextDB(*map(jnp.asarray, st.sc_db)),
        *map(jnp.asarray, st[5:]))


def edge_error(zq, zt, z_true_q, z_true_t) -> dict:
    e = se3.boxminus(Pose(torch.tensor(np.array(zq)), torch.tensor(np.array(zt))),
                     Pose(torch.as_tensor(z_true_q), torch.as_tensor(z_true_t)))
    return {"trans_err_m": float(e[:3].norm()), "rot_err_rad": float(e[3:].norm())}


def main(path: str):
    z = np.load(path)
    capacity = int(z["capacity"])
    jcfg, tcfg = configs(json.loads(str(z["config"])))
    j_try = jax.jit(JPG.try_close_loop, static_argnames=("lcfg", "cfg", "use_global_reg"))
    reg = tcfg.loop.use_global_registration
    n = 0
    while f"d{n}_query_idx" in z:
        p = f"d{n}_"
        q = int(z[p + "query_idx"])
        truth = (z[p + "z_true_q"], z[p + "z_true_t"])
        st = padded_state(z, p, capacity, tcfg)
        jf, jc, jzq, jzt, jd, jreg = j_try(to_jax(st), jnp.asarray(q), lcfg=jcfg.loop,
                                           cfg=jcfg, use_global_reg=reg)
        tf, tc, tzq, tzt, td, treg = TPG.try_close_loop(convert.loop_state_from_numpy(st),
                                                        q, tcfg.loop, tcfg, use_global_reg=reg)
        row = {"detection": n, "query": q, "sweeps": z[p + "sweeps"].tolist(),
               "truth_dist_m": float(np.linalg.norm(truth[1]))}
        for who, (f, c, zq, zt, cost, frac) in {
                "port_gpu": (True, z[p + "cand"], z[p + "zq"], z[p + "zt"],
                             z[p + "cost"], z[p + "inlier_frac"]),
                "port_cpu": (tf, tc, tzq, tzt, treg.cost, treg.inlier_frac),
                "jax_cpu": (jf, jc, jzq, jzt, jreg.cost, jreg.inlier_frac)}.items():
            row[who] = {"found": bool(f), "cand": int(c), "cost": float(cost),
                        "inlier_frac": float(frac), **edge_error(zq, zt, *truth)}
        print(json.dumps(row), flush=True)
        n += 1
    print(json.dumps({"detections": n, "n_loops": int(z["n_loops"])}))


if __name__ == "__main__":
    main(sys.argv[1])
