"""The corridor course at full width on the CPU, the JAX package beside the
port (not a test module: a witness script, minutes per run).

    env JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/torch_corridor_witness.py \\
        free jax|port jax|port SEED [THRESHOLD [SWEEPS]]
    env JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/torch_corridor_witness.py \\
        step [FIRST [SWEEPS]]

``free PIPE RENDER SEED``: the pipeline of one package (``jax`` or ``port``)
runs free over the course of ``tests/test_degeneracy_e2e.py:55-104``
(16x1800, 20 m range, ``indoor_degenerate``, tracker skipped, companion
bursts from sweep 15) rendered by one package with range noise 0.01 m drawn
at ``SEED`` (the two packages draw differently from one seed), the remap
armed at ``THRESHOLD`` (175; 0 disarms it). ``step``: the JAX package's
course of its test (seed 1000); from sweep ``FIRST`` (0) on, each sweep
starts the port from the JAX pipeline's state, and the state each package
carries out of the sweep is compared: frozen directions, persistence count,
stored weak direction, window poses, the next motion and the
marginalization prior. ``free`` prints one JSON object per sweep, then a summary: the
largest |ex|, |ey|, |ez| against the truth and the in-tunnel sweeps engaged.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mloam_tpu.core.rangeimage import RangeImage as JRangeImage
from mloam_tpu.core.se3 import Pose as JPose
from mloam_tpu.models import platforms as jplatforms
from mloam_tpu.models.pipeline import OdometryPipeline as JPipeline
from mloam_tpu.sim import world as JW
from mloam_tpu_torch.core import se3 as tse3
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.models.pipeline import OdometryPipeline
from mloam_tpu_torch.sim import world as TW
from mloam_tpu_torch.utils import convert
from torch_corridor_case import load_state

COMP_START = 15


def configs(threshold):
    j = jplatforms.synthetic(n_lidars=1)
    model = j.rig.models[0]._replace(max_range=20.0)
    j = dataclasses.replace(j, rig=dataclasses.replace(j.rig, models=(model,)),
                            tracker=dataclasses.replace(j.tracker, skip_steady=True))
    j = jplatforms.indoor_degenerate(j)
    j = dataclasses.replace(j, odometry=dataclasses.replace(j.odometry, eig_threshold=threshold))
    return j, convert.config_from_reference(dataclasses.asdict(j))


def render(by, jcfg, tcfg, n, seed):
    """Sweeps as numpy RangeImage fields [F, ...] and the sensor's truth
    relative to its first pose [F, 3]."""
    course = dict(noise_std=0.01, noise_seed=seed, companion_frames=(COMP_START, n),
                  companion_period=(3, 10))
    if by == "jax":
        mount = JPose(jnp.array([1.0, 0, 0, 0]), jnp.array([0.0, 0.0, 1.2]))
        imgs, gt = JW.render_sequence(
            JW.make_corridor_world(wall_height=3.0, ceiling=True),
            JW.make_straight_trajectory(speed=2.0, wobble=0.02), jcfg.rig.models[0], n,
            extrinsic=mount, companions=jnp.array([[5.0, 0.8, 0.12]]), **course)
        gq, gt_t, mq, mt = (np.asarray(x) for x in (gt.q, gt.t, mount.q, mount.t))
    else:
        mount = Pose(torch.tensor([1.0, 0, 0, 0]), torch.tensor([0.0, 0.0, 1.2]))
        imgs, gt = TW.render_sequence(
            TW.make_corridor_world(wall_height=3.0, ceiling=True, device="cpu"),
            TW.make_straight_trajectory(speed=2.0, wobble=0.02, device="cpu"),
            tcfg.rig.models[0], n, device="cpu", extrinsic=mount,
            companions=torch.tensor([[5.0, 0.8, 0.12]]), **course)
        gq, gt_t, mq, mt = (x.numpy() for x in (gt.q, gt.t, mount.q, mount.t))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    sensor = tse3.compose(Pose(t(gq), t(gt_t)), Pose(t(mq).expand(n, 4), t(mt).expand(n, 3)))
    first = tse3.inverse(Pose(sensor.q[:1].expand(n, 4), sensor.t[:1].expand(n, 3)))
    return ([np.asarray(f) for f in imgs], tse3.compose(first, sensor).t.numpy())


def summary(rows):
    err = np.array([r["err"] for r in rows])
    engaged = sum(1 for r in rows[COMP_START:] if r["frozen"] > 0)
    return {"summary": {"sweeps": len(rows), "ex_max": float(np.abs(err[:, 0]).max()),
                        "ey_max": float(np.abs(err[:, 1]).max()),
                        "ez_max": float(np.abs(err[:, 2]).max()),
                        "engaged_in_tunnel": [engaged, len(rows) - COMP_START]}}


def free(pipe_by, render_by, seed, threshold=175.0, n=90):
    jcfg, tcfg = configs(threshold)
    imgs, truth = render(render_by, jcfg, tcfg, n, seed)
    pipe = JPipeline(jcfg) if pipe_by == "jax" else OdometryPipeline(tcfg, device="cpu")
    rows = []
    for i in range(n):
        fields = tuple(f[i] for f in imgs)
        o = pipe.process([JRangeImage(*(jnp.asarray(f) for f in fields))] if pipe_by == "jax"
                         else [convert.range_image_from_numpy(fields)])
        frozen = 0.0 if o.win_frozen is None else float(np.sum(np.asarray(o.win_frozen)))
        axis = -1 if o.win_weak_dir is None else int(np.argmax(np.abs(np.asarray(o.win_weak_dir))))
        rows.append({"i": i, "frozen": frozen, "weak_axis": axis,
                     "err": (np.asarray(o.pose.t) - truth[i]).round(4).tolist()})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps(summary(rows)))


def step(first=0, n=46):
    jcfg, tcfg = configs(175.0)
    imgs, _ = render("jax", jcfg, tcfg, n, 1000)
    jp, tp = JPipeline(jcfg), OdometryPipeline(tcfg, device="cpu")
    A = np.asarray
    diff = lambda a, b: float(np.abs(A(a) - b.numpy()).max())
    for i in range(n):
        fields = tuple(f[i] for f in imgs)
        if i >= first:
            load_state(tp, jp)
            to = tp.process([convert.range_image_from_numpy(fields)])
        jo = jp.process([JRangeImage(*(jnp.asarray(f) for f in fields))])
        if i < first:
            continue
        jw, tw = jp.window, tp.window
        frozen = [-1.0, -1.0] if jo.win_frozen is None else [
            float(np.sum(A(jo.win_frozen))), float(to.win_frozen.sum())]
        # the state each package carries into the next sweep
        print(json.dumps({
            "i": i, "frozen": frozen, "count": [int(jw.deg_count), int(tw.deg_count)],
            "deg_dir_diff": min(diff(jw.deg_dir, tw.deg_dir), diff(-A(jw.deg_dir), tw.deg_dir)),
            "weak_axis": int(np.argmax(np.abs(A(jw.deg_dir)))),
            "poses_t_diff_m": diff(jw.poses.t, tw.poses.t),
            "poses_q_diff": diff(jw.poses.q, tw.poses.q),
            "motion_t_diff_m": diff(jp.motions[0].t, tp.motions[0].t),
            "prior_H_diff_rel": diff(jw.prior.H, tw.prior.H) / float(np.abs(A(jw.prior.H)).max()
                                                                    or 1.0),
            "prior_b_diff": diff(jw.prior.b, tw.prior.b),
            "prior_b_max": float(np.abs(A(jw.prior.b)).max())}), flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1] == "free":
        free(sys.argv[2], sys.argv[3], int(sys.argv[4]),
             *(float(a) if k == 0 else int(a) for k, a in enumerate(sys.argv[5:7])))
    else:
        step(*(int(a) for a in sys.argv[2:4]))
