"""The slice as a whole: ``SlamPipeline`` (odometry + keyframe mapping +
loop closure), port vs JAX package.

Course: the JAX package's world of seed 3 (extent 30 m, 20 walls, 10
poles), the floor course of ``tests/test_slam_e2e.py`` shrunk to a 3 m
circle of 5 s (50 sweeps a lap at the same 3.8 m/s), rendered by the JAX
package at 8x360 with the small caps of ``test_torch_full_pipeline.py``;
keyframes every 0.5 m (every mapped sweep), loop-interval 1, 8 recent
keyframes excluded, no correlation seed (the pose seed, as the JAX e2e
test runs this course; the correlation seed is held by
``test_torch_posegraph.py``). On the 6 m floor course at 8x360 (and at
16x900) the JAX pipeline closes no loop in 110 sweeps; on this one it
verifies a loop at sweep 34 (keyframe 14 against keyframe 2, across the
circle). 40 sweeps run through the JAX pipeline.

The port runs the sweeps where the loop layer acts, each started from the
JAX pipeline's whole state before it (odometry, mapper, loop graph and the
in-flight keyframe flag and verification, carried across as numpy): the
first sweep that submits a detection, the sweep that submits the verified
one and the sweep that reads it. After each: the same keyframe count, the
same detection submitted (found and candidate), loop found and ``n_loops``
equal, the same loop edges, and the loop-corrected keyframe trajectory to
1 cm / 2 mrad (the pipelines' bound, ``test_torch_full_pipeline.py``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mloam_tpu.core.rangeimage import LidarModel as JModel
from mloam_tpu.core.rangeimage import RangeImage as JRangeImage
from mloam_tpu.models import platforms as jplatforms
from mloam_tpu.models.pipeline import SlamPipeline as JSlam
from mloam_tpu.sim import world as JW
from mloam_tpu_torch.core import se3 as tse3
from mloam_tpu_torch.models import pipeline as TP
from mloam_tpu_torch.utils import convert

N_FRAMES = 40


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def np_(x):
    return jax.tree.map(np.asarray, x)


def T(x):
    return torch.from_numpy(np.array(x))


def slam_cfg():
    j = jplatforms.synthetic(n_lidars=1)
    j = dataclasses.replace(
        j,
        rig=dataclasses.replace(j.rig, models=(JModel(n_rings=8, n_cols=360),)),
        features=dataclasses.replace(j.features, cap_less_flat=512),
        odometry=dataclasses.replace(
            j.odometry, window_size=4, opt_window_size=2, cap_frame_corner=128,
            cap_frame_surf=256, localmap_precap_corner=256, localmap_precap_surf=640),
        mapping=dataclasses.replace(
            j.mapping, keyframe_dist=0.5, skip_frames=2, max_keyframes=64,
            cap_map_corner=2048, cap_map_surf=4096, cap_frame_outlier=64),
        loop=dataclasses.replace(
            j.loop, skip_interval=1, num_exclude_recent=8, loop_distance_threshold=10.0,
            capacity=32, use_global_registration=False))
    return j, convert.config_from_reference(dataclasses.asdict(j))


def snapshot(jp):
    """The JAX pipeline's state, copied to numpy (its jitted steps donate
    their input buffers, so a reference would not survive the next sweep)."""
    o = jp.full.odom
    return np_(dict(
        frame_idx=o.frame_idx, window=o.window, prev_feats=list(o.prev_feats),
        motions=list(o.motions), world_pose=o.world_pose,
        mapper_state=jp.full.mapper_state, loop_state=jp.loop_state,
        kf_counter=jp.kf_counter, n_loops=jp.n_loops, loop_kf_count=jp.loop_kf_count,
        pending_loops=list(jp._pending_loops), pending_kf=jp._pending_kf,
        pending_verify=jp._pending_verify))


def load_state(tp, s):
    """Give the port's SlamPipeline a JAX snapshot (one lidar, mode 0)."""
    pose = lambda p: convert.pose_from_numpy(np_(p))  # noqa: E731
    feat = lambda f: convert.featcloud_from_numpy(np_(f))  # noqa: E731
    to = tp.full.odom
    to.frame_idx = int(s["frame_idx"])
    to.window = convert.window_state_from_numpy(np_(s["window"]))
    to.prev_feats = [None if f is None else convert.feature_frame_from_numpy(np_(f))
                     for f in s["prev_feats"]]
    to.motions = [pose(m) for m in s["motions"]]
    to.world_pose = pose(s["world_pose"])
    tp.full.mapper_state = convert.mapper_state_from_numpy(np_(s["mapper_state"]))
    tp.loop_state = convert.loop_state_from_numpy(np_(s["loop_state"]))
    tp.kf_counter, tp.n_loops = int(s["kf_counter"]), int(s["n_loops"])
    tp.loop_kf_count = int(s["loop_kf_count"])
    tp._pending_loops = [(int(qi), int(cj), T(zq), T(zt), np.asarray(c))
                         for qi, cj, zq, zt, c in s["pending_loops"]]
    tp._pending_kf = None
    if s["pending_kf"] is not None:
        flag, mp, (c, sf) = s["pending_kf"]
        tp._pending_kf = (TP._Deferred("kf_flag_event", T(flag)), pose(mp), (feat(c), feat(sf)))
    tp._pending_verify = None
    if s["pending_verify"] is not None:
        q, found, cand, zq, zt = s["pending_verify"]
        tp._pending_verify = (int(q), TP._Deferred("verify_event", T(found), T(cand)), T(zq), T(zt))


@pytest.fixture(scope="module")
def course():
    jcfg, tcfg = slam_cfg()
    w = JW.make_world(jax.random.PRNGKey(3), extent=30.0, n_walls=20, n_poles=10)
    traj = JW.make_loop_trajectory(radius=3.0, period_s=5.0)
    imgs, gt = JW.render_sequence(w, traj, jcfg.rig.models[0], N_FRAMES)
    jp = JSlam(jcfg)
    snaps, outs, after = [], [], []
    for i in range(N_FRAMES):
        snaps.append(snapshot(jp))
        outs.append(jp.process([JRangeImage(*(f[i] for f in imgs))]))
        after.append(snapshot(jp))
    return jcfg, tcfg, imgs, snaps, outs, after


def frame(imgs, i):
    return convert.range_image_from_numpy(tuple(np.asarray(f[i]) for f in imgs))


def test_the_jax_pipeline_closes_a_loop_on_this_course(course):
    *_, outs, after = course
    found = [i for i, o in enumerate(outs) if o.loop_found]
    assert found and int(after[-1]["n_loops"]) >= 1
    ls = after[found[0]]["loop_state"]
    lv = np.asarray(ls.loop_valid)
    assert (np.asarray(ls.loop_j)[lv] - np.asarray(ls.loop_i)[lv]).min() >= 8


def acting_sweeps(snaps, after):
    """The first sweep that submits a detection, the sweep that submits the
    first verified one, and the sweep that reads it."""
    submits = [i for i in range(len(snaps))
               if after[i]["pending_verify"] is not None
               and after[i]["loop_kf_count"] != snaps[i]["loop_kf_count"]]
    verified = [i for i in submits if bool(after[i]["pending_verify"][1])]
    return sorted({submits[0], verified[0], verified[0] + 1})


def test_sweeps_from_the_jax_state_agree(course):
    jcfg, tcfg, imgs, snaps, outs, after = course
    tp = TP.SlamPipeline(tcfg, device="cpu")
    sweeps = acting_sweeps(snaps, after)
    assert len(sweeps) == 3 and outs[sweeps[-1]].loop_found
    for i in sweeps:
        load_state(tp, snaps[i])
        out = tp.process([frame(imgs, i)])
        want = after[i]
        assert tp.loop_kf_count == int(want["loop_kf_count"]) == int(want["loop_state"].count)
        assert int(tp.loop_state.count) == tp.loop_kf_count
        assert out.loop_found == outs[i].loop_found
        assert out.n_loops == outs[i].n_loops == tp.n_loops
        jv = want["pending_verify"]
        assert (tp._pending_verify is None) == (jv is None)
        if jv is not None:
            found, cand = tp._pending_verify[1].get()
            assert tp._pending_verify[0] == int(jv[0])
            assert bool(found) == bool(jv[1]) and int(cand) == int(jv[2])
        ls, jls = tp.loop_state, want["loop_state"]
        lv = N(jls.loop_valid)
        np.testing.assert_array_equal(N(ls.loop_valid), lv)
        np.testing.assert_array_equal(N(ls.loop_i)[lv], N(jls.loop_i)[lv])
        np.testing.assert_array_equal(N(ls.loop_j)[lv], N(jls.loop_j)[lv])
        n = tp.loop_kf_count
        d = tse3.boxminus(tse3.Pose(ls.poses.q[:n], ls.poses.t[:n]),
                          tse3.Pose(T(jls.poses.q[:n]), T(jls.poses.t[:n])))
        assert float(d[:, :3].norm(dim=-1).max()) < 0.01       # 1 cm
        assert float(d[:, 3:].norm(dim=-1).max()) < 2e-3       # 2 mrad
    assert tp.n_loops >= 1


def test_corrected_trajectory_and_flush(course):
    """``corrected_trajectory`` drains the in-flight keyframe and
    verification first, then returns the valid prefix as numpy."""
    jcfg, tcfg, imgs, snaps, outs, after = course
    tp = TP.SlamPipeline(tcfg, device="cpu")
    load_state(tp, after[-1])
    t, q = tp.corrected_trajectory()
    assert tp._pending_kf is None and tp._pending_verify is None
    assert t.shape == (tp.loop_kf_count, 3) and q.shape == (tp.loop_kf_count, 4)
    assert np.isfinite(t).all() and np.isfinite(q).all()
    assert tp.loop_kf_count >= int(after[-1]["loop_kf_count"])


def test_run_reports_each_keyframe_at_its_mapped_sweep():
    """``run_synthetic.run(slam=True)`` on the port's own course at this
    file's small configuration: a keyframe enters the loop graph the sweep
    after the mapped sweep that inserted it (or at the end-of-run flush),
    and ``kf_gt_idx`` names that mapped sweep: the graph's pose of each
    keyframe as received is the map pose of that sweep, bit for bit."""
    from mloam_tpu_torch.models import run_synthetic

    _, tcfg = slam_cfg()
    res = run_synthetic.run(n_frames=16, seed=3, verbose=False, device="cpu", cfg=tcfg,
                            slam=True, world={"extent": 30.0, "n_walls": 20, "n_poles": 10},
                            loop={"radius": 3.0, "period_s": 5.0})
    idx = res["kf_gt_idx"]
    assert len(idx) >= 4 and all(res["mapped"][i] for i in idx)
    assert idx == sorted(set(idx))
    np.testing.assert_array_equal(res["kf_odom_t"], res["map_est_t"][idx])
    assert res["kf_corr_t"].shape == (len(idx), 3)
