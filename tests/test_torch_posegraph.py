"""Loop pose graph, port vs JAX package, on the keyframes of
``tests/torch_loop_case.py`` (rendered and featurised by the JAX package,
drifting ~60 cm over the circle), at small caps.

Held: ``add_keyframe`` state after every keyframe (poses with the drift
carried over after a correction, clouds, scan-context database, count) and
at capacity (the new keyframe dropped whole); ``record_loop`` including its
overflow; ``build_edges``; ``optimize`` poses to 1e-4; ``try_close_loop``
from the JAX ``LoopGraphState`` carried across (found, candidate, distance
to 1e-5, with and without the correlation seed) and the loop edge to 1 cm
and 1e-3 in the quaternion (~2 mrad). That edge comes from three rounds of
matching and refinement from a seed 0.54 m off: a plane fitted to collinear
neighbours has no unique normal, and the closed-form eigenvector picks one
by rounding, another way in each package (271 of 2048 plane weights differ
at the first match with the same k-NN indices), so the two refinements
stop 8 mm apart along the weakly held direction (with three more rounds
both land within 3.4 mm of the truth, 1 mm apart).
Poses are held to 1e-5 where no solve is involved.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mloam_tpu.core import se3 as jse3
from mloam_tpu.loop import posegraph as JPG
from mloam_tpu_torch.loop import posegraph as TPG
from mloam_tpu_torch.utils import convert
from torch_loop_case import N, N_KF, configs, keyframes, np_

JCFG, TCFG, JL, TL = configs()
CAP_C, CAP_S = JCFG.odometry.cap_frame_corner, JCFG.odometry.cap_frame_surf
j_add = jax.jit(JPG.add_keyframe, static_argnames=("cfg",))


def tpose(p):
    return convert.pose_from_numpy(np_(p))


def tfeat(f):
    return convert.featcloud_from_numpy(np_(f))


def same_state(t, j, atol=1e-5):
    n = N(t.valid).shape[0]
    np.testing.assert_array_equal(N(t.valid), N(j.valid))
    assert int(t.count) == int(j.count) and int(t.n_loops) == int(j.n_loops)
    for a, b in ((t.poses, j.poses), (t.odom_poses, j.odom_poses)):
        np.testing.assert_allclose(N(a.q), N(b.q), atol=atol)
        np.testing.assert_allclose(N(a.t), N(b.t), atol=atol)
    for a, b in zip(t.corner + t.surf, j.corner + j.surf):
        np.testing.assert_array_equal(N(a), N(b))
    np.testing.assert_allclose(N(t.sc_db.desc), N(j.sc_db.desc), atol=1e-5)
    np.testing.assert_array_equal(N(t.sc_db.valid), N(j.sc_db.valid))
    assert int(t.sc_db.head) == int(j.sc_db.head)
    np.testing.assert_array_equal(N(t.loop_valid), N(j.loop_valid))
    lv = N(j.loop_valid)
    for a, b in ((t.loop_i, j.loop_i), (t.loop_j, j.loop_j)):
        np.testing.assert_array_equal(N(a)[lv], N(b)[lv])
    assert n > 0


@pytest.fixture(scope="module")
def graph():
    """Both packages' graphs over the 15 keyframes, built side by side."""
    js = JPG.init_state(32, CAP_C, CAP_S, JL)
    ts = TPG.init_state(32, CAP_C, CAP_S, TL)
    for _, pose, c, s in keyframes():
        js = j_add(js, pose, c, s, cfg=JL)
        ts = TPG.add_keyframe(ts, tpose(pose), tfeat(c), tfeat(s), TL)
        same_state(ts, js)
    return js, ts


def test_add_keyframe_builds_the_same_graph(graph):
    js, ts = graph
    assert int(ts.count) == N_KF + 1


def test_add_keyframe_carries_the_drift_and_drops_at_capacity():
    kfs = keyframes()
    js = JPG.init_state(3, CAP_C, CAP_S, JL)
    ts = TPG.init_state(3, CAP_C, CAP_S, TL)
    for k in range(2):
        _, pose, c, s = kfs[k]
        js = j_add(js, pose, c, s, cfg=JL)
        ts = TPG.add_keyframe(ts, tpose(pose), tfeat(c), tfeat(s), TL)
    # a correction of keyframe 1 (as PGO leaves it): the next keyframe enters
    # with the same drift correction
    corr = jse3.exp(jnp.array([0.3, -0.2, 0.0, 0.0, 0.0, 0.05]))
    p1 = jse3.compose(corr, jse3.Pose(js.poses.q[1], js.poses.t[1]))
    js = js._replace(poses=jse3.Pose(js.poses.q.at[1].set(p1.q), js.poses.t.at[1].set(p1.t)))
    ts = convert.loop_state_from_numpy(np_(js))
    for k in range(2, 5):        # the 4th and 5th keyframes meet a full graph
        _, pose, c, s = kfs[k]
        js = j_add(js, pose, c, s, cfg=JL)
        ts = TPG.add_keyframe(ts, tpose(pose), tfeat(c), tfeat(s), TL)
        same_state(ts, js)
    assert int(ts.count) == 3
    want = jse3.compose(corr, kfs[2][1])
    np.testing.assert_allclose(N(ts.poses.t[2]), N(want.t), atol=1e-5)
    # the dropped keyframes left slot 2 as keyframe 2 wrote it
    np.testing.assert_array_equal(N(ts.surf.xyz[2]), np.asarray(kfs[2][3].xyz))


def test_record_loop_and_its_overflow():
    js = JPG.init_state(4, 8, 8, JL, max_loops=2)
    ts = TPG.init_state(4, 8, 8, TL, max_loops=2)
    zq, zt = jnp.array([1.0, 0, 0, 0]), jnp.array([0.1, 0.2, 0.3])
    for n, found in enumerate((True, False, True, True)):
        js = JPG.record_loop(js, jnp.asarray(found), jnp.asarray(n), jnp.asarray(n + 2), zq, zt + n)
        ts = TPG.record_loop(ts, found, n, n + 2, torch.from_numpy(np.asarray(zq)),
                             torch.from_numpy(np.asarray(zt + n)))
        assert int(ts.n_loops) == int(js.n_loops)
        np.testing.assert_array_equal(N(ts.loop_valid), N(js.loop_valid))
        np.testing.assert_array_equal(N(ts.loop_i), N(js.loop_i))
        np.testing.assert_array_equal(N(ts.loop_j), N(js.loop_j))
        np.testing.assert_allclose(N(ts.loop_zt), N(js.loop_zt), atol=0)
    assert int(ts.n_loops) == 2 and N(ts.loop_i).tolist() == [0, 2]


def with_loop(js):
    zq, zt = jnp.array([1.0, 0, 0, 0]), jnp.array([0.05, 0.0, 0.0])
    return JPG.record_loop(js, jnp.asarray(True), jnp.asarray(0), jnp.asarray(N_KF), zq, zt)


def test_build_edges(graph):
    js = with_loop(graph[0])
    ts = convert.loop_state_from_numpy(np_(js))
    je, te = JPG.build_edges(js), TPG.build_edges(ts)
    np.testing.assert_array_equal(N(te.i), N(je.i))
    np.testing.assert_array_equal(N(te.j), N(je.j))
    np.testing.assert_allclose(N(te.z_q), N(je.z_q), atol=1e-6)
    np.testing.assert_allclose(N(te.z_t), N(je.z_t), atol=1e-6)
    np.testing.assert_array_equal(N(te.weight), N(je.weight))


def test_optimize(graph):
    js = with_loop(graph[0])
    ts = convert.loop_state_from_numpy(np_(js))
    jo = jax.jit(JPG.optimize, static_argnames=("iters",))(js, iters=5)
    to = TPG.optimize(ts, iters=5)
    np.testing.assert_allclose(N(to.poses.t), N(jo.poses.t), atol=1e-4)
    np.testing.assert_allclose(N(to.poses.q), N(jo.poses.q), atol=1e-4)
    # invalid slots keep their poses
    np.testing.assert_array_equal(N(to.poses.t)[N_KF + 1:], N(ts.poses.t)[N_KF + 1:])


@pytest.mark.parametrize("use_global_reg", [False, True], ids=["pose_seed", "with_fft_seed"])
def test_try_close_loop_from_the_jax_state(graph, use_global_reg):
    j_try = jax.jit(JPG.try_close_loop, static_argnames=("lcfg", "cfg", "use_global_reg"))
    js = graph[0]
    ts = convert.loop_state_from_numpy(np_(js))
    for q in (N_KF, N_KF - 5):       # the revisit, and a keyframe with no loop
        jf, jc, jzq, jzt, jd, jreg = j_try(js, jnp.asarray(q), lcfg=JL, cfg=JCFG,
                                           use_global_reg=use_global_reg)
        tf, tc, tzq, tzt, td, treg = TPG.try_close_loop(ts, q, TL, TCFG,
                                                        use_global_reg=use_global_reg)
        assert bool(tf) == bool(jf) == (q == N_KF)
        assert int(tc) == int(jc)
        assert float(td) == pytest.approx(float(jd), abs=1e-5)
        assert bool(treg.ok) == bool(jreg.ok)
        if bool(jf):
            np.testing.assert_allclose(N(tzt), N(jzt), atol=0.01)
            np.testing.assert_allclose(N(tzq), N(jzq), atol=1e-3)
            # the revisit sits on keyframe 0: the edge is near identity
            assert float(torch.linalg.norm(tzt)) < 0.1


def test_try_close_loop_accepts_a_near_empty_query_in_both(graph):
    """The verification's acceptance (inlier share of the query's surf
    points, mean squared residual) is met by a query keyframe of a handful
    of points, in both packages alike: the revisit's clouds cut to 6 surf
    and 1 corner points still verify against keyframe 0 (the drift course
    on the card closes its false loops on such keyframes, PERF.md)."""
    js = graph[0]
    keep_s = np.zeros(js.surf.mask.shape, bool)
    keep_s[N_KF, np.flatnonzero(N(js.surf.mask[N_KF]))[:6]] = True
    keep_c = np.zeros(js.corner.mask.shape, bool)
    keep_c[N_KF, np.flatnonzero(N(js.corner.mask[N_KF]))[:1]] = True
    others = np.arange(js.surf.mask.shape[0]) != N_KF
    js = js._replace(
        surf=js.surf._replace(mask=jnp.asarray(N(js.surf.mask) & (keep_s | others[:, None]))),
        corner=js.corner._replace(mask=jnp.asarray(N(js.corner.mask) & (keep_c | others[:, None]))))
    ts = convert.loop_state_from_numpy(np_(js))
    j_try = jax.jit(JPG.try_close_loop, static_argnames=("lcfg", "cfg", "use_global_reg"))
    jf, jc, _, _, _, jreg = j_try(js, jnp.asarray(N_KF), lcfg=JL, cfg=JCFG, use_global_reg=False)
    tf, tc, _, _, _, treg = TPG.try_close_loop(ts, N_KF, TL, TCFG, use_global_reg=False)
    assert int(N(ts.surf.mask[N_KF]).sum()) == 6
    assert bool(tf) == bool(jf) is True and int(tc) == int(jc) == 0
    assert float(treg.inlier_frac) == float(jreg.inlier_frac) == 1.0
