"""Shared case of ``test_torch_mapper.py`` and ``test_torch_mapper_modes.py``
(not a test module): a small structured world, a drifting odometry, and a
step-by-step comparison of the port's ``mapper_step`` with the JAX
package's, each step started on both sides from the same JAX state carried
across with ``utils/convert.mapper_state_from_numpy``.

World: a ground plane, two side walls, cross walls every 6 m and a pole
every 3 m. Each step samples 256 surface and 128 pole points near the true
pose into the base frame (5 mm noise); the odometry pose handed to the mapper drifts from the truth.
Caps are small (ring of 8, maps of 1024 / 2048, surround precaps below the
stacked clouds so the compaction runs).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mloam_tpu.core.se3 import Pose as JPose
from mloam_tpu.frontend.features import FeatCloud as JFeat
from mloam_tpu.mapping import mapper as JMP
from mloam_tpu.models import platforms as jplatforms
from mloam_tpu_torch.core import se3 as tse3
from mloam_tpu_torch.mapping import mapper as TMP
from mloam_tpu_torch.utils import convert

NC, NS, NO = 128, 256, 32
POLES = np.array([[3.0 * i, 3.0 if i % 2 else -3.0] for i in range(16)], np.float32)


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def configs(**mapping):
    j = jplatforms.synthetic(n_lidars=1)
    j = dataclasses.replace(
        j,
        odometry=dataclasses.replace(j.odometry, cap_frame_corner=NC, cap_frame_surf=NS),
        mapping=dataclasses.replace(
            j.mapping, max_keyframes=8, cap_map_corner=1024, cap_map_surf=2048,
            cap_frame_outlier=NO, surround_precap_corner=512,
            surround_precap_surf=1536, **mapping))
    return j, convert.config_from_reference(dataclasses.asdict(j))


def _yaw_q(a):
    return np.array([np.cos(a / 2), 0, 0, np.sin(a / 2)], np.float32)


def _rot(q):
    w, x, y, z = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]],
                    np.float32)


def _world_points(rng, center, n, kind):
    if kind == "surf":
        # ground disc, two side walls and the cross walls x = 6k nearest by
        k = rng.choice(4, n, p=[0.45, 0.15, 0.15, 0.25])
        r = np.sqrt(rng.random(n)) * 5.0
        a = rng.random(n) * 2 * np.pi
        pts = np.stack([center[0] + r * np.cos(a), center[1] + r * np.sin(a),
                        np.full(n, -1.5)], 1)
        side = (k == 1) | (k == 2)
        pts[side, 0] = center[0] + rng.uniform(-6, 6, side.sum())
        pts[side, 1] = np.where(k[side] == 1, 5.0, -5.0)
        pts[side, 2] = rng.uniform(-1.5, 2.0, side.sum())
        cross = k == 3
        x0 = 6.0 * np.floor(center[0] / 6.0)
        pts[cross, 0] = x0 + 6.0 * rng.integers(0, 2, cross.sum())
        pts[cross, 1] = rng.uniform(-4.5, 4.5, cross.sum())
        pts[cross, 2] = rng.uniform(-1.5, 2.0, cross.sum())
        return pts.astype(np.float32)
    near = POLES[np.linalg.norm(POLES - center[:2], axis=1) < 8.0]
    p = near[rng.integers(0, len(near), n)]
    return np.concatenate([p, rng.uniform(-1.5, 2.5, (n, 1))], 1).astype(np.float32)


def sequence(n_steps, seed=0):
    """[(odom (q, t), true (q, t), corner, surf, outlier)] with clouds as
    numpy FeatCloud tuples in the base frame."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_steps):
        yaw = 0.03 * np.sin(0.4 * i)
        t = np.array([0.45 * i + 1.0, 0.2 * np.sin(0.3 * i), 0.0], np.float32)
        q = _yaw_q(yaw)
        R = _rot(q)
        clouds = []
        for kind, n in (("corner", NC), ("surf", NS), ("surf", NO)):
            w = _world_points(rng, t, n, kind)
            b = (w - t) @ R + rng.normal(scale=0.005, size=w.shape).astype(np.float32)
            mask = rng.random(n) < 0.9
            clouds.append((np.where(mask[:, None], b, 0).astype(np.float32), mask,
                           rng.random(n).astype(np.float32),
                           rng.integers(0, 16, n).astype(np.int32)))
        drift = np.array([0.004 * i, -0.002 * i, 0.0], np.float32)
        oq = _yaw_q(yaw + 0.0015 * i)
        out.append(((oq, t + drift), (q, t), *clouds))
    return out


@functools.lru_cache(maxsize=None)
def _jax_step(jcfg):
    return jax.jit(functools.partial(JMP.mapper_step, cfg=jcfg))


def _jfeat(c):
    return JFeat(*map(jnp.asarray, c))


def jax_stale(js, center, jcfg):
    c = js.cache
    moved = float(np.sum((np.asarray(center) - np.asarray(c.center)) ** 2)) \
        > jcfg.mapping.surround_rebuild_dist ** 2
    return (not bool(c.valid)) or int(c.head) != int(js.db.head) or moved


def _close(a, b, atol, what):
    a, b = N(a), np.asarray(b)
    assert a.shape == b.shape, what
    err = float(np.abs(a - b).max()) if a.size else 0.0
    assert err <= atol, f"{what}: max abs diff {err} > {atol}"


def compare_steps(jcfg, tcfg, seq, jstate=None):
    """Run every step of ``seq`` on both sides from the JAX state; hold pose
    (1e-4 m / 1e-4 rad), covariance (1e-3 of its largest entry), the
    insertion and staleness decisions and the whole keyframe ring. Returns
    the per-step records and the final JAX state.

    One exception to the pose bound, counted in the records: once the
    Levenberg-Marquardt loop has converged, every step is rejected and the
    damping grows until a step along the gradient's f32 summation noise is
    accepted at a cost lower in its last digits. The two sides sum in
    different orders, so that last step differs: observed once in the 22
    default steps, 0.29 mm along the weakest direction, final costs
    0.1476230 (JAX) and 0.1476218 (port), and once in the ten ``gd_float``
    steps, 0.11 mm with costs 1.6e-4 apart. Such a step is held to 1e-3 m /
    1e-3 rad and to the JAX cost within 1e-3 of it."""
    step = _jax_step(jcfg)
    js = JMP.init_state(jcfg) if jstate is None else jstate
    recs = []
    for (oq, ot), _true, corner, surf, outlier in seq:
        ts = convert.mapper_state_from_numpy(jax.tree.map(np.asarray, js))
        tpose = tse3.Pose(torch.from_numpy(oq), torch.from_numpy(ot))
        jpred_t = np.asarray(JMP.se3.compose(js.pose_map_odom,
                                             JPose(jnp.asarray(oq), jnp.asarray(ot))).t)
        want_stale = jax_stale(js, jpred_t, jcfg)
        js_new, jo = step(js, JPose(jnp.asarray(oq), jnp.asarray(ot)), _jfeat(corner),
                          _jfeat(surf), outlier=_jfeat(outlier))
        ts_new, to = TMP.mapper_step(
            ts, tpose, convert.featcloud_from_numpy(corner),
            convert.featcloud_from_numpy(surf), tcfg,
            outlier=convert.featcloud_from_numpy(outlier))
        i = len(recs)
        d = tse3.boxminus(to.pose, tse3.Pose(torch.tensor(np.asarray(jo.pose.q)),
                                             torch.tensor(np.asarray(jo.pose.t))))
        dt, dr = float(d[:3].norm()), float(d[3:].norm())
        jcost = float(jo.cost)
        noise_step = not (dt < 1e-4 and dr < 1e-4)
        if noise_step:
            # see compare_steps: a step taken from a converged pose along the
            # f32 noise of the gradient; both sides end at the same cost
            assert dt < 1e-3 and dr < 1e-3, f"step {i}: pose differs by {N(d)}"
            assert abs(float(to.cost) - jcost) <= 1e-3 * jcost, \
                f"step {i}: pose differs by {N(d)}, cost {float(to.cost)} vs {jcost}"
        jcov = np.asarray(jo.cov)
        _close(to.cov, jcov, 1e-3 * np.abs(jcov).max(), f"step {i}: cov")
        assert bool(to.inserted_kf) == bool(jo.inserted_kf), f"step {i}: insertion"
        assert to.stale == want_stale, f"step {i}: stale"
        assert int(to.n_corner) == int(jo.n_corner) and int(to.n_surf) == int(jo.n_surf), \
            f"step {i}: match counts {int(to.n_corner)}/{int(to.n_surf)} vs " \
            f"{int(jo.n_corner)}/{int(jo.n_surf)}"
        _close(to.frozen, jo.frozen, 1e-6, f"step {i}: frozen")
        # the ring after the step, slot by slot
        jdb, tdb = js_new.db, ts_new.db
        np.testing.assert_array_equal(N(tdb.valid), np.asarray(jdb.valid))
        assert int(tdb.head) == int(jdb.head)
        tol = 1e-3 if noise_step else 1e-4
        _close(tdb.poses.t, jdb.poses.t, tol, f"step {i}: ring t")
        _close(tdb.poses.q, jdb.poses.q, tol, f"step {i}: ring q")
        jc = np.asarray(jdb.cov)
        _close(tdb.cov, jc, 1e-3 * max(np.abs(jc).max(), 1e-12), f"step {i}: ring cov")
        for name in ("corner", "surf", "outlier"):
            for a, b in zip(getattr(tdb, name), getattr(jdb, name)):
                np.testing.assert_array_equal(N(a), np.asarray(b))
        _close(ts_new.pose_map_odom.t, js_new.pose_map_odom.t, tol, f"step {i}: drift")
        assert ts_new.step == int(js_new.step)
        _close(ts_new.deg_dir.abs(), np.abs(np.asarray(js_new.deg_dir)), 1e-3,
               f"step {i}: deg_dir")
        assert int(ts_new.deg_count) == int(js_new.deg_count), f"step {i}: deg_count"
        recs.append({"noise_step": noise_step, "stale": to.stale, "inserted": bool(to.inserted_kf),
                     "mapped": i > 0 or int(js.step) > 0, "head": int(tdb.head),
                     "n_corner": int(to.n_corner), "n_surf": int(to.n_surf),
                     "frozen": float(to.frozen), "deg_count": int(ts_new.deg_count)})
        js = js_new
    return recs, js
