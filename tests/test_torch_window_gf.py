"""Good-feature selection in the window solve, port vs JAX package.

The window case of ``test_torch_odometry.py`` (a room corner sampled at the
frame capacities 128 / 256, window 4/2, the new frame entering 3 cm and
5 mrad off) is solved with ``gf_ratio=0.6`` and ``gf_compact`` under
``gf_method="stride"`` (the compaction alone, as ``realtime_tuned`` runs
it) and ``"gd"`` (logdet-gain selection, then compaction), the whole
``WindowState`` carried across from the JAX package. Held: the compacted
caps (host integers: 96 corner and 192 surf rows per query frame), the
kept rows (matched correspondences after compaction, within 2 of the JAX
package's as the plain window test holds them), the solved poses to 1e-4
and the cost to 1e-3 relative. The batched compaction plan equals the JAX
package's vmapped ``compact_gather_indices`` exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mloam_tpu.core import se3 as jse3
from mloam_tpu.core.rangeimage import LidarModel as JModel
from mloam_tpu.frontend.features import FeatCloud as JFeatCloud
from mloam_tpu.models import platforms as jplatforms
from mloam_tpu.odometry import estimator as JE
from mloam_tpu.ops import select as jselect
from mloam_tpu_torch.odometry import estimator as TE
from mloam_tpu_torch.ops import select as tselect
from mloam_tpu_torch.utils import convert


# one compiled program per configuration (eager JAX compiles op by op)
j_optimize = jax.jit(JE.optimize_window, static_argnums=(1,))
j_push = jax.jit(JE.push_frame, static_argnums=(4,))


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def gf_cfg(method):
    j = jplatforms.synthetic(n_lidars=1)
    j = dataclasses.replace(
        j,
        rig=dataclasses.replace(j.rig, models=(JModel(n_rings=8, n_cols=360),)),
        features=dataclasses.replace(j.features, cap_less_flat=512),
        odometry=dataclasses.replace(
            j.odometry, window_size=4, opt_window_size=2, cap_frame_corner=128,
            cap_frame_surf=256, localmap_precap_corner=256,
            localmap_precap_surf=640, gf_ratio=0.6, gf_method=method,
            gf_compact=True))
    return j, convert.config_from_reference(dataclasses.asdict(j))


def example_frame(cfg, rng, shift):
    """A room corner sampled at the frame capacities, seen from a sensor
    shifted by ``shift`` along x (the case of ``test_torch_odometry.py``)."""
    nc, ns = cfg.odometry.cap_frame_corner, cfg.odometry.cap_frame_surf
    u = rng.uniform(-4, 4, size=(ns, 2)).astype(np.float32)
    k = rng.integers(0, 3, size=ns)
    walls = np.where((k == 0)[:, None], np.stack([u[:, 0], u[:, 1], -1 + 0 * u[:, 0]], 1),
                     np.where((k == 1)[:, None], np.stack([u[:, 0], 4 + 0 * u[:, 0], u[:, 1] * 0.5], 1),
                              np.stack([4 + 0 * u[:, 0], u[:, 0], u[:, 1] * 0.5], 1)))
    t = rng.uniform(-1, 2, size=nc).astype(np.float32)
    k = rng.integers(0, 3, size=nc)
    edges = np.where((k == 0)[:, None], np.stack([4 + 0 * t, 4 + 0 * t, t], 1),
                     np.where((k == 1)[:, None], np.stack([t * 2, 4 + 0 * t, -1 + 0 * t], 1),
                              np.stack([4 + 0 * t, t * 2, -1 + 0 * t], 1)))

    def cloud(xyz):
        n = xyz.shape[0]
        xyz = xyz.astype(np.float32) - np.array([shift, 0, 0], np.float32)
        return JFeatCloud(xyz=jnp.asarray(xyz[None]), mask=jnp.asarray(rng.random((1, n)) < 0.9),
                          time=jnp.zeros((1, n)), ring=jnp.zeros((1, n), jnp.int32))

    return cloud(edges), cloud(walls)


@pytest.mark.parametrize("method", ["stride", "gd"])
def test_window_solve_with_good_feature_compaction(method):
    jcfg, tcfg = gf_cfg(method)
    rng = np.random.default_rng(0)
    jw = JE.init_window(jcfg, jcfg.odometry.cap_frame_corner, jcfg.odometry.cap_frame_surf)
    for i in range(jcfg.odometry.window_size):
        c, s = example_frame(jcfg, rng, 0.05 * i)
        jw = j_push(jw, jse3.Pose(jnp.array([1.0, 0, 0, 0]),
                                  jnp.array([0.05 * i, 0.0, 0.0])), c, s, jcfg)
    c, s = example_frame(jcfg, rng, 0.2)
    new_pose = jse3.boxplus(jse3.Pose(jnp.array([1.0, 0, 0, 0]), jnp.array([0.2, 0.0, 0.0])),
                            jnp.array([0.03, -0.02, 0.01, 0.0, 0.0, 0.005]))
    np_ = lambda x: jax.tree.map(np.asarray, x)  # noqa: E731
    tw = TE.push_frame(convert.window_state_from_numpy(np_(jw)),
                       convert.pose_from_numpy(np_(new_pose)),
                       convert.featcloud_from_numpy(np_(c)),
                       convert.featcloud_from_numpy(np_(s)), tcfg)
    jw2, jsolve = j_optimize(j_push(jw, new_pose, c, s, jcfg), jcfg)
    tw2, tsolve = TE.optimize_window(tw, tcfg)

    assert TE.gf_caps(128, 0.6) == 96 and TE.gf_caps(256, 0.6) == 192
    assert TE.gf_caps(20, 0.6) == 20 and TE.gf_caps(40, 0.1) == 32
    # kept rows: at most the caps of the two query frames, and the JAX count
    assert 20 < int(tsolve.n_corner) <= 2 * 96 and 100 < int(tsolve.n_surf) <= 2 * 192
    assert abs(int(tsolve.n_corner) - int(jsolve.n_corner)) <= 2
    assert abs(int(tsolve.n_surf) - int(jsolve.n_surf)) <= 2
    np.testing.assert_allclose(N(tw2.poses.q), N(jw2.poses.q), atol=1e-4)
    np.testing.assert_allclose(N(tw2.poses.t), N(jw2.poses.t), atol=1e-4)
    np.testing.assert_allclose(float(tsolve.cost), float(jsolve.cost), rtol=1e-3, atol=1e-6)
    sc = np.abs(N(jsolve.H)).max()
    np.testing.assert_allclose(N(tsolve.H), N(jsolve.H), atol=1e-3 * sc)
    # the solve pulled the new frame back towards where the geometry puts it
    assert float(tw2.poses.t[-1, 0]) < 0.2 + 0.03 - 0.01


def test_compaction_without_selection_keeps_fewer_rows_than_the_full_solve():
    """``stride`` compaction on the same case: the rows kept are the cap's
    share of the matched rows (the k-NN ran before it, on all of them)."""
    jcfg, tcfg = gf_cfg("stride")
    full = dataclasses.replace(tcfg, odometry=dataclasses.replace(tcfg.odometry, gf_ratio=1.0))
    rng = np.random.default_rng(1)
    w = TE.init_window(tcfg, 128, 256)
    for i in range(5):
        c, s = example_frame(jcfg, rng, 0.05 * i)
        c, s = (convert.featcloud_from_numpy(jax.tree.map(np.asarray, x)) for x in (c, s))
        w = TE.push_frame(w, convert.pose_from_numpy(
            (np.array([1.0, 0, 0, 0], np.float32), np.array([0.05 * i, 0, 0], np.float32))),
            c, s, tcfg)
    _, s_gf = TE.optimize_window(w, tcfg)
    _, s_full = TE.optimize_window(w, full)
    assert int(s_gf.n_surf) <= 2 * 192 < int(s_full.n_surf)
    assert int(s_gf.n_corner) <= int(s_full.n_corner)


@pytest.mark.parametrize("cap", [10, 32, 50])
def test_batched_compaction_plan_equals_the_vmapped_reference(cap):
    rng = np.random.default_rng(cap)
    m = rng.random((3, 50)) < 0.6
    m[1] = False
    idx, om = tselect.compact_gather_indices(torch.from_numpy(m), cap)
    jidx, jom = jax.vmap(lambda x: jselect.compact_gather_indices(x, cap))(jnp.asarray(m))
    np.testing.assert_array_equal(N(om), N(jom))
    # rows the mask keeps gather the same sources
    np.testing.assert_array_equal(N(idx)[N(om)], N(jidx)[N(jom)])


def test_window_step_builds_no_tensor_from_host_data(monkeypatch):
    """The window solve and the marginalization build their constants on the
    device: a ``torch.tensor`` from host data is a copy from pageable memory,
    which waits for the device on the GPU (the slam path's sync probe found
    the query-group indices and the prior's validity flag doing so)."""
    jcfg, tcfg = gf_cfg("stride")
    rng = np.random.default_rng(2)
    w = TE.init_window(tcfg, 128, 256)
    for i in range(5):
        c, s = (convert.featcloud_from_numpy(jax.tree.map(np.asarray, x))
                for x in example_frame(jcfg, rng, 0.05 * i))
        w = TE.push_frame(w, convert.pose_from_numpy(
            (np.array([1.0, 0, 0, 0], np.float32), np.array([0.05 * i, 0, 0], np.float32))),
            c, s, tcfg)
    calls = []
    real = torch.tensor

    def spy(*a, **kw):
        calls.append(a[0] if a else kw.get("data"))
        return real(*a, **kw)

    monkeypatch.setattr(torch, "tensor", spy)
    w2, solve = TE.optimize_window(w, tcfg)
    TE.marginalize_pivot(w2, solve, tcfg)
    assert calls == []
