"""Priorless global registration, port vs JAX package.

Inputs: the first keyframe's surf cloud rendered and featurised by the JAX
package (``tests/torch_loop_case.py``) and the same cloud moved by a known
yaw and shift, and a seeded random cloud for the features.

Held: ``occupancy_grid`` to 1e-6; ``register_correlation`` with the chosen
yaw and shift exactly (the case has no tie: the best score is checked to
stand clear of the second), z and the score to 1e-4; ``estimate_normals``
to 1e-4 up to sign; ``fpfh`` to 1e-4 and ``register_global`` scored on the
JAX package's own triplet draw (``jax.random.choice``, recomputed outside
it with its key): correspondence count equal, pose to 1e-3, ``ok`` equal.
For these two the JAX package's own k-NN runs, with one repair: its
expanded form ``|q|² + |r|² - 2 q·r`` leaves a point's distance to itself
at f32 rounding noise, above the 1e-8 that excludes the self-pair, so the
JAX package counts some points as their own neighbour where the port's
exact 0 does not (a deviation listed in ROADMAP Queue C). The wrapper
``self_pair_exact`` sets exactly that distance, of a point to itself in a
cloud searched against itself, to 0 and leaves every other distance and
every index as the JAX package returns them. ``register_global``'s
feature-space search (k = 2, 33-D FPFH of |f|² = 12) is handed the exact
distances: the destination is a rigid copy of the source, so most
features have a twin within 1e-13 and the expanded form's rounding (a few
1e-6) decides their ratio test (2 of 892 rows). That search itself is held
against the JAX package's own: distances to 1e-5, indices equal wherever
the neighbours stand 2e-5 apart. The port's own draw
(``torch.multinomial``) is held to its distribution: valid correspondences
only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mloam_tpu.core import rotations as jrot
from mloam_tpu.loop import global_registration as JG
from mloam_tpu.ops import knn as jknn
from mloam_tpu_torch.loop import global_registration as TG
from mloam_tpu_torch.ops.knn import knn_plain
from torch_loop_case import N, keyframes

YAW_IDX, SHIFT = 7, (2.0, -1.5)       # 35 degrees, metres


def T(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def clouds():
    _, _, corner, surf = keyframes()[0]
    src = np.asarray(surf.xyz)
    mask = np.asarray(surf.mask)
    yaw = YAW_IDX * 2 * np.pi / 72
    R = np.asarray(jrot.quat_to_matrix(jrot.so3_exp_quat(jnp.array([0.0, 0.0, yaw]))))
    dst = (src @ R.T + np.array([SHIFT[0], SHIFT[1], 0.0])).astype(np.float32)
    return src, mask, dst


def test_occupancy_grid(clouds):
    src, mask, _ = clouds
    j = JG.occupancy_grid(jnp.asarray(src), jnp.asarray(mask), 40.0, 0.5)
    t = TG.occupancy_grid(T(src), T(mask), 40.0, 0.5)
    assert t.shape == (160, 160)
    np.testing.assert_allclose(N(t), N(j), rtol=0, atol=1e-6)
    # a batch of images is the images one by one
    tb = TG.occupancy_grid(torch.stack([T(src), T(src) + 1.0]), T(mask)[None].expand(2, -1),
                           40.0, 0.5)
    np.testing.assert_allclose(N(tb[0]), N(t), atol=0)


def test_register_correlation(clouds):
    src, mask, dst = clouds
    j = jax.jit(JG.register_correlation)(jnp.asarray(src), jnp.asarray(mask),
                                         jnp.asarray(dst), jnp.asarray(mask))
    t = TG.register_correlation(T(src), T(mask), T(dst), T(mask))
    np.testing.assert_array_equal(N(t.pose.q), N(j.pose.q))
    np.testing.assert_array_equal(N(t.pose.t)[:2], N(j.pose.t)[:2])
    np.testing.assert_allclose(N(t.pose.t)[2], N(j.pose.t)[2], atol=1e-4)
    assert float(t.inlier_frac) == pytest.approx(float(j.inlier_frac), rel=1e-4)
    assert bool(t.ok) == bool(j.ok) is True
    # the known motion: yaw index 7, shift (2.0, -1.5) in 0.5 m cells
    yaw = 2 * np.arctan2(float(t.pose.q[3]), float(t.pose.q[0]))
    assert yaw == pytest.approx(YAW_IDX * 2 * np.pi / 72, abs=1e-5)
    np.testing.assert_allclose(N(t.pose.t)[:2], SHIFT, atol=1e-6)


def test_register_correlation_has_no_tie(clouds):
    """The case is tie-free: the best yaw's score stands clear of the next,
    and within the best yaw's surface the peak is unique."""
    src, mask, dst = clouds
    m_src, m_dst = T(mask) & (T(src)[:, 2] > 0), T(mask) & (T(dst)[:, 2] > 0)
    snrs, idxs, corr = TG._yaw_scores(T(src), m_src, T(dst), m_dst, 72, 40.0, 0.5)
    top2 = torch.topk(snrs, 2).values
    assert float(top2[0] - top2[1]) > 1e-3 * float(top2[0])
    best = int(torch.argmax(snrs))
    assert best == YAW_IDX
    assert int((corr[best] == corr[best].max()).sum()) == 1


@pytest.fixture(scope="module")
def feature_cloud():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-5, 5, (600, 3)).astype(np.float32)
    pts[:200, 2] = 0.02 * rng.standard_normal(200)        # a plane
    mask = rng.random(600) < 0.95
    return pts, mask


_jax_knn = jknn.knn


def self_pair_exact(q, r, r_mask, k, *args, **kwargs):
    """The JAX package's k-NN with a point's distance to itself set to 0
    where a cloud is searched against itself."""
    d, i = _jax_knn(q, r, r_mask, k, *args, **kwargs)
    if q is r:
        d = jnp.where(i == jnp.arange(q.shape[0])[:, None], 0.0, d)
    return d, i


def exact_in_feature_space(q, r, r_mask, k, *args, **kwargs):
    """``self_pair_exact`` for a cloud against itself, the exact distances
    (``knn_plain``) between two clouds."""
    if q is r:
        return self_pair_exact(q, r, r_mask, k, *args, **kwargs)
    d, i = knn_plain(T(q), T(r), T(r_mask), k)
    return jnp.asarray(d.numpy()), jnp.asarray(i.numpy().astype(np.int32))


def test_self_pair_distance_is_rounding_noise_in_the_jax_knn(feature_cloud):
    pts, mask = feature_cloud
    jp = jnp.asarray(pts)
    jd, _ = jknn.knn(jp, jp, jnp.asarray(mask), 1)
    td, _ = knn_plain(T(pts), T(pts), T(mask), 1)
    assert float(td[T(mask)].max()) == 0.0
    assert (np.asarray(jd)[mask] > 1e-8).any()
    # the repair touches exactly those distances
    rd, _ = self_pair_exact(jp, jp, jnp.asarray(mask), 1)
    assert float(np.abs(np.asarray(rd)[mask]).max()) == 0.0


def test_estimate_normals_and_fpfh(feature_cloud, monkeypatch):
    pts, mask = feature_cloud
    jn, ji, jd = JG.estimate_normals(jnp.asarray(pts), jnp.asarray(mask), 10)
    tn, ti, td = TG.estimate_normals(T(pts), T(mask), 10)
    np.testing.assert_array_equal(N(ti), N(ji))
    np.testing.assert_allclose(N(td), N(jd), atol=1e-4)
    dots = np.abs(np.sum(N(tn) * N(jn), -1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-4)
    monkeypatch.setattr(jknn, "knn", self_pair_exact)
    jf = JG.fpfh(jnp.asarray(pts), jnp.asarray(mask), 10)
    tf = TG.fpfh(T(pts), T(mask), 10)
    assert tf.shape == (600, 33)
    np.testing.assert_allclose(N(tf), N(jf), atol=1e-4)
    assert float(tf[~T(mask)].abs().max()) == 0


def test_register_global_on_the_jax_draw(clouds, monkeypatch):
    monkeypatch.setattr(jknn, "knn", self_pair_exact)
    src, mask, dst = clouds
    key = jax.random.PRNGKey(0)
    H = 256
    js, jm, jd = jnp.asarray(src), jnp.asarray(mask), jnp.asarray(dst)
    # the feature search, the JAX package's own against the exact one
    f_s, f_d = JG.fpfh(js, jm, 12), JG.fpfh(jd, jm, 12)
    dj, ij = (np.asarray(x) for x in _jax_knn(f_s, f_d, jm, 2))
    de, ie = (N(x) for x in knn_plain(T(f_s), T(f_d), T(mask), 3))
    np.testing.assert_allclose(dj[mask], de[mask, :2], rtol=0, atol=1e-5)
    gaps = np.diff(de, axis=1)
    distinct = mask & (gaps[:, 0] > 2e-5) & (gaps[:, 1] > 2e-5)
    assert distinct.sum() > 300
    np.testing.assert_array_equal(ij[distinct], ie[distinct, :2])
    monkeypatch.setattr(jknn, "knn", exact_in_feature_space)
    j = JG.register_global(js, jm, jd, jm, key, n_hypotheses=H)
    # the JAX package's triplets: its own steps up to the draw
    normals, _, _ = JG.estimate_normals(js, jm, 12)
    d_sd, _ = jknn.knn(JG.fpfh(js, jm, 12), JG.fpfh(jd, jm, 12), jm, 2)
    valid = (jm & (jnp.abs(normals[:, 2]) < 0.92)
             & (d_sd[:, 0] < 0.95 ** 2 * jnp.maximum(d_sd[:, 1], 1e-12)) & (d_sd[:, 0] < 1e8))
    w = valid.astype(jnp.float32)
    tri = jax.random.choice(key, src.shape[0], shape=(H, 3), p=w / jnp.maximum(w.sum(), 1.0))
    t = TG.score_triplets(TG.correspondences(T(src), T(mask), T(dst), T(mask), k_feat=12),
                          T(np.asarray(tri)))
    assert int(t.n_corr) == int(j.n_corr) > 30
    assert bool(t.ok) == bool(j.ok)
    np.testing.assert_allclose(N(t.pose.t), N(j.pose.t), atol=1e-3)
    dq = min(np.abs(N(t.pose.q) - N(j.pose.q)).max(), np.abs(N(t.pose.q) + N(j.pose.q)).max())
    assert dq < 1e-3
    # and its own draw lands on valid correspondences only, and verifies too
    corr = TG.correspondences(T(src), T(mask), T(dst), T(mask))
    draw = TG.draw_triplets(corr.valid, 64, torch.Generator().manual_seed(0))
    assert bool(corr.valid[draw].all())
    own = TG.register_global(T(src), T(mask), T(dst), T(mask),
                             generator=torch.Generator().manual_seed(1), n_hypotheses=H)
    assert bool(own.ok) == bool(j.ok)
    np.testing.assert_allclose(N(own.pose.t), N(j.pose.t), atol=1e-2)


def test_xcorr_peak():
    rng = np.random.default_rng(5)
    a = rng.random((64, 64)).astype(np.float32)
    b = np.roll(a, (5, -7), axis=(0, 1))
    j = JG._xcorr_peak(jnp.asarray(a), jnp.asarray(b))
    t = TG._xcorr_peak(T(a), T(b))
    assert (int(t[0]), int(t[1])) == (int(j[0]), int(j[1])) == (-5, 7)
    assert float(t[2]) == pytest.approx(float(j[2]), rel=1e-5)
