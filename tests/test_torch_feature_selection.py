"""Good-feature selection, port vs JAX package.

Seeded continuous inputs give distinct log-det gains, so the greedy rounds
must pick the same candidates: masks are held equal. The ``rnd`` method draws
from another generator than ``jax.random``, so it is held statistically (the
kept fraction within 3 sigma of the ratio) and by applying the JAX package's
own draw through ``apply_masks``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mloam_tpu.core.se3 import Pose as JPose
from mloam_tpu.solver import factors as jf
from mloam_tpu.solver import feature_selection as JFS
from mloam_tpu_torch.core.se3 import Pose as TPose
from mloam_tpu_torch.solver import factors as tf
from mloam_tpu_torch.solver import feature_selection as TFS

NP, NE = 240, 96


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(21)
    f = lambda *s, scale=1.0: rng.normal(scale=scale, size=s).astype(np.float32)  # noqa: E731
    n = f(NP, 3)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    wp = (rng.random(NP) < 0.85).astype(np.float32) * rng.uniform(0.3, 1.0, NP).astype(np.float32)
    we = (rng.random(NE) < 0.85).astype(np.float32)
    plane = dict(p=f(NP, 3, scale=15.0), s=np.zeros(NP, np.float32), normal=n,
                 d=f(NP), w=wp)
    pa = f(NE, 3, scale=15.0)
    edge = dict(p=f(NE, 3, scale=15.0), s=np.zeros(NE, np.float32), pa=pa,
                pb=pa + f(NE, 3, scale=0.2), w=we)
    q = np.array([0.98, 0.05, -0.1, 0.15], np.float32)
    q /= np.linalg.norm(q)
    pose = (q, np.array([1.0, -2.0, 0.3], np.float32))
    jp = jf.PlaneCorr(**{k: jnp.asarray(v) for k, v in plane.items()})
    je = jf.EdgeCorr(**{k: jnp.asarray(v) for k, v in edge.items()})
    tp = tf.PlaneCorr(**{k: torch.from_numpy(v) for k, v in plane.items()})
    te = tf.EdgeCorr(**{k: torch.from_numpy(v) for k, v in edge.items()})
    jpose = JPose(*map(jnp.asarray, pose))
    tpose = TPose(*map(torch.from_numpy, pose))
    return jp, je, jpose, tp, te, tpose


def test_jacobian_blocks(inputs):
    jp, je, jpose, tp, te, tpose = inputs
    np.testing.assert_allclose(N(TFS.plane_jacobian_blocks(tp, tpose)),
                               N(JFS.plane_jacobian_blocks(jp, jpose)), atol=2e-5)
    np.testing.assert_allclose(N(TFS.edge_jacobian_blocks(te, tpose)),
                               N(JFS.edge_jacobian_blocks(je, jpose)), atol=2e-5)


@pytest.mark.parametrize("ratio", [0.3, 0.6, "traced"])
def test_logdet_gain_select(inputs, ratio):
    jp, je, jpose, tp, te, tpose = inputs
    Jp_j, Je_j = JFS.plane_jacobian_blocks(jp, jpose), JFS.edge_jacobian_blocks(je, jpose)
    Jp_t, Je_t = TFS.plane_jacobian_blocks(tp, tpose), TFS.edge_jacobian_blocks(te, tpose)
    if ratio == "traced":
        # a device ratio under a host bound (the gd_float path)
        sel = jax.jit(lambda r: JFS.logdet_gain_select(Jp_j, jp.w, Je_j, je.w, r,
                                                       max_ratio=0.8))
        jkp, jke = sel(jnp.float32(0.5))
        tkp, tke = TFS.logdet_gain_select(Jp_t, tp.w, Je_t, te.w, torch.tensor(0.5),
                                          max_ratio=0.8)
    else:
        jkp, jke = JFS.logdet_gain_select(Jp_j, jp.w, Je_j, je.w, ratio)
        tkp, tke = TFS.logdet_gain_select(Jp_t, tp.w, Je_t, te.w, ratio)
    np.testing.assert_array_equal(N(tkp), N(jkp))
    np.testing.assert_array_equal(N(tke), N(jke))
    n_valid = int((N(tp.w) > 0).sum() + (N(te.w) > 0).sum())
    assert 0 < int(tkp.sum() + tke.sum()) <= int(np.ceil(0.6 * n_valid)) + 8
    assert not bool((tkp & (tp.w <= 0)).any())


def test_fps_select(inputs):
    jp, _, _, tp, _, _ = inputs
    j = JFS.fps_select(jp.p, jp.w, 40)
    t = TFS.fps_select(tp.p, tp.w, 40)
    np.testing.assert_array_equal(N(t), N(j))
    assert int(t.sum()) == 40


@pytest.mark.parametrize("method", ["gd", "fps", "full"])
def test_apply_selection(inputs, method):
    jp, je, jpose, tp, te, tpose = inputs
    jpo, jeo = JFS.apply_selection(jp, je, jpose, method, 0.4)
    tpo, teo = TFS.apply_selection(tp, te, tpose, method, 0.4)
    np.testing.assert_array_equal(N(tpo.w), N(jpo.w))
    np.testing.assert_array_equal(N(teo.w), N(jeo.w))


def test_rnd_is_bernoulli_of_the_ratio_and_applies_a_given_draw(inputs):
    jp, je, jpose, tp, te, tpose = inputs
    ratio = 0.4
    kept = n = 0
    for step in range(20):
        g = torch.Generator().manual_seed((17 << 32) | step)
        pw, ew = TFS.apply_selection(tp, te, tpose, "rnd", ratio, generator=g)
        kept += int((pw.w > 0).sum() + (ew.w > 0).sum())
        n += int((tp.w > 0).sum() + (te.w > 0).sum())
        assert not bool((pw.w > 0).logical_and(tp.w <= 0).any())
    sigma = np.sqrt(n * ratio * (1 - ratio))
    assert abs(kept - ratio * n) < 3 * sigma
    # the same seed draws the same mask; another seed another
    a = TFS.random_select(tp.w, ratio, torch.Generator().manual_seed(5))
    b = TFS.random_select(tp.w, ratio, torch.Generator().manual_seed(5))
    c = TFS.random_select(tp.w, ratio, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the JAX package's own draw, applied through the port
    key = jax.random.fold_in(jax.random.PRNGKey(17), 3)
    jpo, jeo = JFS.apply_selection(jp, je, jpose, "rnd", ratio, key=key)
    kp, ke = jax.random.split(key)
    mp = JFS.random_select(jp.w, ratio, kp)
    me = JFS.random_select(je.w, ratio, ke)
    tpo, teo = TFS.apply_masks(tp, te, torch.tensor(np.asarray(mp)),
                               torch.tensor(np.asarray(me)))
    np.testing.assert_array_equal(N(tpo.w), N(jpo.w))
    np.testing.assert_array_equal(N(teo.w), N(jeo.w))
    with pytest.raises(ValueError, match="generator"):
        TFS.apply_selection(tp, te, tpose, "rnd", ratio)
    with pytest.raises(ValueError, match="unknown"):
        TFS.apply_selection(tp, te, tpose, "nope", ratio)
