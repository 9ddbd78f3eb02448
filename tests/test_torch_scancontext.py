"""Scan Context place recognition, port vs JAX package.

Descriptors of the same numpy-seeded clouds go through both packages:
``make_descriptor`` and ``ring_key`` to 1e-5 (heights and occupancy means),
``add`` across the ring's wrap (slot, head, validity equal), the
column-shift cosine distance (distances to 1e-5, shifts equal) and
``detect`` with the ``exclude_after`` insertion-id rule (candidate index and
yaw equal, distance to 1e-5). Invalid slots stay invalid through the
column-shift stage: a database whose every entry is excluded finds nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mloam_tpu.config import LoopConfig as JLoopConfig
from mloam_tpu.loop import scancontext as JSC
from mloam_tpu_torch.config import LoopConfig
from mloam_tpu_torch.loop import scancontext as TSC
from mloam_tpu_torch.utils import convert

CFG, JCFG = LoopConfig(), JLoopConfig()
TOL = 1e-5


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def scene(seed, n=2000, rot=0.0):
    """Uniform points within 40 m, heights 0..5 m, 10 % masked; the x-y
    coordinates turned by ``-rot`` (so that scan context recovers +rot)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-40, 40, (n, 2))
    z = rng.uniform(0.0, 5.0, (n, 1))
    c, s = np.cos(rot), np.sin(rot)
    xy = xy @ np.array([[c, s], [-s, c]])
    pts = np.concatenate([xy, z], 1).astype(np.float32)
    mask = rng.random(n) < 0.9
    return pts, mask


def both_desc(pts, mask):
    t = TSC.make_descriptor(torch.from_numpy(pts), torch.from_numpy(mask), CFG)
    j = JSC.make_descriptor(jnp.asarray(pts), jnp.asarray(mask), JCFG)
    return t, j


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_descriptor_and_ring_key(seed):
    t, j = both_desc(*scene(seed))
    assert t.shape == (CFG.sc_num_rings, CFG.sc_num_sectors)
    np.testing.assert_allclose(N(t), N(j), rtol=0, atol=TOL)
    np.testing.assert_allclose(N(TSC.ring_key(t)), N(JSC.ring_key(j)), rtol=0, atol=TOL)
    assert (N(t) != 0).sum() == (N(j) != 0).sum()


def test_add_across_the_ring_wrap():
    tdb, jdb = TSC.empty_db(4, CFG), JSC.empty_db(4, JCFG)
    for i in range(7):
        t, j = both_desc(*scene(10 + i))
        tdb, jdb = TSC.add(tdb, t), JSC.add(jdb, j)
        assert int(tdb.head) == int(jdb.head) == i + 1
        np.testing.assert_array_equal(N(tdb.valid), N(jdb.valid))
        np.testing.assert_allclose(N(tdb.desc), N(jdb.desc), rtol=0, atol=TOL)
        np.testing.assert_allclose(N(tdb.ring_key), N(jdb.ring_key), rtol=0, atol=TOL)
    # slot 6 % 4 == 2 holds the last descriptor
    np.testing.assert_allclose(N(tdb.desc[2]), N(t), rtol=0, atol=0)


def test_add_under_a_false_where_changes_nothing():
    tdb = TSC.empty_db(3, CFG)
    t, _ = both_desc(*scene(3))
    tdb = TSC.add(tdb, t, where=torch.tensor(False))
    assert int(tdb.head) == 0 and not bool(tdb.valid.any())
    assert float(tdb.desc.abs().max()) == 0


def test_shifted_cosine_dist():
    q, jq = both_desc(*scene(20))
    cands = [both_desc(*scene(20 + k, rot=0.3 * k)) for k in range(5)]
    tc = torch.stack([c[0] for c in cands])
    jc = jnp.stack([c[1] for c in cands])
    td, ts = TSC._shifted_cosine_dist(q, tc)
    jd, js = JSC._shifted_cosine_dist(jq, jc)
    np.testing.assert_allclose(N(td), N(jd), rtol=0, atol=TOL)
    np.testing.assert_array_equal(N(ts), N(js))
    assert float(td[0]) < 1e-6 and int(ts[0]) == 0


def build(n, rot_query, seed0=30):
    tdb, jdb = TSC.empty_db(8, CFG), JSC.empty_db(8, JCFG)
    for i in range(n):
        t, j = both_desc(*scene(seed0 + i))
        tdb, jdb = TSC.add(tdb, t), JSC.add(jdb, j)
    return tdb, jdb, both_desc(*scene(seed0 + 2, rot=rot_query))


@pytest.mark.parametrize("exclude_after", [100, 3, 2, 0])
def test_detect_with_exclude_after(exclude_after):
    """The query is entry 2 rotated by 0.7 rad: found (index 2, yaw near
    -0.7) unless the insertion-id rule excludes it."""
    tdb, jdb, (q, jq) = build(5, 0.7)
    tc = TSC.detect(tdb, q, CFG, exclude_after=torch.tensor(exclude_after))
    jc = JSC.detect(jdb, jq, JCFG, exclude_after=jnp.asarray(exclude_after))
    assert int(tc.index) == int(jc.index)
    assert bool(tc.found) == bool(jc.found) == (exclude_after > 2)
    assert float(tc.yaw) == pytest.approx(float(jc.yaw), abs=1e-6)
    if np.isfinite(float(jc.dist)):
        assert float(tc.dist) == pytest.approx(float(jc.dist), abs=TOL)
    else:
        assert not np.isfinite(float(tc.dist))
    if exclude_after > 2:
        assert int(tc.index) == 2 and abs(float(tc.yaw) - 0.7) < 0.12


def test_detect_across_the_ring_wrap_and_convert():
    """Eleven entries in a ring of eight: insertion ids wrap; the database
    carried across from the JAX package detects the same candidate."""
    tdb, jdb, (q, jq) = build(11, -0.4, seed0=50)
    for ex in (11, 9, 6):
        tc = TSC.detect(tdb, q, CFG, exclude_after=torch.tensor(ex))
        conv = convert.scan_context_db_from_numpy(tuple(np.asarray(x) for x in jdb))
        cc = TSC.detect(conv, q, CFG, exclude_after=torch.tensor(ex))
        jc = JSC.detect(jdb, jq, JCFG, exclude_after=jnp.asarray(ex))
        for c in (tc, cc):
            assert int(c.index) == int(jc.index) and bool(c.found) == bool(jc.found)
            assert float(c.yaw) == pytest.approx(float(jc.yaw), abs=1e-6)


def test_empty_and_all_excluded_find_nothing():
    q, _ = both_desc(*scene(5))
    c = TSC.detect(TSC.empty_db(4, CFG), q, CFG, exclude_after=torch.tensor(10))
    assert not bool(c.found) and not np.isfinite(float(c.dist))
    tdb = TSC.add(TSC.empty_db(4, CFG), q)
    c = TSC.detect(tdb, q, CFG, exclude_after=torch.tensor(0))
    assert not bool(c.found) and not np.isfinite(float(c.dist))
    c = TSC.detect(tdb, q, CFG, exclude_after=torch.tensor(1))
    assert bool(c.found) and int(c.index) == 0 and float(c.dist) < 1e-6
