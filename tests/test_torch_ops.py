"""Port vs JAX package: ops/select, ops/sym3x3, ops/voxel, ops/knn.

Inputs come from a numpy seed and go through both sides. Integer results
(selection indices, masks, voxel membership) are compared exactly; float
results to 1e-5/1e-6 (same f32 formulas, different summation order inside a
voxel or a dot product). k-NN: the JAX reference forms distances through the
recentred ||q||²+||r||²-2q·r expansion, the port by direct differences, so
squared distances agree to ~1e-3 absolute at 40 m coordinates (the JAX
package's own tolerance for its two paths) and indices are compared only
where neighbouring distances are further apart than that.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mloam_tpu.ops import knn as jknn
from mloam_tpu.ops import select as jsel
from mloam_tpu.ops import sym3x3 as jsym
from mloam_tpu.ops import voxel as jvox
from mloam_tpu_torch.ops import hopper_knn
from mloam_tpu_torch.ops import knn as tknn
from mloam_tpu_torch.ops import select as tsel
from mloam_tpu_torch.ops import sym3x3 as tsym
from mloam_tpu_torch.ops import voxel as tvox


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ----------------------------------------------------------------- select

def test_masked_top_and_bottom_k():
    rng = np.random.default_rng(0)
    s = rng.normal(size=(6, 50)).astype(np.float32)
    s[:, 10] = s[:, 3]                      # ties: lowest index must win
    m = rng.random((6, 50)) < 0.6
    m[2] = False
    for tf, jf in ((tsel.masked_top_k, jsel.masked_top_k),
                   (tsel.masked_bottom_k, jsel.masked_bottom_k)):
        tv, ti, tok = tf(T(s), T(m), 7)
        jv, ji, jok = jf(jnp.asarray(s), jnp.asarray(m), 7)
        np.testing.assert_array_equal(N(tok), N(jok))
        np.testing.assert_array_equal(N(ti)[N(tok)], N(ji)[N(jok)])
        np.testing.assert_allclose(N(tv)[N(tok)], N(jv)[N(jok)], rtol=0, atol=0)


@pytest.mark.parametrize("n_valid,cap", [(30, 64), (64, 64), (300, 64), (0, 16), (999, 128)])
def test_compact_stride_and_gather_indices(n_valid, cap):
    rng = np.random.default_rng(n_valid + cap)
    n = 1000
    m = np.zeros(n, bool)
    m[rng.choice(n, n_valid, replace=False)] = True
    v = rng.normal(size=(n, 5)).astype(np.float32)
    tv, tm = tsel.compact_stride(T(v), T(m), cap)
    jv, jm = jsel.compact_stride(jnp.asarray(v), jnp.asarray(m), cap)
    np.testing.assert_array_equal(N(tm), N(jm))
    np.testing.assert_array_equal(N(tv), N(jv))
    ti, tm2 = tsel.compact_gather_indices(T(m), cap)
    ji, jm2 = jsel.compact_gather_indices(jnp.asarray(m), cap)
    np.testing.assert_array_equal(N(tm2), N(jm2))
    np.testing.assert_array_equal(N(ti)[N(tm2)], N(ji)[N(jm2)])


def test_compact_by_mask():
    rng = np.random.default_rng(3)
    m = rng.random(200) < 0.3
    v = rng.normal(size=(200, 3)).astype(np.float32)
    tv, tm = tsel.compact_by_mask(T(v), T(m))
    jv, jm = jsel.compact_by_mask(jnp.asarray(v), jnp.asarray(m))
    np.testing.assert_array_equal(N(tm), N(jm))
    np.testing.assert_array_equal(N(tv), N(jv))


# ----------------------------------------------------------------- sym3x3

def _sym_batch():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(500, 3, 3)).astype(np.float32)
    A = a @ a.transpose(0, 2, 1)
    A[0] = np.eye(3)                        # isotropic
    A[1] = np.diag([1.0, 1.0, 5.0])         # repeated pair
    p = rng.normal(size=(5, 3)).astype(np.float32) * np.array([3, 0.01, 0.01], np.float32)
    A[2] = p.T @ p                          # near-line scatter
    return A.astype(np.float32)


def test_sym3x3_matches_reference_and_lapack():
    A = _sym_batch()
    tv = tsym.eigvalsh3(T(A))
    np.testing.assert_allclose(N(tv), N(jsym.eigvalsh3(jnp.asarray(A))), rtol=1e-5, atol=1e-5)
    ref = np.linalg.eigvalsh(A.astype(np.float64))
    np.testing.assert_allclose(N(tv), ref, rtol=2e-4, atol=2e-4 * np.abs(ref).max())
    for tf, jf in ((tsym.smallest_eigvec3, jsym.smallest_eigvec3),
                   (tsym.largest_eigvec3, jsym.largest_eigvec3)):
        _, vt = tf(T(A))
        _, vj = jf(jnp.asarray(A))
        # eigenvectors are defined up to sign; compare |v·v'| on the
        # well-separated cases (the degenerate first two rows have no unique
        # eigenvector)
        dots = np.abs(np.sum(N(vt)[2:] * N(vj)[2:], -1))
        assert dots.min() > 1 - 1e-4


# ------------------------------------------------------------------ voxel

def _cloud(seed, n=600, frac=0.7):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-6, 6, size=(n, 3)).astype(np.float32)
    mask = rng.random(n) < frac
    pay = rng.normal(size=(n, 2)).astype(np.float32)
    return xyz, mask, pay


@pytest.mark.parametrize("packed", [True, False])
def test_voxel_downsample(packed):
    xyz, mask, pay = _cloud(5)
    tx, tm, tp = tvox.voxel_downsample(T(xyz), T(mask), 0.8, T(pay), packed=packed)
    jx, jm, jp = jvox.voxel_downsample(jnp.asarray(xyz), jnp.asarray(mask), 0.8,
                                       jnp.asarray(pay), packed=packed)
    np.testing.assert_array_equal(N(tm), N(jm))
    k = int(N(tm).sum())
    # same voxel order on both sides (sorted by key), centroids to f32 sum order
    np.testing.assert_allclose(N(tx)[:k], N(jx)[:k], atol=1e-5)
    np.testing.assert_allclose(N(tp)[:k], N(jp)[:k], atol=1e-5)


def test_voxel_reduce_and_segment_sum():
    xyz, mask, pay = _cloud(6)
    tred = tvox.voxel_reduce(tvox.voxel_coords(T(xyz), 0.5), T(mask), packed=True)
    jred = jvox.voxel_reduce(jvox.voxel_coords(jnp.asarray(xyz), 0.5), jnp.asarray(mask), packed=True)
    assert int(tred.num_voxels) == int(jred.num_voxels)
    # the set of points per voxel is the same: compare seg ids through the
    # (stable) sort order
    np.testing.assert_array_equal(N(tred.order), N(jred.order))
    np.testing.assert_array_equal(N(tred.seg_id), N(jred.seg_id))
    np.testing.assert_allclose(N(tvox.segment_sum(T(pay), tred)),
                               N(jvox.segment_sum(jnp.asarray(pay), jred)), atol=1e-5)
    w = np.abs(pay[:, 0]) + 0.1
    np.testing.assert_allclose(
        N(tvox.segment_mean(T(xyz), tred, T(w)))[: int(tred.num_voxels)],
        N(jvox.segment_mean(jnp.asarray(xyz), jred, jnp.asarray(w)))[: int(tred.num_voxels)],
        atol=1e-5)


def test_voxel_downsample_two_class():
    xa, ma, _ = _cloud(7, 400, 0.5)
    xb, mb, _ = _cloud(8, 900, 0.8)
    t = tvox.voxel_downsample_two_class(T(xa), T(ma), 0.4, T(xb), T(mb), 0.9)
    j = jvox.voxel_downsample_two_class(jnp.asarray(xa), jnp.asarray(ma), 0.4,
                                        jnp.asarray(xb), jnp.asarray(mb), 0.9)
    for (tx, tm), (jx, jm) in (((t[0], t[1]), (j[0], j[1])), ((t[2], t[3]), (j[2], j[3]))):
        np.testing.assert_array_equal(N(tm), N(jm))
        k = int(N(tm).sum())
        assert k > 0
        np.testing.assert_allclose(N(tx)[:k], N(jx)[:k], atol=1e-5)


# -------------------------------------------------------------------- knn

def _check_knn(q, r, m, k, atol=1e-3):
    td, ti = tknn.knn(T(q), T(r), T(m), k)
    jd, ji = jknn.knn(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m), k)
    td, ti, jd, ji = N(td), N(ti), N(jd), N(ji)
    assert td.shape == (q.shape[0], k) and ti.dtype == np.int64
    assert ((ti >= 0) & (ti < r.shape[0])).all()
    real = jd < 1e29
    np.testing.assert_array_equal(td < 1e29, real)
    assert (td[~real] == np.float32(1e30)).all()
    np.testing.assert_allclose(td[real], jd[real], atol=atol, rtol=1e-5)
    assert (np.diff(td, axis=1) >= 0).all()
    # exact against float64 brute force
    d64 = ((q[:, None].astype(np.float64) - r[None].astype(np.float64)) ** 2).sum(-1)
    d64[:, ~m] = np.inf
    want = np.sort(d64, axis=1)[:, :k]
    ok = np.isfinite(want)
    np.testing.assert_allclose(td[ok[:, : td.shape[1]]], want[ok], rtol=1e-5, atol=1e-6)
    # indices where the neighbouring distances are distinct
    gap = np.full_like(jd, np.inf)
    if k > 1:
        g = np.diff(jd, axis=1)
        gap[:, 1:] = np.minimum(gap[:, 1:], g)
        gap[:, :-1] = np.minimum(gap[:, :-1], g)
    nxt = np.sort(d64, axis=1)[:, k] - want[:, k - 1] if r.shape[0] > k else np.full(q.shape[0], np.inf)
    gap[:, k - 1] = np.minimum(gap[:, k - 1], nxt)
    distinct = real & (gap > 4 * atol)
    assert distinct.sum() > 0 or not real.any()
    np.testing.assert_array_equal(ti[distinct], ji[distinct])
    assert m[ti[real]].all()


@pytest.mark.parametrize("k", [1, 5, 8])
def test_knn_dense(k):
    rng = np.random.default_rng(10 + k)
    q = (rng.normal(size=(200, 3)) * 5).astype(np.float32)
    r = (rng.normal(size=(900, 3)) * 5).astype(np.float32)
    _check_knn(q, r, np.arange(900) < 800, k)


def test_knn_almost_all_masked():
    rng = np.random.default_rng(5)
    r = rng.uniform(-10, 10, (2500, 3)).astype(np.float32)
    q = rng.uniform(-10, 10, (300, 3)).astype(np.float32)
    _check_knn(q, r, np.arange(2500) < 40, 5)
    _check_knn(q[:50], r[:60], np.arange(60) < 3, 5)     # fewer valid than k


def test_knn_chunked_ragged_and_lidar_range():
    """Nr above the plain version's chunk and not a multiple of it, with
    coordinates at LiDAR range (where an expansion without recentring would
    cancel)."""
    rng = np.random.default_rng(6)
    r = (rng.uniform(-1, 1, (5003, 3)) * [20, 20, 2] + [40, -35, 1]).astype(np.float32)
    q = r[rng.choice(5003, 128, replace=False)] + rng.normal(size=(128, 3)).astype(np.float32) * 0.05
    _check_knn(q, r, rng.random(5003) < 0.9, 5, atol=2e-3)
    td, ti = tknn.knn_plain(T(q), T(r), torch.ones(5003, dtype=torch.bool), 5, chunk=1000)
    td2, ti2 = tknn.knn_plain(T(q), T(r), torch.ones(5003, dtype=torch.bool), 5, chunk=8192)
    np.testing.assert_array_equal(N(td), N(td2))
    np.testing.assert_array_equal(N(ti), N(ti2))


def test_knn_nr_less_than_k():
    rng = np.random.default_rng(7)
    q = rng.normal(size=(20, 3)).astype(np.float32)
    r = rng.normal(size=(3, 3)).astype(np.float32)
    td, ti = tknn.knn(T(q), T(r), torch.ones(3, dtype=torch.bool), 5)
    jd, _ = jknn.knn(jnp.asarray(q), jnp.asarray(r), jnp.ones(3, bool), 5)
    np.testing.assert_allclose(N(td), N(jd), atol=1e-4)
    assert (N(td)[:, 3:] == np.float32(1e30)).all()
    assert ((N(ti) >= 0) & (N(ti) < 3)).all()


def test_nearest_and_knn_auto():
    rng = np.random.default_rng(8)
    q = rng.normal(size=(64, 3)).astype(np.float32) * 3
    r = rng.normal(size=(256, 3)).astype(np.float32) * 3
    m = rng.random(256) < 0.7
    td, ti = tknn.nearest(T(q), T(r), T(m))
    jd, ji = jknn.nearest(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m))
    np.testing.assert_allclose(N(td), N(jd), atol=1e-4)
    np.testing.assert_array_equal(N(ti), N(ji))
    ad, ai = tknn.knn_auto(T(q), T(r), T(m), 1)
    np.testing.assert_array_equal(N(ai)[:, 0], N(ti))


def test_knn_k1_matches_pallas_kernel_interpreted():
    """The TPU kernel the CUDA kernel replaces, run in interpret mode: exact
    for k=1, so the port's plain version must pick the same reference."""
    from jax.experimental import pallas as pl

    import mloam_tpu.ops.pallas_knn as PK

    rng = np.random.default_rng(9)
    q = (rng.normal(size=(300, 3)) * 5).astype(np.float32)
    r = (rng.normal(size=(1000, 3)) * 5).astype(np.float32)
    m = np.arange(1000) < 900
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        pd, pi = PK.knn_pallas(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m), 1)
    finally:
        pl.pallas_call = orig
    td, ti = tknn.knn(T(q), T(r), T(m), 1)
    np.testing.assert_allclose(N(td)[:, 0], N(pd)[:, 0], atol=1e-3)
    assert (N(ti)[:, 0] == N(pi)[:, 0]).mean() == 1.0


def _tie_grid(seed):
    """Integer-grid references in shuffled order and half-integer queries:
    every squared distance is a multiple of 1/4, exact in float32 and float64,
    and most k-lists hold ties."""
    rng = np.random.default_rng(seed)
    ax = np.arange(7, dtype=np.float32)
    r = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    r = r[rng.permutation(r.shape[0])]
    q = (rng.integers(0, 6, (120, 3)) + 0.5).astype(np.float32)
    return q, r, rng.random(r.shape[0]) < 0.7


@pytest.mark.parametrize("chunk", [4096, 50])
@pytest.mark.parametrize("k", [1, 5, 8])
def test_knn_plain_takes_the_lowest_index_on_ties(k, chunk):
    """The kernel's tie rule: among equal distances the lowest index, in the
    per-chunk selection and across the running merge (chunk=50 < Nr=343)."""
    q, r, m = _tie_grid(k)
    for mask in (np.ones(r.shape[0], bool), m):
        td, ti = tknn.knn_plain(T(q), T(r), T(mask), k, chunk=chunk)
        d64 = ((q[:, None].astype(np.float64) - r[None]) ** 2).sum(-1)
        d64[:, ~mask] = np.inf
        want = np.argsort(d64, axis=1, kind="stable")[:, :k]
        np.testing.assert_array_equal(N(ti), want)
        np.testing.assert_array_equal(N(td), np.take_along_axis(d64, want, 1))
        kth = np.take_along_axis(d64, want[:, -1:], 1)
        assert ((d64 == kth).sum(1) > 1).mean() > 0.5   # the k-th slot ties



def test_knn_plain_empty_slots_hold_index_zero():
    rng = np.random.default_rng(12)
    q = rng.normal(size=(10, 3)).astype(np.float32)
    r = rng.normal(size=(40, 3)).astype(np.float32)
    m = np.zeros(40, bool)
    m[[7, 30]] = True
    td, ti = tknn.knn_plain(T(q), T(r), T(m), 5, chunk=16)
    assert (N(td)[:, 2:] == np.float32(1e30)).all() and (N(ti)[:, 2:] == 0).all()
    assert set(N(ti)[:, :2].ravel()) <= {7, 30}


@pytest.mark.parametrize("nq,lanes", [(192, 32), (384, 32), (3072, 8), (6144, 8)],
                         ids=["tracker_edge", "tracker_plane", "window_edge",
                              "window_plane"])
def test_knn_lanes_per_query_at_the_main_path_shapes(nq, lanes):
    """On a 132-SM card: at least four warps an SM where 32 lanes allow it,
    never fewer than 8 lanes a query."""
    got = hopper_knn.lanes_per_query(nq, 132)
    assert got == lanes
    assert nq * got // 32 >= 4 * 132 or got == 32
    assert got == hopper_knn.MIN_LANES or nq * got // 2 // 32 < 4 * 132


def test_knn_reference_buffers_are_16_byte_aligned():
    base = torch.zeros(1001, 3)
    view = base.reshape(-1)[1:3001].reshape(1000, 3)   # starts 4 bytes in
    assert view.data_ptr() % 16 != 0
    out = hopper_knn.aligned16(view)
    assert out.data_ptr() % 16 == 0 and torch.equal(out, view)
    assert hopper_knn.aligned16(base).data_ptr() == base.data_ptr()


def test_knn_wrapper_rejects_bad_arguments():
    q = torch.zeros((4, 3))
    r = torch.zeros((5, 3))
    m = torch.ones(5, dtype=torch.bool)
    with pytest.raises(ValueError):
        tknn.knn(q, r, m, 9)
    with pytest.raises(TypeError):
        tknn.knn(q.double(), r, m, 2)
    with pytest.raises(TypeError):
        tknn.knn(q, r, m.float(), 2)
    with pytest.raises(TypeError):
        tknn.knn(torch.zeros((4, 2)), r, m, 2)
