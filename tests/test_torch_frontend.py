"""Port vs JAX package: frontend/features on rendered sweeps.

Curvature is a sliding sum of f32 coordinates; the two sides sum the 11-cell
window in different orders, so curvature agrees to ~1e-4 relative and a cell
sitting on the 0.1 edge threshold or on a local-extreme tie could be picked
differently. On these rendered frames none is: picks are compared exactly as
sets per class, with the stated float tolerance on coordinates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mloam_tpu.config import FeatureConfig as JFeatCfg
from mloam_tpu.config import SegmenterConfig as JSegCfg
from mloam_tpu.core.rangeimage import LidarModel as JModel
from mloam_tpu.frontend import features as JF
from mloam_tpu.frontend import segmentation as JS
from mloam_tpu.sim import world as JW
from mloam_tpu_torch.config import FeatureConfig
from mloam_tpu_torch.frontend import features as TF
from mloam_tpu_torch.utils import convert


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def frame():
    model = JModel(n_rings=8, n_cols=360)
    w = JW.make_world(jax.random.PRNGKey(0))
    traj = JW.make_trajectory(jax.random.PRNGKey(1))
    imgs, _ = JW.render_sequence(w, traj, model, 2)
    jimg = type(imgs)(*(f[1] for f in imgs))
    seg = JS.segment(jimg, model, JSegCfg())
    timg = convert.range_image_from_numpy(jax.tree.map(np.asarray, jimg))
    return jimg, timg, seg.segmented, torch.from_numpy(np.asarray(seg.segmented))


def test_curvature_and_reliability(frame):
    jimg, timg, jseg, tseg = frame
    jc, ju = JF.curvature(jimg, jimg.valid & jseg, 5)
    tc, tu = TF.curvature(timg, timg.valid & tseg, 5)
    np.testing.assert_array_equal(N(tu), N(ju))
    # window sum of coordinates up to ~40 m, squared: relative 1e-4 + the
    # absolute floor of an 11-term f32 sum at that magnitude
    np.testing.assert_allclose(N(tc), N(jc), rtol=1e-4, atol=1e-6 * 40 * 40)
    jr = JF.reliability_mask(jimg, jimg.valid & jseg, 5)
    tr = TF.reliability_mask(timg, timg.valid & tseg, 5)
    np.testing.assert_array_equal(N(tr), N(jr))


@pytest.mark.parametrize("kind", ["add", "max", "min"])
def test_window_reduce_wraps_at_the_seam(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 30)).astype(np.float32)
    t = TF._window_reduce_cols(torch.from_numpy(x), 2, 3, kind)
    j = JF._window_reduce_cols(jnp.asarray(x), 2, 3, kind)
    np.testing.assert_allclose(N(t), N(j), atol=1e-6)
    b = rng.random((4, 30)) < 0.3
    tb = TF._window_reduce_cols(torch.from_numpy(b), 0, 4, "max")
    jb = JF._window_reduce_cols(jnp.asarray(b), 0, 4, "max")
    np.testing.assert_array_equal(N(tb), N(jb))


def _rows(fc):
    """Valid rows of a feature cloud as a sorted array (set comparison)."""
    m = N(fc.mask)
    rows = np.concatenate([N(fc.xyz)[m], N(fc.time)[m, None],
                           N(fc.ring)[m, None].astype(np.float32)], 1)
    return rows[np.lexsort(rows.T[::-1])]


def _assert_same_rows(a, b, atol):
    """The two row sets are equal within ``atol``: each row of ``a`` is
    paired with the row of ``b`` nearest to it, the pairing is one to one,
    and every pair agrees within ``atol``. (Sorting alone pairs the wrong
    rows when two centroids share a coordinate on one side and differ by an
    ulp on the other: the summation orders differ.)"""
    assert a.shape == b.shape
    d = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
    pair = d.argmin(1)
    assert len(set(pair.tolist())) == len(pair)
    np.testing.assert_allclose(a, b[pair], atol=atol)


def test_extract(frame):
    jimg, timg, jseg, tseg = frame
    jcfg = JFeatCfg(cap_less_flat=512)
    tcfg = FeatureConfig(cap_less_flat=512)
    jff = JF.extract(jimg, jseg, jcfg)
    tff = TF.extract(timg, tseg, tcfg)
    for name in ("sharp", "less_sharp", "flat"):
        jf, tf = getattr(jff, name), getattr(tff, name)
        assert N(tf.mask).shape == N(jf.mask).shape
        assert int(N(jf.mask).sum()) > 0
        # same slot layout: (ring, sector, rank) — compare slot by slot
        np.testing.assert_array_equal(N(tf.mask), N(jf.mask))
        np.testing.assert_array_equal(N(tf.ring), N(jf.ring))
        np.testing.assert_allclose(N(tf.xyz), N(jf.xyz), atol=1e-6)
        np.testing.assert_allclose(N(tf.time)[N(tf.mask)], N(jf.time)[N(jf.mask)], atol=1e-7)
    # less-flat: voxel centroids, as sets, to f32 summation order
    jr, tr = _rows(jff.less_flat), _rows(tff.less_flat)
    assert jr.shape == tr.shape and jr.shape[0] > 100
    _assert_same_rows(tr, jr, atol=1e-5)


@pytest.mark.parametrize("precap", [None, 256])
def test_downsample_featcloud(frame, precap):
    jimg, timg, jseg, tseg = frame
    jff = JF.extract(jimg, jseg, JFeatCfg(cap_less_flat=512))
    jfc = jff.less_flat
    tfc = convert.featcloud_from_numpy(jax.tree.map(np.asarray, jfc))
    for cap in (256, 64):      # fits / strides
        jd = JF.downsample_featcloud(jfc, 0.4, cap, precap=precap)
        td = TF.downsample_featcloud(tfc, 0.4, cap, precap=precap)
        np.testing.assert_array_equal(N(td.mask), N(jd.mask))
        np.testing.assert_allclose(N(td.xyz), N(jd.xyz), atol=1e-5)
        np.testing.assert_allclose(N(td.time), N(jd.time), atol=1e-6)
        np.testing.assert_array_equal(N(td.ring), N(jd.ring))


def test_featcloud_containers():
    a = TF.FeatCloud.zeros(4)
    b = TF.FeatCloud.zeros(3)
    c = a.concat(b)
    assert c.xyz.shape == (7, 3) and c.ring.dtype == torch.int32
    assert c.mask.dtype == torch.bool and not c.mask.any()
