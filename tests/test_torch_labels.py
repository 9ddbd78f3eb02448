"""Port vs JAX package: label propagation (the module that holds kernel K1)
and range-image segmentation.

``propagate_labels`` on CPU tensors runs the plain version, which follows the
kernel's round structure (row, seam stitch, row, column). It is held
integer-exact against the TPU kernel it replaces, run in interpret mode.
``segment`` as a whole is held against the JAX package's CPU ``segment``,
whose round structure differs (row, half-rolled row, column) and agrees with
the kernel's only at convergence: masks are compared with a stated budget of
threshold pixels, labels only where both sides have converged.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mloam_tpu.config import SegmenterConfig as JSegCfg
from mloam_tpu.core.rangeimage import LidarModel as JModel
from mloam_tpu.frontend import segmentation as JS
from mloam_tpu.ops import pallas_labels as PL
from mloam_tpu.sim import world as JW
from mloam_tpu_torch.config import SegmenterConfig
from mloam_tpu_torch.core.rangeimage import LidarModel
from mloam_tpu_torch.frontend import segmentation as TS
from mloam_tpu_torch.ops import hopper_labels
from mloam_tpu_torch.utils import convert


def _random_case(r, c, seed):
    rng = np.random.default_rng(seed)
    clusterable = rng.random((r, c)) < 0.8
    conn_h = np.zeros((r, c), bool)
    conn_h[:, 1:] = clusterable[:, 1:] & clusterable[:, :-1] & (rng.random((r, c - 1)) < 0.7)
    conn_h[:, 0] = clusterable[:, 0] & clusterable[:, -1] & (rng.random(r) < 0.5)
    conn_v = np.zeros((r, c), bool)
    conn_v[1:] = clusterable[1:] & clusterable[:-1] & (rng.random((r - 1, c)) < 0.5)
    labels = np.where(clusterable, np.arange(r * c, dtype=np.int32).reshape(r, c),
                      np.int32(r * c)).astype(np.int32)
    return labels, conn_h, conn_v


def _pallas_interpreted(labels, conn_h, conn_v, rounds):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        # bypass the jit cache of other interpret/non-interpret traces
        out = PL.propagate_labels_pallas.__wrapped__(
            jnp.asarray(labels), jnp.asarray(conn_h), jnp.asarray(conn_v), rounds)
    finally:
        pl.pallas_call = orig
    return np.asarray(out)


@pytest.mark.parametrize("rounds", [1, 3, 8])
@pytest.mark.parametrize("shape", [(16, 384), (8, 360), (5, 130)])
def test_plain_version_equals_tpu_kernel(shape, rounds):
    labels, ch, cv = _random_case(*shape, seed=11 + rounds)
    want = _pallas_interpreted(labels, ch, cv, rounds)
    got = hopper_labels.propagate_labels(
        torch.from_numpy(labels), torch.from_numpy(ch), torch.from_numpy(cv), rounds)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_converged_labels_are_component_minima():
    """At convergence every cell carries the smallest pixel index of its
    connected component (checked against a union-find on the host)."""
    r, c = 12, 96
    labels, ch, cv = _random_case(r, c, seed=3)
    got = hopper_labels.propagate_labels(
        torch.from_numpy(labels), torch.from_numpy(ch), torch.from_numpy(cv), 40).numpy()
    parent = list(range(r * c))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    for i in range(r):
        for j in range(c):
            if j > 0 and ch[i, j]:
                union(i * c + j, i * c + j - 1)
            if j == 0 and ch[i, 0]:
                union(i * c, i * c + c - 1)
            if i > 0 and cv[i, j]:
                union(i * c + j, (i - 1) * c + j)
    want = np.array([find(k) for k in range(r * c)]).reshape(r, c)
    clusterable = labels < r * c
    np.testing.assert_array_equal(got[clusterable], want[clusterable])
    assert (got[~clusterable] == r * c).all()


def test_wrapper_rejects_bad_arguments():
    labels, ch, cv = (torch.from_numpy(x) for x in _random_case(4, 16, 0))
    with pytest.raises(TypeError):
        hopper_labels.propagate_labels(labels.long(), ch, cv, 3)
    with pytest.raises(TypeError):
        hopper_labels.propagate_labels(labels, ch.int(), cv, 3)
    with pytest.raises(TypeError):
        hopper_labels.propagate_labels(labels, ch[:, :8], cv, 3)
    with pytest.raises(ValueError):
        hopper_labels.propagate_labels(labels, ch, cv, 0)


@pytest.mark.parametrize("shape", [(16, 1800), (32, 2160), (64, 1800),
                                   (13, 1800), (1, 1800), (5, 37)])
def test_every_sensor_shape_fits_one_cluster(shape):
    """The three sensor shapes (VLP-16, HDL-32, HDL-64) and the odd ones the
    card checks fit one cluster; at their widths 128 rows (16 a block) do not.
    (That the sizes equal the kernel's own layout is checked on the card.)"""
    r, c = shape
    hopper_labels.check_fits(r, c)
    assert hopper_labels.smem_bytes(r, c) <= hopper_labels.MAX_SMEM
    if c >= 1800:
        with pytest.raises(ValueError, match=str(hopper_labels.MAX_SMEM)):
            hopper_labels.check_fits(128, c)


@pytest.fixture(scope="module")
def rendered():
    model = JModel(n_rings=8, n_cols=360)
    w = JW.make_world(jax.random.PRNGKey(0))
    traj = JW.make_trajectory(jax.random.PRNGKey(1))
    imgs, _ = JW.render_sequence(w, traj, model, 3)
    return model, jax.tree.map(np.asarray, imgs)


@pytest.mark.parametrize("frame", [0, 2])
@pytest.mark.parametrize("label_iters", [12, 32])
def test_segment_matches_reference(rendered, frame, label_iters):
    jmodel, imgs = rendered
    jimg = type(imgs)(*(jnp.asarray(f[frame]) for f in imgs))
    timg = convert.range_image_from_numpy(type(imgs)(*(f[frame] for f in imgs)))
    jseg = JS.segment(jimg, jmodel, JSegCfg(label_iters=label_iters))
    tseg = TS.segment(timg, LidarModel(*jmodel), SegmenterConfig(label_iters=label_iters))
    # Threshold pixels: atan2/sin/cos differ in the last ulp between XLA-CPU
    # and PyTorch, so a pixel sitting exactly on `slope < 10 deg` or
    # `beta > theta` can flip, and a flipped connection can move a small
    # cluster across the size gate. None was observed on these frames; the
    # budget is 0 ground pixels and 0 cluster pixels.
    np.testing.assert_array_equal(tseg.ground.numpy(), np.asarray(jseg.ground))
    np.testing.assert_array_equal(tseg.segmented.numpy(), np.asarray(jseg.segmented))
    np.testing.assert_array_equal(tseg.outlier.numpy(), np.asarray(jseg.outlier))
    if label_iters == 32:
        # 8 rounds: both round structures have converged on these frames
        np.testing.assert_array_equal(tseg.label.numpy(), np.asarray(jseg.label))
    assert tseg.label.dtype == torch.int32
    assert int(tseg.segmented.sum()) > 500
