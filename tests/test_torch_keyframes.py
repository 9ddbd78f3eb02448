"""Keyframe ring and the uncertainty-weighted voxel filter, port vs JAX
package.

The ring tests are the counterparts of ``tests/test_mapping.py::
TestKeyframeDB``; ``surrounding`` is held index for index (ties to the lowest
slot, as ``lax.top_k`` orders them) including an empty ring. The voxel filter
is compared voxel by voxel after sorting both outputs by voxel key: xyz
within 1e-5 m, covariance within 1e-6 of its largest entry, equal masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mloam_tpu.core.se3 import Pose as JPose
from mloam_tpu.frontend.features import FeatCloud as JFeat
from mloam_tpu.mapping import keyframes as JKF
from mloam_tpu.ops import voxel as jvoxel
from mloam_tpu_torch.core.se3 import Pose as TPose
from mloam_tpu_torch.frontend.features import FeatCloud as TFeat
from mloam_tpu_torch.mapping import keyframes as TKF
from mloam_tpu_torch.ops import voxel as tvoxel
from mloam_tpu_torch.utils import convert


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def tpose(x):
    return TPose(torch.tensor([1.0, 0, 0, 0]), torch.tensor([float(x), 0, 0]))


class TestKeyframeDB:
    def test_insert_and_ring(self):
        db = TKF.empty_db(4, 8, 8)
        fc = TFeat.zeros(8)
        for i in range(6):
            db = TKF.insert(db, tpose(i), torch.eye(6), fc, fc)
        assert bool(db.valid.all())
        assert int(db.head) == 6
        # ring: slots hold poses 4,5,2,3
        assert N(db.poses.t)[:, 0].tolist() == [4.0, 5.0, 2.0, 3.0]

    def test_conditional_insert_writes_one_slot_or_none(self):
        db = TKF.empty_db(3, 4, 4, 2)
        fc = TFeat(torch.ones(4, 3), torch.ones(4, dtype=torch.bool), torch.ones(4),
                   torch.ones(4, dtype=torch.int32))
        out = TFeat(2 * torch.ones(2, 3), torch.ones(2, dtype=torch.bool),
                    torch.zeros(2), torch.zeros(2, dtype=torch.int32))
        db = TKF.insert(db, tpose(7), 3 * torch.eye(6), fc, fc, out,
                        where=torch.tensor(False))
        assert int(db.head) == 0 and not bool(db.valid.any())
        assert float(db.cov.abs().max()) == 0 and float(db.corner.xyz.abs().max()) == 0
        db = TKF.insert(db, tpose(7), 3 * torch.eye(6), fc, fc, out,
                        where=torch.tensor(True))
        assert int(db.head) == 1 and N(db.valid).tolist() == [True, False, False]
        assert float(db.poses.t[0, 0]) == 7.0 and float(db.cov[0, 0, 0]) == 3.0
        assert bool(db.surf.mask[0].all()) and not bool(db.surf.mask[1:].any())
        assert float(db.outlier.xyz[0].min()) == 2.0
        # without an outlier cloud the slot's outlier stays as it was
        db = TKF.insert(db, tpose(8), torch.eye(6), fc, fc)
        assert float(db.outlier.xyz[1].abs().max()) == 0.0

    def test_should_insert_gates(self):
        p0 = TPose.identity()
        assert not bool(TKF.should_insert(tpose(0.5), p0, 1.0, 1.0))
        assert bool(TKF.should_insert(tpose(1.5), p0, 1.0, 1.0))
        rotated = TPose(torch.tensor([0.9999, 0.0, 0.0, 0.0175]), torch.zeros(3))
        assert bool(TKF.should_insert(rotated, p0, 1.0, 1.0))  # ~2 deg yaw

    def test_surrounding_radius(self):
        db = TKF.empty_db(8, 4, 4)
        fc = TFeat.zeros(4)
        for i in range(8):
            db = TKF.insert(db, tpose(10 * i), torch.eye(6), fc, fc)
        idx, ok = TKF.surrounding(db, torch.zeros(3), radius=25.0, m=8)
        assert int(ok.sum()) == 3  # keyframes at 0, 10, 20


def _ring(rng, k, n_valid, ties):
    """A JAX ring of capacity k with n_valid keyframes; with ``ties`` the
    positions repeat so that distances tie."""
    db = JKF.empty_db(k, 4, 4, 2)
    fc, oc = JFeat.zeros(4), JFeat.zeros(2)
    for i in range(n_valid):
        x = float(i % 3) if ties else float(rng.normal(scale=20.0))
        y = 0.0 if ties else float(rng.normal(scale=20.0))
        db = JKF.insert(db, JPose(jnp.array([1.0, 0, 0, 0]), jnp.array([x, y, 0.0])),
                        jnp.eye(6), fc, fc, oc)
    return db


@pytest.mark.parametrize("case", ["random", "ties", "empty", "wrapped"])
@pytest.mark.parametrize("m", [3, 50])
def test_surrounding_matches_reference(case, m):
    rng = np.random.default_rng(7)
    n_valid = {"random": 9, "ties": 10, "empty": 0, "wrapped": 20}[case]
    jdb = _ring(rng, 12, n_valid, ties=case == "ties")
    tdb = convert.keyframe_db_from_numpy(jax.tree.map(np.asarray, jdb))
    center = np.array([0.5, 0.0, 0.0], np.float32)
    ji, jok = JKF.surrounding(jdb, jnp.asarray(center), 15.0, m)
    ti, tok = TKF.surrounding(tdb, torch.from_numpy(center), 15.0, m)
    assert ti.shape == (min(m, 12),)
    np.testing.assert_array_equal(N(tok), N(jok))
    np.testing.assert_array_equal(N(ti), N(ji))   # every slot, invalid ones too


def test_insert_matches_reference_across_wrap():
    rng = np.random.default_rng(8)
    jdb = JKF.empty_db(3, 5, 6, 2)
    tdb = TKF.empty_db(3, 5, 6, 2)
    for i in range(5):
        q = rng.normal(size=4).astype(np.float32)
        q /= np.linalg.norm(q)
        t = rng.normal(size=3).astype(np.float32)
        cov = rng.normal(size=(6, 6)).astype(np.float32)
        clouds = [(rng.normal(size=(n, 3)).astype(np.float32), rng.random(n) < 0.5,
                   rng.random(n).astype(np.float32),
                   rng.integers(0, 16, n).astype(np.int32)) for n in (5, 6, 2)]
        jdb = JKF.insert(jdb, JPose(jnp.asarray(q), jnp.asarray(t)), jnp.asarray(cov),
                         *(JFeat(*map(jnp.asarray, c)) for c in clouds))
        tdb = TKF.insert(tdb, TPose(torch.from_numpy(q), torch.from_numpy(t)),
                         torch.from_numpy(cov),
                         *(convert.featcloud_from_numpy(c) for c in clouds))
    for a, b in zip(jax.tree.leaves(jdb), jax.tree.leaves(tuple(tdb))):
        np.testing.assert_array_equal(N(b), np.asarray(a))


def _cov_cloud(rng, n, spread, payload_dims):
    xyz = rng.normal(scale=spread, size=(n, 3)).astype(np.float32)
    # points in few voxels: many shared, a few with a trace over the gate
    a = rng.normal(size=(n, 3, 3)).astype(np.float32)
    cov = (a @ a.transpose(0, 2, 1) * rng.uniform(0.01, 0.4, (n, 1, 1))).astype(np.float32)
    mask = rng.random(n) < 0.8
    payload = None
    if payload_dims is not None:
        # distinct payloads, so the heaviest member's is the one compared
        payload = rng.permutation(n * int(np.prod(payload_dims or (1,)))) \
            .reshape((n,) + tuple(payload_dims)).astype(np.float32)
    return xyz, cov, mask, payload


def _by_key(xyz, cov, mask, payload, leaf):
    m = N(mask)
    x = N(xyz)[m]
    key = np.floor(x / leaf).astype(np.int64)
    order = np.lexsort(key.T[::-1])
    out = [x[order], N(cov)[m][order]]
    if payload is not None:
        out.append(N(payload)[m][order])
    return key[order], out


@pytest.mark.parametrize("packed", [False, True], ids=["lexsort", "packed"])
@pytest.mark.parametrize("payload_dims", [None, (), (2,)], ids=["no_payload", "payload", "payload2"])
def test_voxel_downsample_with_cov_matches_reference(packed, payload_dims):
    rng = np.random.default_rng(9)
    leaf, thr = 0.5, 2.0
    xyz, cov, mask, payload = _cov_cloud(rng, 400, 1.0, payload_dims)
    j = jvoxel.voxel_downsample_with_cov(
        jnp.asarray(xyz), jnp.asarray(cov), jnp.asarray(mask), leaf, thr,
        None if payload is None else jnp.asarray(payload), packed=packed)
    t = tvoxel.voxel_downsample_with_cov(
        torch.from_numpy(xyz), torch.from_numpy(cov), torch.from_numpy(mask), leaf, thr,
        None if payload is None else torch.from_numpy(payload), packed=packed)
    np.testing.assert_array_equal(N(t[2]), N(j[2]))
    assert 10 < int(N(t[2]).sum()) < 400
    jk, jv = _by_key(j[0], j[1], j[2], j[3], leaf)
    tk, tv = _by_key(t[0], t[1], t[2], t[3], leaf)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_allclose(tv[0], jv[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv[1], jv[1], rtol=0, atol=1e-6 * np.abs(jv[1]).max())
    if payload is not None:
        np.testing.assert_array_equal(tv[2], jv[2])
    # the gate dropped something: some voxels hold only over-threshold points
    tr = np.trace(cov, axis1=1, axis2=2)
    assert (mask & (tr >= thr)).any()
