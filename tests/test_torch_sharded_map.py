"""The keyframe-sharded surround map, port vs JAX package.

The JAX package's own fixture (``tests/test_parallel.py:108``): a 16-slot
keyframe ring with 12 keyframes of 64 points 3 m apart, a 4-shard ``map``
mesh (JAX: 4 of the 8 virtual devices; port: a stacked mesh), the query at
(10, 0, 0) within 10 m, 4 keyframes a shard. The port's gathered cloud, its
per-point covariances and its mask equal the JAX package's slot by slot (1e-5
m; covariances 1e-6 of their largest entry), and the masked points are the
single-device truth as a point set (1e-4 m). On a 2x2 (host, map) mesh the
port gathers the same cloud, slot by slot, as on the 1-D mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mloam_tpu.core import se3 as jse3
from mloam_tpu.core.se3 import Pose as JPose
from mloam_tpu.frontend.features import FeatCloud as JFeatCloud
from mloam_tpu.mapping import keyframes as JKF
from mloam_tpu.parallel import mesh as JM
from mloam_tpu.parallel import sharded_map as JSMAP
from mloam_tpu_torch.parallel import mesh as M
from mloam_tpu_torch.parallel import sharded_map as SMAP
from mloam_tpu_torch.utils import convert


def jax_db():
    key = jax.random.PRNGKey(0)
    db = JKF.empty_db(16, 64, 64)
    for i in range(12):
        pose = JPose(jnp.array([1.0, 0, 0, 0]), jnp.array([float(i) * 3.0, 0.0, 0.0]))
        pts = jax.random.normal(jax.random.fold_in(key, i), (64, 3))
        fc = JFeatCloud(xyz=pts, mask=jnp.ones(64, bool), time=jnp.zeros(64),
                        ring=jnp.zeros(64, jnp.int32))
        db = JKF.insert(db, pose, 1e-4 * jnp.eye(6), fc, fc)
    return db


def test_sharded_surround_map_matches_jax_and_the_single_device_set():
    db = jax_db()
    center = jnp.array([10.0, 0.0, 0.0])
    ext_cov = 1e-5 * jnp.eye(6)
    cov_meas = 1e-4 * jnp.eye(3)
    jmesh = JM.make_mesh(4, axis="map")
    jx, jc, jm = JSMAP.sharded_surround_map(JSMAP.shard_db(db, jmesh), center, radius=10.0,
                                            m_per_shard=4, ext_cov=ext_cov,
                                            cov_meas=cov_meas, mesh=jmesh)
    mesh = M.make_mesh(4, axis=M.MAP_AXIS, device="cpu")
    tdb = convert.keyframe_db_from_numpy(jax.tree.map(np.asarray, db))
    x, c, m = SMAP.sharded_surround_map(
        SMAP.shard_db(tdb, mesh), torch.tensor([10.0, 0.0, 0.0]), radius=10.0,
        m_per_shard=4, ext_cov=torch.from_numpy(np.array(ext_cov)),
        cov_meas=torch.from_numpy(np.array(cov_meas)), mesh=mesh)
    assert x.shape == jx.shape and c.shape == jc.shape
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-5)
    scale = float(np.abs(np.asarray(jc)).max())
    np.testing.assert_allclose(c.numpy() / scale, np.asarray(jc) / scale, rtol=0, atol=1e-6)
    assert mesh.collectives["all_gather:map"]["calls"] == 3

    # the single-device truth: every keyframe within the radius, projected
    d = np.linalg.norm(np.asarray(db.poses.t) - np.asarray(center), axis=1)
    want = np.concatenate([
        np.asarray(jse3.transform_points(JPose(db.poses.q[k], db.poses.t[k]), db.surf.xyz[k]))
        for k in np.nonzero((d < 10.0) & np.asarray(db.valid))[0]])
    got = x.numpy()[m.numpy()]
    assert got.shape == want.shape
    np.testing.assert_allclose(got[np.lexsort(got.T)], want[np.lexsort(want.T)], atol=1e-4)


def test_two_level_mesh_gathers_the_same_cloud():
    tdb = convert.keyframe_db_from_numpy(jax.tree.map(np.asarray, jax_db()))
    outs = []
    for mesh in (M.make_mesh(4, axis=M.MAP_AXIS, device="cpu"),
                 M.make_multihost_mesh(2, 2, inner_axis=M.MAP_AXIS, device="cpu")):
        sh = SMAP.shard_db(tdb, mesh)
        assert sh.valid.shape == mesh.local_shape + (4,) and sh.head.ndim == 0
        outs.append(SMAP.sharded_surround_map(sh, torch.tensor([10.0, 0.0, 0.0]), 10.0, 4,
                                              torch.zeros(6, 6), 1e-4 * torch.eye(3), mesh))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
