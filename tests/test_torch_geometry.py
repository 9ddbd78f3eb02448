"""Port vs JAX package: core/rotations and core/se3, function by function.

Inputs come from a numpy seed and go through both sides. Tolerance 2e-6
absolute plus 1e-6 relative (one f32 ulp of the larger coordinates), looser
where stated for chained transcendental functions:
both sides run the same f32 formulas, differences are last-ulp differences of
sin/cos/atan2/sqrt between XLA-CPU and PyTorch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mloam_tpu.core import rotations as jrot
from mloam_tpu.core import se3 as jse3
from mloam_tpu_torch.core import rotations as trot
from mloam_tpu_torch.core import se3 as tse3

ATOL = 2e-6


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[0] = [1, 0, 0, 0]                       # identity
    q[1] = [1e-4, 1.0, 0, 0]                  # near pi
    q[1] /= np.linalg.norm(q[1])
    q[2] = [1.0, 1e-7, 0, 0]                  # near identity
    q[2] /= np.linalg.norm(q[2])
    return q


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=1e-6)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    n = 64
    phi = (rng.normal(size=(n, 3)) * 0.8).astype(np.float32)
    phi[0] = 0.0
    phi[1] = [np.pi - 1e-3, 0, 0]
    phi[2] = [1e-5, -1e-5, 2e-5]
    return dict(
        qa=_quats(rng, n), qb=_quats(rng, n)[::-1].copy(),
        v=rng.normal(size=(n, 3)).astype(np.float32) * 10,
        ta=rng.normal(size=(n, 3)).astype(np.float32) * 5,
        tb=rng.normal(size=(n, 3)).astype(np.float32) * 5,
        phi=phi, xi=np.concatenate([phi[::-1] * 2, phi], -1).astype(np.float32),
        s=rng.uniform(0, 1, size=(n,)).astype(np.float32),
    )


ROT_CASES = [
    ("quat_normalize", ("qa",)), ("quat_conjugate", ("qa",)),
    ("quat_multiply", ("qa", "qb")), ("quat_rotate", ("qa", "v")),
    ("quat_to_matrix", ("qa",)), ("skew", ("v",)),
    ("so3_exp_quat", ("phi",)), ("so3_log", ("qa",)),
    ("so3_exp_matrix", ("phi",)), ("quat_slerp", ("qa", "qb", "s")),
    ("so3_left_jacobian", ("phi",)), ("so3_left_jacobian_inv", ("phi",)),
]


@pytest.mark.parametrize("name,args", ROT_CASES, ids=[c[0] for c in ROT_CASES])
def test_rotation_function(data, name, args):
    a = [data[k] for k in args]
    t = getattr(trot, name)(*[torch.from_numpy(x) for x in a])
    j = getattr(jrot, name)(*[jnp.asarray(x) for x in a])
    # the inverse left Jacobian near pi divides by sin(theta/2)^2 ~ 1: fine;
    # slerp chains log and exp
    _close(t, j, atol=1e-5 if name in ("quat_slerp", "so3_left_jacobian_inv") else ATOL)


def test_matrix_to_quat_roundtrip(data):
    R = np.asarray(jrot.quat_to_matrix(jnp.asarray(data["qa"])))
    _close(trot.matrix_to_quat(torch.from_numpy(R)), jrot.matrix_to_quat(jnp.asarray(R)), 1e-5)


def _poses(data):
    ta = tse3.Pose(torch.from_numpy(data["qa"]), torch.from_numpy(data["ta"]))
    tb = tse3.Pose(torch.from_numpy(data["qb"]), torch.from_numpy(data["tb"]))
    ja = jse3.Pose(jnp.asarray(data["qa"]), jnp.asarray(data["ta"]))
    jb = jse3.Pose(jnp.asarray(data["qb"]), jnp.asarray(data["tb"]))
    return ta, tb, ja, jb


SE3_POSE_FNS = ["compose", "relative"]


@pytest.mark.parametrize("name", SE3_POSE_FNS)
def test_se3_binary(data, name):
    ta, tb, ja, jb = _poses(data)
    t, j = getattr(tse3, name)(ta, tb), getattr(jse3, name)(ja, jb)
    _close(t.q, j.q, 1e-6)
    _close(t.t, j.t, 2e-5)   # translations up to ~20 m: 1 ulp is 2e-6


def test_se3_inverse_matrix_adjoint(data):
    ta, _, ja, _ = _poses(data)
    ti, ji = tse3.inverse(ta), jse3.inverse(ja)
    _close(ti.q, ji.q)
    _close(ti.t, ji.t, 1e-5)
    _close(ta.matrix(), ja.matrix(), 1e-6)
    _close(tse3.adjoint(ta), jse3.adjoint(ja), 1e-5)
    f = tse3.from_matrix(ta.matrix())
    g = jse3.from_matrix(ja.matrix())
    _close(f.q, g.q, 1e-5)


def test_se3_exp_log_boxplus_boxminus(data):
    ta, tb, ja, jb = _poses(data)
    xi_t, xi_j = torch.from_numpy(data["xi"]), jnp.asarray(data["xi"])
    e_t, e_j = tse3.exp(xi_t), jse3.exp(xi_j)
    _close(e_t.q, e_j.q)
    _close(e_t.t, e_j.t, 1e-5)
    _close(tse3.log(e_t), jse3.log(e_j), 1e-5)
    bp_t, bp_j = tse3.boxplus(ta, xi_t), jse3.boxplus(ja, xi_j)
    _close(bp_t.q, bp_j.q, 1e-6)
    _close(bp_t.t, bp_j.t, 2e-5)
    _close(tse3.boxminus(ta, tb), jse3.boxminus(ja, jb), 1e-4)


def test_se3_transform_interpolate_scale(data):
    ta, tb, ja, jb = _poses(data)
    pts = np.random.default_rng(1).normal(size=(64, 7, 3)).astype(np.float32) * 10
    _close(tse3.transform_points(ta, torch.from_numpy(pts)),
           jse3.transform_points(ja, jnp.asarray(pts)), 2e-5)
    s_t, s_j = torch.from_numpy(data["s"]), jnp.asarray(data["s"])
    it, ij = tse3.interpolate(ta, tb, s_t), jse3.interpolate(ja, jb, s_j)
    _close(it.q, ij.q, 1e-5)
    _close(it.t, ij.t, 1e-5)
    st, sj = tse3.scale(ta, s_t), jse3.scale(ja, s_j)
    _close(st.q, sj.q, 1e-5)
    _close(st.t, sj.t, 1e-5)


def test_mean_pose_and_scatter(data):
    rng = np.random.default_rng(2)
    base = jse3.Pose(jnp.asarray(data["qa"][5]), jnp.asarray(data["ta"][5]))
    xi = (rng.normal(size=(12, 6)) * 0.05).astype(np.float32)
    jp = jax.vmap(lambda x: jse3.boxplus(base, x))(jnp.asarray(xi))
    tp = tse3.Pose(torch.from_numpy(np.asarray(jp.q)), torch.from_numpy(np.asarray(jp.t)))
    w = rng.uniform(0.5, 1.5, size=(12,)).astype(np.float32)
    mt, mj = tse3.mean_pose(tp, torch.from_numpy(w)), jse3.mean_pose(jp, jnp.asarray(w))
    _close(mt.q, mj.q, 1e-5)
    _close(mt.t, mj.t, 1e-5)
    _close(tse3.tangent_scatter(tp, mt), jse3.tangent_scatter(jp, mj), 1e-5)


def test_logs_are_ad_safe_at_identity():
    """Forward- and reverse-mode derivatives of so3_log / se3.log are finite
    at the identity and agree with the JAX package's."""
    q0 = torch.tensor([1.0, 0.0, 0.0, 0.0])
    Jt = torch.func.jacfwd(trot.so3_log)(q0)
    Jr = torch.func.jacrev(trot.so3_log)(q0)
    Jj = jax.jacfwd(jrot.so3_log)(jnp.array([1.0, 0.0, 0.0, 0.0]))
    assert torch.isfinite(Jt).all() and torch.isfinite(Jr).all()
    _close(Jt, Jj)
    _close(Jr, Jj)

    def f_t(xi):
        return tse3.log(tse3.boxplus(tse3.Pose.identity(), xi))

    def f_j(xi):
        return jse3.log(jse3.boxplus(jse3.Pose.identity(), xi))

    Jt = torch.func.jacfwd(f_t)(torch.zeros(6))
    _close(Jt, jax.jacfwd(f_j)(jnp.zeros(6)))
    _close(Jt, np.eye(6, dtype=np.float32))


# ------------------------------------------------------------ range images

def test_hdl64_ring_table_matches_reference():
    from mloam_tpu.core import rangeimage as JRI
    from mloam_tpu_torch.core import rangeimage as TRI

    table = TRI.hdl64_ring_table()
    assert table == JRI.hdl64_ring_table()
    assert len(table) == 64 and list(table) == sorted(table)
    assert table[0] == pytest.approx(-24.33) and table[-1] == 2.0


def _cloud(rng, n=6000):
    """Points in every direction at 0.1-120 m (some out of range, some
    outside the vertical field of view), a masked tenth, and exact duplicates
    with other intensities (range ties inside one cell)."""
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] *= 0.25
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    xyz = d * rng.uniform(0.1, 120.0, size=(n, 1)).astype(np.float32)
    dup = rng.integers(0, n, size=n // 10)
    xyz = np.concatenate([xyz, xyz[dup]]).astype(np.float32)
    mask = rng.random(xyz.shape[0]) > 0.1
    inten = rng.random(xyz.shape[0]).astype(np.float32)
    return xyz, mask, inten


@pytest.mark.parametrize("sensor", ["sim16", "hdl32", "hdl64_table", "small_8x360"])
def test_project_matches_reference(sensor):
    """Scatter-min on range, then on the index among equal ranges: the same
    winner in every cell on both sides (so the gathered payloads are equal
    bit for bit), exact ties to the lowest index."""
    from mloam_tpu.core import rangeimage as JRI
    from mloam_tpu.models import platforms as jplat
    from mloam_tpu_torch.core import rangeimage as TRI
    from mloam_tpu_torch.models import platforms as tplat

    jm, tm = {
        "sim16": (jplat.SIM16, tplat.SIM16),
        "hdl32": (jplat.HDL32, tplat.HDL32),
        "hdl64_table": (jplat.kitti().rig.models[0], tplat.kitti().rig.models[0]),
        "small_8x360": (JRI.LidarModel(n_rings=8, n_cols=360),
                        TRI.LidarModel(n_rings=8, n_cols=360)),
    }[sensor]
    assert tuple(jm) == tuple(tm)
    xyz, mask, inten = _cloud(np.random.default_rng(7))
    j = JRI.project(jnp.asarray(xyz), jnp.asarray(mask), jm, jnp.asarray(inten))
    t = TRI.project(torch.from_numpy(xyz), torch.from_numpy(mask), tm,
                    torch.from_numpy(inten))
    assert t.valid.shape == (tm.n_rings, tm.n_cols)
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    assert 200 < int(t.valid.sum()) < mask.sum()
    for a, b in ((t.rng, j.rng), (t.xyz, j.xyz), (t.intensity, j.intensity)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(t.time.numpy(), np.asarray(j.time), atol=1e-7)


def test_project_ties_go_to_the_lowest_index():
    from mloam_tpu_torch.core import rangeimage as TRI

    m = TRI.LidarModel(n_rings=4, n_cols=36)
    p = np.array([[5.0, 0.1, 0.0]], np.float32)
    xyz = torch.from_numpy(np.repeat(p, 4, 0))
    xyz[0] *= 1.5                                # farther: loses to all
    inten = torch.tensor([0.9, 0.2, 0.3, 0.4])
    mask = torch.tensor([True, False, True, True])  # the lowest tie is masked
    img = TRI.project(xyz, mask, m, inten)
    assert int(img.valid.sum()) == 1
    assert float(img.intensity[img.valid]) == pytest.approx(0.3)
    assert float(img.rng[img.valid]) == pytest.approx(float(np.linalg.norm(p)))
