"""SE(3) covariance algebra and the cloud schema, port vs JAX package.

Seeded numpy poses and PSD covariances go through both sides; each result is
held within 1e-5 of its largest entry (f32 on both sides, different
summation orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mloam_tpu.core import cloud as jcloud
from mloam_tpu.core import uncertainty as ju
from mloam_tpu.core.se3 import Pose as JPose
from mloam_tpu_torch.core import cloud as tcloud
from mloam_tpu_torch.core import se3 as tse3
from mloam_tpu_torch.core import uncertainty as tu
from mloam_tpu_torch.core.se3 import Pose as TPose

RTOL = 1e-5


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(a, b, rtol=RTOL):
    a, b = N(a), N(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * max(np.abs(b).max(), 1e-30))


def poses(rng, n):
    """n random poses as numpy (q [n,4] unit, t [n,3])."""
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.normal(scale=5.0, size=(n, 3)).astype(np.float32)
    return q, t


def psd(rng, n, d, scale):
    a = rng.normal(size=(n, d, d)).astype(np.float32)
    return (scale * a @ a.transpose(0, 2, 1) / d).astype(np.float32)


def both(q, t):
    return JPose(jnp.asarray(q), jnp.asarray(t)), TPose(torch.from_numpy(q), torch.from_numpy(t))


def test_adjoint_layout_is_rho_then_phi():
    """The covariance blocks assume se3.adjoint = [[R, [t]x R], [0, R]]."""
    rng = np.random.default_rng(0)
    q, t = poses(rng, 1)
    ad = N(tse3.adjoint(TPose(torch.from_numpy(q[0]), torch.from_numpy(t[0]))))
    R = N(tse3.Pose(torch.from_numpy(q[0]), torch.from_numpy(t[0])).matrix())[:3, :3]
    np.testing.assert_allclose(ad[:3, :3], R, atol=1e-6)
    np.testing.assert_allclose(ad[3:, 3:], R, atol=1e-6)
    np.testing.assert_allclose(ad[3:, :3], 0.0)


@pytest.mark.parametrize("fourth_order", [False, True], ids=["second", "fourth"])
def test_compound_pose_cov(fourth_order):
    rng = np.random.default_rng(1 + fourth_order)
    q1, t1 = poses(rng, 16)
    q2, t2 = poses(rng, 16)
    c1, c2 = psd(rng, 16, 6, 1e-2), psd(rng, 16, 6, 1e-2)
    jp1, tp1 = both(q1, t1)
    jp2, tp2 = both(q2, t2)
    jpose, jcov = ju.compound_pose_cov(jp1, jnp.asarray(c1), jp2, jnp.asarray(c2),
                                       fourth_order=fourth_order)
    tpose, tcov = tu.compound_pose_cov(tp1, torch.from_numpy(c1), tp2,
                                       torch.from_numpy(c2), fourth_order=fourth_order)
    close(tpose.t, jpose.t)
    close(tpose.q, jpose.q)
    for i in range(16):
        close(tcov[i], jcov[i])
    assert np.allclose(N(tcov), N(tcov).transpose(0, 2, 1), atol=1e-6)


def test_fourth_order_terms_are_not_zero():
    """The 4th-order correction changes the result at these covariances (so
    the comparison above is not a second-order one twice)."""
    rng = np.random.default_rng(3)
    q, t = poses(rng, 2)
    c = psd(rng, 2, 6, 0.1)
    _, tp = both(q, t)
    p1, p2 = TPose(tp.q[0], tp.t[0]), TPose(tp.q[1], tp.t[1])
    _, a = tu.compound_pose_cov(p1, torch.from_numpy(c[0]), p2, torch.from_numpy(c[1]), False)
    _, b = tu.compound_pose_cov(p1, torch.from_numpy(c[0]), p2, torch.from_numpy(c[1]), True)
    assert float((a - b).abs().max()) > 1e-4


@pytest.mark.parametrize("with_points", [False, True], ids=["meas", "meas_and_points"])
def test_point_cov_pushforward(with_points):
    rng = np.random.default_rng(4)
    q, t = poses(rng, 1)
    cov_pose = psd(rng, 1, 6, 1e-3)[0]
    cov_meas = psd(rng, 1, 3, 1e-4)[0]
    pts = rng.normal(scale=20.0, size=(300, 3)).astype(np.float32)
    cp = psd(rng, 300, 3, 1e-3) if with_points else None
    jpose, tpose = both(q[0], t[0])
    j = ju.point_cov_pushforward(jnp.asarray(pts), jpose, jnp.asarray(cov_pose),
                                 jnp.asarray(cov_meas),
                                 None if cp is None else jnp.asarray(cp))
    tt = tu.point_cov_pushforward(torch.from_numpy(pts), tpose, torch.from_numpy(cov_pose),
                                  torch.from_numpy(cov_meas),
                                  None if cp is None else torch.from_numpy(cp))
    assert tt.shape == (300, 3, 3)
    close(tt, j)
    assert (np.linalg.eigvalsh(N(tt)) > -1e-6).all()


def test_point_cov_pushforward_batched_over_poses():
    """The mapper pushes every surround keyframe's cloud through its own pose
    in one call: a leading batch equals the per-pose calls."""
    rng = np.random.default_rng(5)
    q, t = poses(rng, 3)
    cov_pose = psd(rng, 3, 6, 1e-3)
    pts = rng.normal(scale=10.0, size=(3, 50, 3)).astype(np.float32)
    cov_meas = torch.eye(3) * 1e-4
    _, tp = both(q, t)
    batched = tu.point_cov_pushforward(torch.from_numpy(pts), tp,
                                       torch.from_numpy(cov_pose), cov_meas)
    for i in range(3):
        one = tu.point_cov_pushforward(torch.from_numpy(pts[i]), TPose(tp.q[i], tp.t[i]),
                                       torch.from_numpy(cov_pose[i]), cov_meas)
        close(batched[i], one, 1e-6)


def test_cloud_schema_and_functions():
    rng = np.random.default_rng(6)
    xyz = rng.normal(scale=10.0, size=(40, 3)).astype(np.float32)
    mask = rng.random(40) < 0.7
    attr = rng.random(40).astype(np.float32)
    q, t = poses(rng, 1)
    jpose, tpose = both(q[0], t[0])
    jc = jcloud.Cloud(jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(attr))
    tc = tcloud.Cloud(torch.from_numpy(xyz), torch.from_numpy(mask), torch.from_numpy(attr))
    close(tcloud.transform_cloud(tpose, tc).xyz, jcloud.transform_cloud(jpose, jc).xyz)
    m = tcloud.merge_clouds(tc, tc)
    jm = jcloud.merge_clouds(jc, jc)
    for a, b in zip(m, jm):
        np.testing.assert_array_equal(N(a), N(b))
    # de-skew by a small sweep motion, per-point fractions in [0, 1)
    mq = np.array([0.999, 0.01, -0.02, 0.03], np.float32)
    mq /= np.linalg.norm(mq)
    mt = np.array([0.5, -0.1, 0.02], np.float32)
    jm_, tm_ = both(mq, mt)
    close(tcloud.deskew(tc.xyz, tc.attr, tm_), jcloud.deskew(jc.xyz, jc.attr, jm_))
    assert tcloud.Cloud.zeros(5).capacity == 5
    z = tcloud.CovCloud.zeros(4)
    jz = jcloud.CovCloud.zeros(4)
    assert [tuple(x.shape) for x in z] == [tuple(x.shape) for x in jz]
    assert z.mask.dtype == torch.bool
