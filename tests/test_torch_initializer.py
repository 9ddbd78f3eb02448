"""Port vs JAX package: odometry/initializer (hand-eye extrinsic init).

Motion pairs are drawn with numpy from a seed (A_k in the reference lidar's
frame, B_k = X⁻¹ A_k X, optionally perturbed), made into poses by the JAX
package and carried across as numpy, so both sides fill their buffers from
the same pairs. Quaternions agree to 1e-5 up to sign (the smallest singular
vector's sign is free; both fix it by q[0] >= 0, which leaves q[0] == 0
undecided), translations to 1e-4 m, and the ``converged`` flags are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mloam_tpu.core import rotations as jrot
from mloam_tpu.core import se3 as jse3
from mloam_tpu.odometry import initializer as JI
from mloam_tpu_torch.core import rotations as trot
from mloam_tpu_torch.odometry import initializer as TI
from mloam_tpu_torch.utils import convert

Q_TOL, T_TOL = 1e-5, 1e-4
X_FULL = np.array([0.5, -0.3, 0.2, 0.3, -0.2, 0.9], np.float32)
X_PLANAR = np.array([0.5, -0.3, 0.0, 0.0, 0.0, 0.9], np.float32)


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def tpose(p):
    return convert.pose_from_numpy(jax.tree.map(np.asarray, p))


def pairs(seed, X, n=60, rot_scale=0.2, noise=0.0, axes="all"):
    """[(A, B)] JAX poses from numpy draws."""
    rng = np.random.default_rng(seed)
    Xp = jse3.exp(jnp.asarray(X))
    out = []
    for _ in range(n):
        phi = (rot_scale * rng.standard_normal(3)).astype(np.float32)
        if axes == "yaw_only":
            phi[:2] = 0.0
        xi = np.concatenate([0.3 * rng.standard_normal(3), phi]).astype(np.float32)
        A = jse3.exp(jnp.asarray(xi))
        B = jse3.compose(jse3.compose(jse3.inverse(Xp), A), Xp)
        if noise > 0:
            B = jse3.boxplus(B, jnp.asarray(
                (noise * rng.standard_normal(6)).astype(np.float32)))
        out.append((A, B))
    return Xp, out


def both_buffers(prs, cap=128):
    jb, tb = JI.MotionBuffer.empty(cap), TI.MotionBuffer.empty(cap)
    for A, B in prs:
        jb = JI.add_pair(jb, A, B)
        tb = TI.add_pair(tb, tpose(A), tpose(B))
    return jb, tb


def assert_quat_close(a, b, tol=Q_TOL):
    a, b = N(a), N(b)
    assert min(np.abs(a - b).max(), np.abs(a + b).max()) < tol, (a, b)


def assert_buffers_equal(tb, jb):
    for f in ("mask", "head"):
        np.testing.assert_array_equal(N(getattr(tb, f)), N(getattr(jb, f)))
    for f in ("ref_q", "ref_t", "tgt_q", "tgt_t"):
        np.testing.assert_array_equal(N(getattr(tb, f)), N(getattr(jb, f)))


def test_quaternion_matrices_match_reference():
    q = np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32)
    np.testing.assert_array_equal(N(TI.quat_left_matrix(torch.from_numpy(q))),
                                  N(JI.quat_left_matrix(jnp.asarray(q))))
    np.testing.assert_array_equal(N(TI.quat_right_matrix(torch.from_numpy(q))),
                                  N(JI.quat_right_matrix(jnp.asarray(q))))
    # L(a) b = a ⊗ b = R(b) a
    a, b = torch.from_numpy(q[0]), torch.from_numpy(q[1])
    ab = trot.quat_multiply(a, b)
    torch.testing.assert_close(TI.quat_left_matrix(a) @ b, ab)
    torch.testing.assert_close(TI.quat_right_matrix(b) @ a, ab)


@pytest.mark.parametrize("case", ["exact", "noisy"])
def test_calibrate_recovers_the_extrinsic_as_the_reference_does(case):
    seed, n, noise = (0, 60, 0.0) if case == "exact" else (1, 100, 0.005)
    Xp, prs = pairs(seed, X_FULL, n=n, noise=noise)
    jb, tb = both_buffers(prs)
    assert_buffers_equal(tb, jb)
    jest, jr = JI.calibrate(jb)
    test, tr = TI.calibrate(tb)
    assert bool(tr.converged) == bool(jr.converged) is True
    assert_quat_close(tr.q_ext, jr.q_ext)
    assert_quat_close(test.q, jest.q)
    np.testing.assert_allclose(N(test.t), N(jest.t), atol=T_TOL)
    np.testing.assert_allclose(float(tr.sigma2), float(jr.sigma2), rtol=1e-4)
    err = float(np.linalg.norm(N(jse3.boxminus(
        jse3.Pose(jnp.asarray(N(test.q)), jnp.asarray(N(test.t))), Xp))))
    assert err < (1e-3 if case == "exact" else 0.05)


def test_yaw_only_motion_does_not_converge_on_either_side():
    _, prs = pairs(2, X_PLANAR, axes="yaw_only")
    jb, tb = both_buffers(prs)
    _, jr = JI.calibrate(jb)
    _, tr = TI.calibrate(tb)
    assert bool(tr.converged) == bool(jr.converged) is False
    # roll and pitch of the extrinsic are unobservable: sigma2 ~ 0 on both
    assert float(tr.sigma2) < 1e-3 and float(jr.sigma2) < 1e-3


def test_planar_variant_matches_reference():
    Xp, prs = pairs(3, X_PLANAR, axes="yaw_only")
    jb, tb = both_buffers(prs)
    jest, _ = JI.calibrate(jb, planar=True)
    test, _ = TI.calibrate(tb, planar=True)
    # the rotation solve leaves the yaw free (its null space is 2-dim), the
    # planar step fixes it: the final pose is determined
    np.testing.assert_allclose(N(test.t), N(jest.t), atol=T_TOL)
    assert float(test.t[2]) == 0.0
    assert_quat_close(test.q, jest.q)
    yaw = float(trot.so3_log(test.q)[2])
    np.testing.assert_allclose(yaw, float(jrot.so3_log(Xp.q)[2]), atol=0.02)
    np.testing.assert_allclose(N(test.t[:2]), N(Xp.t[:2]), atol=0.02)


def test_translation_solves_match_reference_on_a_given_rotation():
    Xp, prs = pairs(4, X_FULL, noise=0.002)
    jb, tb = both_buffers(prs)
    q = Xp.q
    np.testing.assert_allclose(N(TI.solve_translation(tb, torch.from_numpy(N(q)))),
                               N(JI.solve_translation(jb, q)), atol=T_TOL)
    jt, jq = JI.solve_translation_planar(jb, q)
    tt, tq = TI.solve_translation_planar(tb, torch.from_numpy(N(q)))
    np.testing.assert_allclose(N(tt), N(jt), atol=T_TOL)
    assert_quat_close(tq, jq)


def test_screw_filter_rejects_inconsistent_pairs_as_the_reference_does():
    A = jse3.exp(jnp.array([0.3, 0, 0, 0.2, 0, 0]))
    B_bad = jse3.exp(jnp.array([0.3, 0, 0, 0.5, 0, 0]))  # wrong angle
    B_far = jse3.exp(jnp.array([0.9, 0, 0, 0.2, 0, 0]))  # wrong screw shift
    X = jse3.exp(jnp.array([0.1, 0.2, 0.3, 0.1, 0.2, 0.3]))
    B_good = jse3.compose(jse3.compose(jse3.inverse(X), A), X)
    for B, want in ((B_bad, False), (B_far, False), (B_good, True)):
        assert bool(JI.screw_consistent(A, B)) is want
        assert bool(TI.screw_consistent(tpose(A), tpose(B))) is want
    # a rejected pair leaves the buffer as it was
    jb, tb = both_buffers([(A, B_bad), (A, B_good), (A, B_far)], cap=8)
    assert_buffers_equal(tb, jb)
    assert int(tb.head) == 1 and int(tb.mask.sum()) == 1


def test_buffer_ring_overwrite_matches_reference():
    rng = np.random.default_rng(5)
    prs = []
    for _ in range(6):
        xi = np.concatenate([0.1 * rng.standard_normal(3), [0.3, 0, 0]]).astype(np.float32)
        A = jse3.exp(jnp.asarray(xi))
        prs.append((A, A))
    jb, tb = both_buffers(prs, cap=4)
    assert_buffers_equal(tb, jb)
    assert int(tb.head) == 6 and bool(tb.mask.all())
    # slots 0 and 1 hold the fifth and sixth pairs
    np.testing.assert_array_equal(N(tb.ref_t[:2]), np.stack([N(prs[4][0].t), N(prs[5][0].t)]))
    # carried across, a JAX buffer is the same buffer
    cb = convert.motion_buffer_from_numpy(jax.tree.map(np.asarray, jb))
    assert_buffers_equal(cb, jb)
