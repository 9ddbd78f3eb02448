"""Port vs JAX package: solver/robust, factors, gauss_newton, degeneracy,
marginalization.

Inputs come from a numpy seed and go through both sides. Residuals and
Jacobians agree to 1e-5; one linearisation's (H, g) to rtol 1e-4 (sums over
hundreds of f32 rows in different orders); eigen-based results are compared
through sign-invariant quantities (projectors, spectra, |v|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mloam_tpu.core import se3 as jse3
from mloam_tpu.frontend.features import FeatCloud as JFeatCloud
from mloam_tpu.solver import degeneracy as jdeg
from mloam_tpu.solver import factors as jfac
from mloam_tpu.solver import gauss_newton as jgn
from mloam_tpu.solver import marginalization as jmarg
from mloam_tpu.solver import robust as jrob
from mloam_tpu_torch.core import se3 as tse3
from mloam_tpu_torch.frontend.features import FeatCloud
from mloam_tpu_torch.solver import degeneracy as tdeg
from mloam_tpu_torch.solver import factors as tfac
from mloam_tpu_torch.solver import gauss_newton as tgn
from mloam_tpu_torch.solver import marginalization as tmarg
from mloam_tpu_torch.solver import robust as trob


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def both(cls_t, cls_j, *arrays):
    return cls_t(*(T(a) for a in arrays)), cls_j(*(jnp.asarray(a) for a in arrays))


# ------------------------------------------------------------------ robust

@pytest.mark.parametrize("kind", ["trivial", "huber", "gm", "gnc_gm"])
def test_loss_weight(kind):
    s = np.abs(np.random.default_rng(0).normal(size=200)).astype(np.float32) ** 2
    s[:3] = [0.0, 0.01, 1e-24]
    t = trob.loss_weight(T(s), kind, 0.1, gm_c=0.7, gnc_mu=3.0)
    j = jrob.loss_weight(jnp.asarray(s), kind, 0.1, gm_c=0.7, gnc_mu=3.0)
    np.testing.assert_allclose(N(t), N(j), rtol=1e-6)


def test_gnc_schedule():
    ts, js = trob.gnc_mu_schedule(20.0, 9), jrob.gnc_mu_schedule(20.0, 9)
    for i in range(11):
        assert abs(ts(i) - float(js(i))) < 1e-4
    assert trob.gnc_mu_schedule(20.0, 1)(0) == 1.0


# ----------------------------------------------------------------- factors

def _scene(seed=0, n_wall=40):
    """A corner of three walls sampled on 8 rings: structured enough for all
    four matchers to find correspondences."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0, 6, size=(n_wall * 3, 2)).astype(np.float32)
    z = np.zeros(n_wall, np.float32)
    pts = np.concatenate([
        np.stack([u[:n_wall, 0], u[:n_wall, 1], z + 0.0], 1),
        np.stack([u[n_wall:2 * n_wall, 0], z + 6.0, u[n_wall:2 * n_wall, 1] * 0.5], 1),
        np.stack([z + 6.0, u[2 * n_wall:, 0], u[2 * n_wall:, 1] * 0.5], 1),
    ]).astype(np.float32)
    ring = (rng.integers(0, 8, size=pts.shape[0])).astype(np.int32)
    return pts, ring


def _featclouds(xyz, mask, time, ring):
    return both(FeatCloud, JFeatCloud, xyz, mask, time, ring)


def _corr_close(tc, jc, atol=1e-5):
    for name in tc._fields:
        np.testing.assert_allclose(N(getattr(tc, name)), N(getattr(jc, name)),
                                   atol=atol, err_msg=name)


def test_scan_matchers():
    pts, ring = _scene()
    rng = np.random.default_rng(1)
    tgt_t, tgt_j = _featclouds(pts, rng.random(len(pts)) < 0.9,
                               np.zeros(len(pts), np.float32), ring)
    q_xyz = pts[::3] + rng.normal(size=pts[::3].shape).astype(np.float32) * 0.02
    q_t, q_j = _featclouds(q_xyz, rng.random(len(q_xyz)) < 0.9,
                           rng.random(len(q_xyz)).astype(np.float32), ring[::3])
    te = tfac.match_scan_edge(q_t, T(q_xyz), tgt_t, 25.0, 2.5)
    je = jfac.match_scan_edge(q_j, jnp.asarray(q_xyz), tgt_j, 25.0, 2.5)
    assert N(te.w).sum() > 10
    _corr_close(te, je)
    tp = tfac.match_scan_plane(q_t, T(q_xyz), tgt_t, 25.0, 2.5)
    jp = jfac.match_scan_plane(q_j, jnp.asarray(q_xyz), tgt_j, 25.0, 2.5)
    assert N(tp.w).sum() > 10
    _corr_close(tp, jp, atol=2e-4)    # normal of a thin triangle: cross product


def test_map_matchers():
    pts, ring = _scene(2, 300)
    rng = np.random.default_rng(3)
    m = rng.random(len(pts)) < 0.95
    q_xyz = pts[::7] + rng.normal(size=pts[::7].shape).astype(np.float32) * 0.01
    q_t, q_j = _featclouds(q_xyz, np.ones(len(q_xyz), bool),
                           np.zeros(len(q_xyz), np.float32), ring[::7])
    tp = tfac.match_map_plane(q_t, T(q_xyz), T(pts), T(m), 1.0)
    jp = jfac.match_map_plane(q_j, jnp.asarray(q_xyz), jnp.asarray(pts), jnp.asarray(m), 1.0)
    ok = (N(tp.w) > 0) & (N(jp.w) > 0)
    assert ok.sum() > 50 and (N(tp.w) > 0).sum() == (N(jp.w) > 0).sum()
    # plane normals are eigenvectors: sign-free comparison
    dots = np.abs(np.sum(N(tp.normal)[ok] * N(jp.normal)[ok], -1))
    assert dots.min() > 1 - 1e-4
    np.testing.assert_allclose(np.abs(N(tp.d)[ok]), np.abs(N(jp.d)[ok]), atol=1e-3)
    np.testing.assert_allclose(N(tp.w), N(jp.w), atol=1e-3)
    # edges: points along three lines
    t = rng.uniform(0, 5, size=600).astype(np.float32)
    line = np.concatenate([np.stack([t[:200], 0 * t[:200], 0 * t[:200]], 1),
                           np.stack([0 * t[:200] + 6, t[200:400], 0 * t[:200] + 1], 1),
                           np.stack([0 * t[:200] + 2, 0 * t[:200] + 2, t[400:] * 0.5], 1)])
    line = (line + rng.normal(size=line.shape) * 0.003).astype(np.float32)
    ql = line[::5] + 0.01
    q_t, q_j = _featclouds(ql, np.ones(len(ql), bool), np.zeros(len(ql), np.float32),
                           np.zeros(len(ql), np.int32))
    lm = np.ones(len(line), bool)
    te = tfac.match_map_edge(q_t, T(ql), T(line), T(lm), 1.0)
    je = jfac.match_map_edge(q_j, jnp.asarray(ql), jnp.asarray(line), jnp.asarray(lm), 1.0)
    np.testing.assert_array_equal(N(te.w), N(je.w))
    ok = N(te.w) > 0
    assert ok.sum() > 50
    # the line's two points may swap with the eigenvector's sign
    ta, tb, ja, jb = N(te.pa)[ok], N(te.pb)[ok], N(je.pa)[ok], N(je.pb)[ok]
    same = np.abs(ta - ja).max(-1) < 1e-3
    swapped = np.abs(ta - jb).max(-1) < 1e-3
    assert (same | swapped).all()
    np.testing.assert_allclose(tb, np.where(same[:, None], jb, ja), atol=1e-3)


def _random_corrs(n=64, seed=4):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    nrm = f(n, 3)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    w = (rng.random(n) < 0.8).astype(np.float32)
    s = rng.random(n).astype(np.float32)
    plane = both(tfac.PlaneCorr, jfac.PlaneCorr, f(n, 3) * 5, s, nrm, f(n), w)
    edge = both(tfac.EdgeCorr, jfac.EdgeCorr, f(n, 3) * 5, s, f(n, 3) * 5, f(n, 3) * 5, w)
    q = f(n, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return plane, edge, q, f(n, 3) * 5


def test_residuals_and_analytic_jacobians():
    (tp, jp), (te, je), q, pt = _random_corrs()
    np.testing.assert_allclose(N(tfac.plane_residual(T(pt), tp)),
                               N(jfac.plane_residual(jnp.asarray(pt), jp)), atol=1e-5)
    np.testing.assert_allclose(N(tfac.edge_residual(T(pt), te)),
                               N(jfac.edge_residual(jnp.asarray(pt), je)), atol=1e-4)
    np.testing.assert_allclose(N(tfac.plane_point_jacobian(T(q), tp)),
                               N(jfac.plane_point_jacobian(jnp.asarray(q), jp)), atol=1e-5)
    np.testing.assert_allclose(N(tfac.edge_point_jacobian(T(q), te)),
                               N(jfac.edge_point_jacobian(jnp.asarray(q), je)), atol=1e-4)
    # the analytic plane Jacobian is the derivative of the residual through
    # the right perturbation (forward-mode AD on the port's own functions)
    pose = tse3.Pose(T(q[0]), T(pt[0]))
    one = tfac.PlaneCorr(*(x[:1] for x in tp))

    def r_of(dx):
        g = tse3.transform_points(tse3.boxplus(pose, dx), one.p)
        return tfac.plane_residual(g, one)

    J_ad = torch.func.jacfwd(r_of)(torch.zeros(6))
    np.testing.assert_allclose(N(J_ad), N(tfac.plane_point_jacobian(T(q[:1]), one)), atol=1e-4)


def test_transform_deskew_and_prior_residual():
    (tp, jp), _, q, pt = _random_corrs()
    pose_t, pose_j = tse3.Pose(T(q[0]), T(pt[0])), jse3.Pose(jnp.asarray(q[0]), jnp.asarray(pt[0]))
    for deskew in (True, False):
        np.testing.assert_allclose(
            N(tfac.transform_deskew(pose_t, tp.p, tp.s, deskew)),
            N(jfac.transform_deskew(pose_j, jp.p, jp.s, deskew)), atol=2e-5)
    prior_t, prior_j = tse3.Pose(T(q[1]), T(pt[1])), jse3.Pose(jnp.asarray(q[1]), jnp.asarray(pt[1]))
    np.testing.assert_allclose(N(tfac.prior_residual(pose_t, prior_t, 2.0, 3.0)),
                               N(jfac.prior_residual(pose_j, prior_j, 2.0, 3.0)), atol=1e-4)


# ------------------------------------------------------------ gauss-newton

def _icp_problem(seed=5, n=300):
    """Point-to-plane registration of a rigidly moved corner scene."""
    rng = np.random.default_rng(seed)
    pts, _ = _scene(seed, n // 3)
    nrm = np.concatenate([np.tile([0, 0, 1.0], (n // 3, 1)), np.tile([0, 1.0, 0], (n // 3, 1)),
                          np.tile([1.0, 0, 0], (n // 3, 1))]).astype(np.float32)
    d = -np.sum(nrm * pts, -1).astype(np.float32)
    xi = np.array([0.05, -0.03, 0.02, 0.01, -0.02, 0.015], np.float32)
    T_true = jse3.exp(jnp.asarray(xi))
    src = np.asarray(jse3.transform_points(jse3.inverse(T_true), jnp.asarray(pts)))
    src = (src + rng.normal(size=src.shape) * 0.002).astype(np.float32)
    w = np.ones(len(pts), np.float32)
    w[::17] = 0.0
    return both(tfac.PlaneCorr, jfac.PlaneCorr, src, np.zeros(len(pts), np.float32), nrm, d, w), xi


def _gn_fns(corr, se3, fac, cat):
    def residual_fn(Tx):
        r = fac.plane_residual(se3.transform_points(Tx, corr.p), corr)
        return r, fac.robust_weights(r * r, corr.w, "huber", 0.1)

    return residual_fn, (lambda Tx, dx: se3.boxplus(Tx, dx))


def test_linearization_H_g():
    (tc, jc), _ = _icp_problem()
    rf_t, ret_t = _gn_fns(tc, tse3, tfac, torch.cat)
    rf_j, ret_j = _gn_fns(jc, jse3, jfac, jnp.concatenate)
    Ht, gt, ct, _ = tgn._linearize(rf_t, ret_t, tse3.Pose.identity(), 6)
    Hj, gj, cj, _ = jgn._linearize(rf_j, ret_j, jse3.Pose.identity(), 6)
    scale = np.abs(N(Hj)).max()
    np.testing.assert_allclose(N(Ht), N(Hj), rtol=1e-4, atol=1e-4 * scale)
    np.testing.assert_allclose(N(gt), N(gj), rtol=1e-4, atol=1e-4 * np.abs(N(gj)).max())
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-4)


@pytest.mark.parametrize("remap", [None, 0.0, 1e9])
def test_gauss_newton_converges_like_reference(remap):
    (tc, jc), xi = _icp_problem()
    rf_t, ret_t = _gn_fns(tc, tse3, tfac, torch.cat)
    rf_j, ret_j = _gn_fns(jc, jse3, jfac, jnp.concatenate)
    st_t = tgn.gauss_newton(rf_t, tse3.Pose.identity(), ret_t, 6, 5, remap_threshold=remap)
    st_j = jgn.gauss_newton(rf_j, jse3.Pose.identity(), ret_j, 6, 5, remap_threshold=remap)
    np.testing.assert_allclose(N(st_t.x.q), N(st_j.x.q), atol=1e-5)
    np.testing.assert_allclose(N(st_t.x.t), N(st_j.x.t), atol=1e-4)
    np.testing.assert_allclose(float(st_t.cost), float(st_j.cost), rtol=1e-2, atol=1e-6)
    np.testing.assert_allclose(N(st_t.eig0), N(st_j.eig0), rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(N(st_t.frozen), N(st_j.frozen), atol=1e-4)
    if remap is None:
        got = N(tse3.log(st_t.x))
        np.testing.assert_allclose(got, xi, atol=2e-3)
    if remap == 1e9:   # everything below threshold: max_freeze=1 freezes one
        assert abs(float(st_t.frozen[0]) - 1.0) < 1e-4


def test_gauss_newton_quad_prior_hook_and_init_linearization():
    (tc, jc), _ = _icp_problem(6)
    rf_t, ret_t = _gn_fns(tc, tse3, tfac, torch.cat)
    rf_j, ret_j = _gn_fns(jc, jse3, jfac, jnp.concatenate)
    rng = np.random.default_rng(0)
    a = rng.normal(size=(6, 6)).astype(np.float32)
    Hp, b = (a @ a.T * 50).astype(np.float32), rng.normal(size=6).astype(np.float32)
    qp_t = tmarg.QuadPrior(T(Hp), T(b), torch.tensor(True))
    qp_j = jmarg.QuadPrior(jnp.asarray(Hp), jnp.asarray(b), jnp.asarray(True))
    dfn_t = lambda x: tse3.boxminus(x, tse3.Pose.identity())
    dfn_j = lambda x: jse3.boxminus(x, jse3.Pose.identity())
    calls = []

    def hook(i, st):
        calls.append(int(i))
        return st

    lin = tgn._linearize(rf_t, ret_t, tse3.Pose.identity(), 6, (dfn_t, qp_t))
    st_t = tgn.gauss_newton(rf_t, tse3.Pose.identity(), ret_t, 6, 3,
                            quad_prior=(dfn_t, qp_t), iteration_hook=hook,
                            init_linearization=lin,
                            remap_P=torch.eye(6)[None])
    st_j = jgn.gauss_newton(rf_j, jse3.Pose.identity(), ret_j, 6, 3,
                            quad_prior=(dfn_j, qp_j), remap_P=jnp.eye(6)[None])
    assert calls == [0, 1, 2]
    np.testing.assert_allclose(N(st_t.x.t), N(st_j.x.t), atol=1e-4)
    np.testing.assert_allclose(N(st_t.H), N(st_j.H), rtol=1e-3, atol=1e-3 * np.abs(N(st_j.H)).max())


def test_solve_normal_rejects_indefinite_without_raising():
    H = torch.diag(torch.tensor([1.0, -5.0, 2.0]))
    dx = tgn.solve_normal(H, torch.ones(3), torch.tensor(1e-4))
    assert torch.isnan(dx).all()
    Hj = jnp.diag(jnp.array([1.0, -5.0, 2.0]))
    assert np.isnan(N(jgn.solve_normal(Hj, jnp.ones(3), 1e-4))).any()
    Hpd = np.diag([4.0, 2.0, 1.0]).astype(np.float32) + 0.1
    np.testing.assert_allclose(
        N(tgn.solve_normal(T(Hpd), torch.ones(3), torch.tensor(1e-4))),
        N(jgn.solve_normal(jnp.asarray(Hpd), jnp.ones(3), 1e-4)), rtol=1e-5)


# --------------------------------------------------- degeneracy + schur

def _spd(n, seed, weak=None):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n + 6)).astype(np.float32)
    H = a @ a.T
    if weak is not None:
        v = rng.normal(size=n).astype(np.float32)
        v /= np.linalg.norm(v)
        P = np.eye(n, dtype=np.float32) - np.outer(v, v)
        H = P @ H @ P + weak * np.outer(v, v)
    return H.astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(threshold=3.0), dict(threshold=3.0, max_freeze=1),
    dict(threshold=3.0, max_freeze=1, shared=True),
    dict(threshold=3.0, shared=True, snap_purity=0.8),
    dict(threshold=50.0, rel_gap=0.3), dict(threshold=0.0, max_freeze=1, shared=True, snap_purity=0.8),
])
def test_block_projector(kw):
    H = _spd(18, 1)
    for b in range(3):
        H[b * 6:(b + 1) * 6, b * 6:(b + 1) * 6] = _spd(6, 10 + b, weak=0.5 + b)
    thr = kw.pop("threshold")
    Pt, vt = tdeg.block_projector(T(H), thr, **kw)
    Pj, vj = jdeg.block_projector(jnp.asarray(H), thr, **kw)
    np.testing.assert_allclose(N(vt), N(vj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(N(Pt), N(Pj), atol=1e-4)
    dx = np.random.default_rng(2).normal(size=18).astype(np.float32)
    np.testing.assert_allclose(N(tdeg.apply_block_projector(Pt, T(dx))),
                               N(jdeg.apply_block_projector(Pj, jnp.asarray(dx))), atol=1e-4)


def test_degeneracy_spectra():
    H = _spd(24, 3)
    np.testing.assert_allclose(N(tdeg.shared_spectrum(T(H))),
                               N(jdeg.shared_spectrum(jnp.asarray(H))), rtol=1e-4)
    vt, dt = tdeg.shared_weak_direction(T(H))
    vj, dj = jdeg.shared_weak_direction(jnp.asarray(H))
    np.testing.assert_allclose(N(vt), N(vj), rtol=1e-4)
    np.testing.assert_allclose(np.abs(N(dt)), np.abs(N(dj)), atol=1e-3)
    it, ij = tdeg.analyze_blocks(T(H), 4, 20.0), jdeg.analyze_blocks(jnp.asarray(H), 4, 20.0)
    np.testing.assert_allclose(N(it.eigvals), N(ij.eigvals), rtol=1e-4)
    np.testing.assert_array_equal(N(it.degenerate), N(ij.degenerate))
    dx = np.ones(24, np.float32)
    np.testing.assert_allclose(N(tdeg.remap_update(T(H), T(dx), 20.0)),
                               N(jdeg.remap_update(jnp.asarray(H), jnp.asarray(dx), 20.0)), atol=1e-3)


def test_schur_marginalize():
    H = _spd(24, 4)
    g = np.random.default_rng(5).normal(size=24).astype(np.float32)
    qt = tmarg.schur_marginalize_quad(T(H), T(g), 6)
    qj = jmarg.schur_marginalize_quad(jnp.asarray(H), jnp.asarray(g), 6)
    scale = np.abs(N(qj.H)).max()
    np.testing.assert_allclose(N(qt.H), N(qj.H), atol=2e-4 * scale)
    np.testing.assert_allclose(N(qt.b), N(qj.b), atol=2e-4 * np.abs(N(qj.b)).max())
    assert bool(qt.valid)
    # against float64 Schur complement
    H64, g64 = H.astype(np.float64), g.astype(np.float64)
    Hp = H64[6:, 6:] - H64[6:, :6] @ np.linalg.solve(H64[:6, :6], H64[:6, 6:])
    np.testing.assert_allclose(N(qt.H), Hp, atol=1e-3 * scale)
    mt = tmarg.schur_marginalize(T(H), T(g), 6)
    mj = jmarg.schur_marginalize(jnp.asarray(H), jnp.asarray(g), 6)
    # J is a sign-ambiguous square root: compare JᵀJ and Jᵀr0, and the replay
    np.testing.assert_allclose(N(mt.J.T @ mt.J), N(mj.J.T @ mj.J), atol=2e-4 * scale)
    np.testing.assert_allclose(N(mt.J.T @ mt.r0), N(mj.J.T @ mj.r0), atol=1e-3 * np.abs(g).max())
    d = np.random.default_rng(6).normal(size=18).astype(np.float32) * 0.01
    np.testing.assert_allclose(np.linalg.norm(N(mt.residual(T(d)))),
                               np.linalg.norm(N(mj.residual(jnp.asarray(d)))), rtol=1e-3)
    assert float(tmarg.MargPrior.empty(4).residual(torch.ones(4)).abs().sum()) == 0.0
    assert not bool(tmarg.QuadPrior.empty(4).valid)
