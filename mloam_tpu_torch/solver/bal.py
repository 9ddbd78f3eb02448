"""Bundle adjustment on BAL problems (Snavely camera model): the real-data
check of the GN/LM + robust-loss + Schur machinery.

Counterpart of ``mloam_tpu/solver/bal.py`` (the reference's
``mloam_test/src/bundle_adjuster.cc`` + ``bal_problem.cc`` +
``snavely_reprojection_error.h``, which delegate to Ceres):

  * residuals and Jacobians: one forward-mode pass over all observations
    (a shared 12-dim perturbation of each observation's own camera and point
    copies yields every observation's own Jacobian);
  * Schur elimination of the points: batched 3x3 inverses, the camera-camera
    fill through a precomputed list of ordered observation pairs sharing a
    point, summed into C·C 9x9 buckets;
  * the reduced camera system (C·9 square, dense) solved by Cholesky; the
    points back-substituted;
  * observation-sharded assembly over a mesh (``make_sharded_assemble``).

Every sum onto cameras, points or camera pairs is ``ops/segsum.index_sum``.
Robust losses (``solver/robust``) apply per observation on the squared
2-vector reprojection residual norm. f32 throughout (TF32 is off).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mloam_tpu_torch import resolve_device
from mloam_tpu_torch.ops.segsum import index_sum
from mloam_tpu_torch.parallel.mesh import data_axes
from mloam_tpu_torch.solver import robust


class BalProblem(NamedTuple):
    cams: torch.Tensor      # [C, 9] angle-axis(3), t(3), f, k1, k2
    pts: torch.Tensor       # [P, 3]
    cam_idx: torch.Tensor   # [N] int64
    pt_idx: torch.Tensor    # [N] int64
    obs: torch.Tensor       # [N, 2]
    # ordered observation pairs sharing a point (host-precomputed, static)
    pair_i: torch.Tensor    # [M] int64 observation index 1
    pair_j: torch.Tensor    # [M] int64 observation index 2


def observation_pairs(pt_idx: np.ndarray, n_pts: int):
    """For each point, all ordered pairs of its observations (i == j
    included), point by point, row-major: the JAX package's pair list."""
    order = np.argsort(pt_idx, kind="stable")
    cnt = np.bincount(pt_idx, minlength=n_pts)
    starts = np.concatenate([[0], np.cumsum(cnt)])[:-1]
    # each observation (in point order) pairs with every observation of its point
    c_obs = np.repeat(cnt, cnt)                    # its point's count
    s_obs = np.repeat(starts, cnt)                 # its point's first slot
    pair_i = np.repeat(order, c_obs)
    within = np.arange(c_obs.sum()) - np.repeat(np.cumsum(c_obs) - c_obs, c_obs)
    pair_j = order[np.repeat(s_obs, c_obs) + within]
    return pair_i, pair_j


def load_bal(path: str, device=None, dtype=torch.float32) -> BalProblem:
    """Parse a BAL problem file (``<C> <P> <N>``, N observation lines
    ``cam pt x y``, then 9C + 3P parameter values) on the host."""
    device = resolve_device(device)
    with open(path) as f:
        tok = f.read().split()
    nc, npt, no = (int(v) for v in tok[:3])
    o = np.asarray(tok[3:3 + 4 * no]).reshape(no, 4)
    cam_idx = o[:, 0].astype(np.int64)
    pt_idx = o[:, 1].astype(np.int64)
    obs = o[:, 2:].astype(np.float64)
    rest = np.asarray(tok[3 + 4 * no:3 + 4 * no + 9 * nc + 3 * npt], np.float64)
    pair_i, pair_j = observation_pairs(pt_idx, npt)

    def t(a, dt=dtype):
        return torch.as_tensor(a).to(device=device, dtype=dt)

    return BalProblem(cams=t(rest[:9 * nc].reshape(nc, 9)),
                      pts=t(rest[9 * nc:].reshape(npt, 3)),
                      cam_idx=t(cam_idx, torch.int64), pt_idx=t(pt_idx, torch.int64),
                      obs=t(obs), pair_i=t(pair_i, torch.int64),
                      pair_j=t(pair_j, torch.int64))


def write_bal(path: str, cams, pts, cam_idx, pt_idx, obs):
    """Write a BAL problem file that ``load_bal`` reads back (numpy inputs;
    values with 17 significant digits)."""
    with open(path, "w") as f:
        f.write(f"{len(cams)} {len(pts)} {len(obs)}\n")
        for c, p, (x, y) in zip(cam_idx, pt_idx, np.asarray(obs, np.float64)):
            f.write(f"{int(c)} {int(p)} {x:.17g} {y:.17g}\n")
        vals = np.concatenate([np.asarray(cams, np.float64).reshape(-1),
                               np.asarray(pts, np.float64).reshape(-1)])
        f.write("\n".join(f"{v:.17g}" for v in vals))
        f.write("\n")


def snavely_residual(cam: torch.Tensor, pt: torch.Tensor,
                     ob: torch.Tensor) -> torch.Tensor:
    """[..., 2] reprojection residual of the 9-parameter Snavely camera
    (angle-axis rotation, translation, focal, two radial distortion terms;
    BAL's negative-z convention), batched over leading axes."""
    aa, t = cam[..., :3], cam[..., 3:6]
    f, k1, k2 = cam[..., 6], cam[..., 7], cam[..., 8]
    theta = torch.sqrt(torch.sum(aa * aa, -1, keepdim=True) + 1e-24)
    k = aa / theta
    ct, st = torch.cos(theta), torch.sin(theta)
    # Rodrigues rotation of pt
    p = (pt * ct + torch.linalg.cross(k, pt, dim=-1) * st
         + k * torch.sum(k * pt, -1, keepdim=True) * (1.0 - ct)) + t
    xp = -p[..., 0] / p[..., 2]
    yp = -p[..., 1] / p[..., 2]
    r2 = xp * xp + yp * yp
    distortion = 1.0 + r2 * (k1 + k2 * r2)
    return torch.stack([f * distortion * xp - ob[..., 0],
                        f * distortion * yp - ob[..., 1]], -1)


def _robust_weight(r, loss, loss_scale, gnc_mu):
    s = torch.sum(r * r, -1)
    return robust.loss_weight(s, loss, delta=loss_scale, gm_c=loss_scale, gnc_mu=gnc_mu)


def linearize_observations(cams, pts, cam_idx, pt_idx, obs):
    """Residuals [..., 2] and Jacobian blocks Jc [..., 2, 9], Jp [..., 2, 3]
    of each observation, by one forward-mode pass."""
    c, p = cams[cam_idx], pts[pt_idx]

    def res(x):
        return snavely_residual(c + x[:9], p + x[9:], obs)

    zero = torch.zeros((12,), dtype=cams.dtype, device=cams.device)
    J = torch.func.jacfwd(res)(zero)
    return res(zero), J[..., :9], J[..., 9:]


def _linearize_obs(cams, pts, prob: BalProblem, loss: str, loss_scale: float,
                   gnc_mu: float):
    """Per-observation residuals, IRLS weights, and Jacobian blocks."""
    r, Jc, Jp = linearize_observations(cams, pts, prob.cam_idx, prob.pt_idx, prob.obs)
    return r, _robust_weight(r, loss, loss_scale, gnc_mu), Jc, Jp


def bal_cost(cams, pts, prob: BalProblem, loss: str = "trivial",
             loss_scale: float = 1.0, gnc_mu: float = 1.0) -> torch.Tensor:
    """0.5 Σ ρ(||r||²): the quantity LM accepts on (the true robust cost,
    not the IRLS quadratic)."""
    r = snavely_residual(cams[prob.cam_idx], pts[prob.pt_idx], prob.obs)
    s = torch.sum(r * r, -1)
    if loss == "trivial":
        rho = s
    elif loss == "huber":
        d2 = loss_scale * loss_scale
        rho = torch.where(s <= d2, s,
                          2.0 * loss_scale * torch.sqrt(torch.clamp(s, min=1e-20)) - d2)
    elif loss == "gm":
        c2 = loss_scale * loss_scale
        rho = c2 * s / (c2 + s)
    elif loss == "gnc_gm":
        mc2 = gnc_mu * loss_scale * loss_scale
        rho = mc2 * s / (mc2 + s)
    else:
        raise ValueError(loss)
    return 0.5 * torch.sum(rho)


def _blocks(r, w, Jc, Jp):
    """Per-observation normal-equation terms: Jcᵀ W Jc, Jpᵀ W Jp, A = Jcᵀ W
    Jp, Jcᵀ W r, Jpᵀ W r."""
    return (torch.einsum("...nka,...n,...nkb->...nab", Jc, w, Jc),
            torch.einsum("...nka,...n,...nkb->...nab", Jp, w, Jp),
            torch.einsum("...nka,...n,...nkb->...nab", Jc, w, Jp),
            torch.einsum("...nka,...n,...nk->...na", Jc, w, r),
            torch.einsum("...nka,...n,...nk->...na", Jp, w, r))


def dense_assemble(cams, pts, prob: BalProblem, loss, loss_scale, gnc_mu):
    """Normal-equation blocks (Hcc [C, 9, 9], Hpp [P, 3, 3], A [N, 9, 3],
    gc [C, 9], gp [P, 3]) on one device."""
    C, P = cams.shape[0], pts.shape[0]
    r, w, Jc, Jp = _linearize_obs(cams, pts, prob, loss, loss_scale, gnc_mu)
    cc, pp, A, gc, gp = _blocks(r, w, Jc, Jp)
    return (index_sum(cc, prob.cam_idx, C), index_sum(pp, prob.pt_idx, P), A,
            index_sum(gc, prob.cam_idx, C), index_sum(gp, prob.pt_idx, P))


def make_sharded_assemble(mesh):
    """Observation-sharded normal-equation assembly over a mesh: the
    observations are padded (weight 0) and sharded over every mesh axis,
    each shard linearizes its own, and the partial Hcc / Hpp / gc / gp are
    reduced by ``mesh.index_sum`` (one fixed-point scale over all shards:
    the sums are those of one ``index_sum`` over the padded observations).
    The per-observation blocks A are gathered back for the Schur fill."""
    axes = data_axes(mesh)

    def assemble(cams, pts, prob: BalProblem, loss, loss_scale, gnc_mu):
        C, P = cams.shape[0], pts.shape[0]
        N = prob.obs.shape[0]
        pad = (-N) % mesh.size

        def sh(x):
            z = x.new_zeros((pad,) + tuple(x.shape[1:]))
            return mesh.shard(torch.cat([x, z]))

        cam_i, pt_i, ob = sh(prob.cam_idx), sh(prob.pt_idx), sh(prob.obs)
        valid = sh(torch.ones((N,), dtype=cams.dtype, device=cams.device))
        r, Jc, Jp = linearize_observations(cams, pts, cam_i, pt_i, ob)
        w = valid * _robust_weight(r, loss, loss_scale, gnc_mu)
        cc, pp, A, gc, gp = _blocks(r, w, Jc, Jp)

        def red(v, idx, n):
            return mesh.replicated(mesh.index_sum(v, idx, n, axes))

        A = mesh.replicated(mesh.all_gather(A, axes))[:N]
        return red(cc, cam_i, C), red(pp, pt_i, P), A, red(gc, cam_i, C), red(gp, pt_i, P)

    return assemble


def lm_step(cams, pts, prob: BalProblem, lam, loss: str = "trivial",
            loss_scale: float = 1.0, gnc_mu: float = 1.0, assemble=None):
    """One damped Schur-complement step -> (cams', pts'). ``assemble``
    overrides the normal-equation assembly (the sharded one plugs in
    here). Marquardt-scaled damping on both blocks."""
    C = cams.shape[0]
    P = pts.shape[0]
    if assemble is None:
        assemble = dense_assemble
    Hcc, Hpp, A, gc, gp = assemble(cams, pts, prob, loss, loss_scale, gnc_mu)

    eye9 = torch.eye(9, dtype=cams.dtype, device=cams.device)
    eye3 = torch.eye(3, dtype=cams.dtype, device=cams.device)
    Hcc_d = Hcc + lam * (Hcc * eye9 + 1e-3 * eye9)
    Hpp_d = Hpp + lam * (Hpp * eye3 + 1e-3 * eye3)
    Hpp_inv, _ = torch.linalg.inv_ex(Hpp_d)                  # [P, 3, 3]

    # Schur: S = blockdiag(Hcc_d) − Σ_pairs A_i1 Hpp⁻¹ A_i2ᵀ
    Ai, Aj = A[prob.pair_i], A[prob.pair_j]                  # [M, 9, 3]
    Hinv_pair = Hpp_inv[prob.pt_idx[prob.pair_i]]            # [M, 3, 3]
    contrib = torch.einsum("mab,mbc,mdc->mad", Ai, Hinv_pair, Aj)  # [M, 9, 9]
    bucket = prob.cam_idx[prob.pair_i] * C + prob.cam_idx[prob.pair_j]
    S = -index_sum(contrib, bucket, C * C).reshape(C, C, 9, 9)
    ar = torch.arange(C, device=cams.device)
    S[ar, ar] += Hcc_d
    S = S.transpose(1, 2).reshape(C * 9, C * 9)

    # reduced rhs: b = gc − Σ_obs A_i Hpp⁻¹ gp
    hg = torch.einsum("nab,nb->na", Hpp_inv[prob.pt_idx], gp[prob.pt_idx])
    corr = torch.einsum("nab,nb->na", A, hg)
    b = gc - index_sum(corr, prob.cam_idx, C)

    L, info = torch.linalg.cholesky_ex(S + 1e-8 * torch.eye(C * 9, dtype=cams.dtype,
                                                             device=cams.device))
    dxc = -torch.cholesky_solve(b.reshape(-1, 1), L).reshape(C, 9)
    dxc = torch.where(info == 0, dxc, torch.nan)

    # back-substitute points: dx_p = −Hpp⁻¹ (gp + Σ_obs A_iᵀ dx_c)
    At_dxc = torch.einsum("nab,na->nb", A, dxc[prob.cam_idx])  # [N, 3]
    gp_corr = gp + index_sum(At_dxc, prob.pt_idx, P)
    dxp = -torch.einsum("pab,pb->pa", Hpp_inv, gp_corr)
    return cams + dxc, pts + dxp


def solve_bal(prob: BalProblem, iters: int = 20, loss: str = "trivial",
              loss_scale: float = 1.0, mu_schedule=None, assemble=None,
              init_lambda: float = 1e-4, verbose: bool = False):
    """Host-driven LM loop, accepting or rejecting each step on the true
    robust cost (one host read a step). ``mu_schedule(k) -> μ`` anneals GNC
    convexity across the outer LM iterations (the reference's μ /= 1.4 per
    outer solve, ``ceres_robust_curve_fitting.cpp:131-143``). Returns
    (cams, pts, cost history)."""
    cams, pts = prob.cams, prob.pts
    lam = init_lambda
    mu = mu_schedule(0) if mu_schedule is not None else 1.0
    cost = float(bal_cost(cams, pts, prob, loss, loss_scale, mu))
    history = [cost]
    for k in range(iters):
        if mu_schedule is not None:
            mu = mu_schedule(k)
            cost = float(bal_cost(cams, pts, prob, loss, loss_scale, mu))
        cams_n, pts_n = lm_step(cams, pts, prob, lam, loss, loss_scale, mu, assemble)
        cost_n = float(bal_cost(cams_n, pts_n, prob, loss, loss_scale, mu))
        if np.isfinite(cost_n) and cost_n <= cost:
            cams, pts, cost = cams_n, pts_n, cost_n
            lam = max(lam * 0.3, 1e-8)
        else:
            lam = min(lam * 5.0, 1e6)
        history.append(cost)
        if verbose:
            print(f"  lm[{k:2d}] cost {cost:.6e} lam {lam:.1e} mu {mu:.2f}", flush=True)
    return cams, pts, history
