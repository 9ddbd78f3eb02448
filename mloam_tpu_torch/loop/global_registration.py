"""Priorless global registration: FPFH features + correspondence RANSAC, and
the yaw-sweep FFT correlation registration.

Counterpart of ``mloam_tpu/loop/global_registration.py`` (the reference's
FPFH + FastGlobalRegistration stage, used when a loop candidate has no
usable pose prior). Every stage is a fixed-shape batched tensor op:

  * normals: k-NN + closed-form smallest eigenvector (``ops/sym3x3``);
  * SPFH / FPFH: the Darboux-frame angle triplet over k neighbours,
    histogrammed by one-hot sums (11 bins x 3 = 33-D), neighbour-averaged;
  * correspondences: 33-D feature nearest neighbours with a ratio test;
  * hypotheses: random correspondence triplets -> batched Kabsch -> inlier
    counts on the whole correspondence set; refinement on the winner's
    inliers.

The k-NN calls here (k = 10-12 on points, k = 2 on 33-D features) are the
plain ``ops/knn.knn_plain`` on either device, as the JAX package uses its
plain ``knn_ops.knn`` there and never its Pallas kernel: the hand-written
k-NN (K2) is for 3-D points and k <= 8, and these calls never reach it.

The triplet draw is ``torch.multinomial`` with a ``torch.Generator``
(``draw_triplets``), kept apart from the scoring (``score_triplets``) so
that a caller can score another draw, the JAX package's
``jax.random.choice`` included: the same distribution, another draw.

``register_correlation``: all ``n_yaw`` rotations of the source are
rasterised to x-y occupancy grids and correlated with the target's through
``torch.fft.rfft2`` / ``irfft2`` on zero-padded grids, batched over the
yaws (the JAX package leaves these FFTs to XLA; ``torch.fft`` is their
counterpart, not a kernel). Argmax ties go to the lowest index, as
``jnp.argmax`` breaks them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mloam_tpu_torch.core import rotations as rot
from mloam_tpu_torch.core.rotations import _cross
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.loop.registration import yaw_quat
from mloam_tpu_torch.ops import sym3x3
from mloam_tpu_torch.ops.knn import knn_plain

N_BINS = 11


def estimate_normals(xyz: torch.Tensor, mask: torch.Tensor, k: int = 10):
    """[N, 3] unit normals from k-NN PCA (sign not disambiguated), with the
    neighbour indices and squared distances."""
    d, idx = knn_plain(xyz, xyz, mask, k)
    nn = xyz[idx]
    rel = nn - torch.mean(nn, dim=1)[:, None, :]
    cov = torch.einsum("nki,nkj->nij", rel, rel)
    _, n = sym3x3.smallest_eigvec3(cov)
    return n, idx, d


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-9)


def _spfh(xyz, normals, idx, valid_pair):
    """Simplified point feature histograms per point: idx [N, k] neighbour
    indices, valid_pair [N, k]. Returns [N, 33]."""
    q = xyz[idx]
    n_q = normals[idx]
    dunit = _unit(q - xyz[:, None, :])
    u = normals[:, None, :].expand(q.shape)
    v = _unit(_cross(dunit, u))
    w = _cross(u, v)
    alpha = torch.sum(v * n_q, -1)                                   # [-1, 1]
    phi = torch.sum(u * dunit, -1)                                   # [-1, 1]
    theta = torch.atan2(torch.sum(w * n_q, -1), torch.sum(u * n_q, -1))  # [-pi, pi]
    vp = valid_pair.to(xyz.dtype)

    def hist(vals, lo, hi):
        b = torch.floor((vals - lo) / (hi - lo) * N_BINS).to(torch.int64)
        oh = F.one_hot(torch.clamp(b, 0, N_BINS - 1), N_BINS).to(xyz.dtype)
        return torch.sum(oh * vp[..., None], dim=1)                  # [N, N_BINS]

    h = torch.cat([hist(alpha, -1.0, 1.0), hist(phi, -1.0, 1.0),
                   hist(theta, -math.pi, math.pi)], dim=-1)
    return h / torch.clamp(torch.sum(vp, -1, keepdim=True), min=1.0)


def fpfh(xyz: torch.Tensor, mask: torch.Tensor, k: int = 10) -> torch.Tensor:
    """[N, 33] FPFH descriptors (masked-out rows are zero)."""
    normals, idx, d = estimate_normals(xyz, mask, k)
    valid_pair = mask[:, None] & mask[idx] & (d < 25.0) & (d > 1e-8)
    spfh = _spfh(xyz, normals, idx, valid_pair)
    # neighbour-weighted sum (weights 1/dist)
    wgt = torch.where(valid_pair, 1.0 / torch.clamp(torch.sqrt(d), min=1e-3), 0.0)
    neigh = torch.einsum("nk,nkf->nf", wgt, spfh[idx])
    wsum = torch.clamp(torch.sum(wgt, -1, keepdim=True), min=1e-9)
    return torch.where(mask[:, None], spfh + neigh / wsum, 0.0)


def _kabsch(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor) -> Pose:
    """Weighted rigid alignment dst ≈ R src + t. src/dst [..., M, 3]."""
    wsum = torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-9)
    cs = torch.sum(src * w[..., None], -2) / wsum
    cd = torch.sum(dst * w[..., None], -2) / wsum
    s0 = src - cs[..., None, :]
    d0 = dst - cd[..., None, :]
    H = torch.einsum("...mi,...m,...mj->...ij", s0, w, d0)
    U, _, Vt = torch.linalg.svd(H)
    det = torch.linalg.det(Vt.transpose(-1, -2) @ U.transpose(-1, -2))
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    R = torch.einsum("...ji,...j,...kj->...ik", Vt, D, U)   # V diag(D) Uᵀ
    t = cd - torch.einsum("...ij,...j->...i", R, cs)
    return Pose(rot.matrix_to_quat(R), t)


class GlobalRegResult(NamedTuple):
    pose: Pose                # dst <- src
    inlier_frac: torch.Tensor
    n_corr: torch.Tensor
    ok: torch.Tensor


class Correspondences(NamedTuple):
    ps: torch.Tensor      # [N, 3] source points
    pd: torch.Tensor      # [N, 3] their matched destination points
    valid: torch.Tensor   # [N] bool: a distinctive source point that passed the ratio test


def correspondences(src_xyz, src_mask, dst_xyz, dst_mask, k_feat: int = 12,
                    ratio: float = 0.95,
                    exclude_flat_normals: float = 0.92) -> Correspondences:
    """FPFH correspondences src -> dst. Ground-like source points
    (|normal·z| above ``exclude_flat_normals``) are excluded (their
    descriptors are all alike); a ratio test on the top-2 feature neighbours
    replaces mutual gating."""
    normals_src, _, _ = estimate_normals(src_xyz, src_mask, k_feat)
    f_src = fpfh(src_xyz, src_mask, k_feat)
    f_dst = fpfh(dst_xyz, dst_mask, k_feat)
    distinctive = torch.abs(normals_src[:, 2]) < exclude_flat_normals
    d_sd, nn_sd = knn_plain(f_src, f_dst, dst_mask, 2)
    passes_ratio = d_sd[:, 0] < (ratio ** 2) * torch.clamp(d_sd[:, 1], min=1e-12)
    valid = src_mask & distinctive & passes_ratio & (d_sd[:, 0] < 1e8)
    return Correspondences(src_xyz, dst_xyz[nn_sd[:, 0]], valid)


def draw_triplets(valid: torch.Tensor, n_hypotheses: int,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """[H, 3] correspondence indices drawn with replacement, probability
    proportional to validity. With no valid correspondence the draw is
    uniform (the result is refused by ``n_corr`` then; ``torch.multinomial``
    takes no all-zero weights)."""
    w = valid.to(torch.float32)
    w = torch.where(torch.sum(w) > 0, w, torch.ones_like(w))
    idx = torch.multinomial(w, n_hypotheses * 3, replacement=True, generator=generator)
    return idx.reshape(n_hypotheses, 3)


def score_triplets(corr: Correspondences, tri: torch.Tensor,
                   inlier_dist: float = 0.5, min_inlier_frac: float = 0.2
                   ) -> GlobalRegResult:
    """Kabsch on every triplet, inliers counted on the whole correspondence
    set, the best (first of equal counts) refined by two re-weighted Kabsch
    rounds on its inliers."""
    ps, pd, valid = corr
    n_corr = torch.sum(valid)
    T_h = _kabsch(ps[tri], pd[tri], torch.ones(tri.shape, dtype=ps.dtype, device=ps.device))
    ps_t = rot.quat_rotate(T_h.q[:, None, :], ps[None]) + T_h.t[:, None, :]
    inl = (torch.linalg.norm(ps_t - pd[None], dim=-1) < inlier_dist) & valid[None]
    best = torch.argmax(torch.sum(inl, dim=-1))

    def inliers(T):
        ps_r = rot.quat_rotate(T.q[None], ps) + T.t[None]
        return (torch.linalg.norm(ps_r - pd, dim=-1) < inlier_dist) & valid

    T_ref = _kabsch(ps, pd, inl[best].to(ps.dtype))
    for _ in range(2):
        T_ref = _kabsch(ps, pd, inliers(T_ref).to(ps.dtype))
    frac = torch.sum(inliers(T_ref)) / torch.clamp(n_corr, min=1)
    return GlobalRegResult(pose=T_ref, inlier_frac=frac, n_corr=n_corr,
                           ok=(frac > min_inlier_frac) & (n_corr > 30))


def register_global(
    src_xyz, src_mask, dst_xyz, dst_mask,
    generator: torch.Generator | None = None,
    k_feat: int = 12,
    n_hypotheses: int = 512,
    inlier_dist: float = 0.5,
    ratio: float = 0.95,
    min_inlier_frac: float = 0.2,
    exclude_flat_normals: float = 0.92,
) -> GlobalRegResult:
    """FPFH + parallel-RANSAC estimate of dst <- src."""
    corr = correspondences(src_xyz, src_mask, dst_xyz, dst_mask, k_feat, ratio,
                           exclude_flat_normals)
    return score_triplets(corr, draw_triplets(corr.valid, n_hypotheses, generator),
                          inlier_dist, min_inlier_frac)


# ---------------------------------------------------------------------------
# correlation-based priorless registration (yaw sweep + FFT translation)
# ---------------------------------------------------------------------------

def occupancy_grid(xyz, mask, extent: float, res: float):
    """[..., G, G] occupancy image over x-y (soft counts clipped at 3,
    mean-removed); leading axes of ``xyz`` [..., N, 3] are independent
    images."""
    g = int(round(2 * extent / res))
    ij = torch.floor((xyz[..., :2] + extent) / res).to(torch.int64)
    ok = mask & torch.all(ij >= 0, dim=-1) & torch.all(ij < g, dim=-1)
    flat = torch.clamp(ij[..., 0] * g + ij[..., 1], 0, g * g - 1)
    img = torch.zeros(flat.shape[:-1] + (g * g,), dtype=xyz.dtype, device=xyz.device)
    img.scatter_add_(-1, flat, ok.to(xyz.dtype))
    img = torch.clamp(img.reshape(flat.shape[:-1] + (g, g)), max=3.0)
    return img - torch.mean(img, dim=(-2, -1), keepdim=True)


def _signed(i: torch.Tensor, g: int) -> torch.Tensor:
    """Circular index in [0, g) -> shift in (-g/2, g/2]."""
    return torch.where(i > g // 2, i - g, i)


def _xcorr_peak(a: torch.Tensor, b: torch.Tensor):
    """Circular cross-correlation peak of b relative to a via FFT.
    Returns (shift_rows, shift_cols, peak_value) with shifts in (-G/2, G/2]."""
    g = a.shape[0]
    corr = torch.fft.irfft2(torch.fft.rfft2(a) * torch.conj(torch.fft.rfft2(b)), s=(g, g))
    idx = torch.argmax(corr)
    return _signed(idx // g, g), _signed(idx % g, g), corr.reshape(-1)[idx]


def _yaws(n_yaw: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n_yaw, dtype=like.dtype, device=like.device) * (2 * math.pi / n_yaw)


def _yaw_scores(src_xyz, src_mask, dst_xyz, dst_mask, n_yaw: int, extent: float,
                res: float):
    """Per yaw: (score = peak / std [Y], flat peak index [Y], correlation
    surfaces [Y, G²]) of the source turned by each of ``n_yaw`` yaws against
    the target, on grids zero-padded to twice their size."""
    dst_img = occupancy_grid(dst_xyz, dst_mask, extent, res)
    g = 2 * dst_img.shape[0]
    fd = torch.fft.rfft2(dst_img, s=(g, g))
    pts = rot.quat_rotate(yaw_quat(_yaws(n_yaw, src_xyz))[:, None, :], src_xyz[None])
    imgs = occupancy_grid(pts, src_mask[None].expand(n_yaw, -1), extent, res)
    corr = torch.fft.irfft2(fd[None] * torch.conj(torch.fft.rfft2(imgs, s=(g, g))),
                            s=(g, g)).reshape(n_yaw, -1)
    idxs = torch.argmax(corr, dim=-1)
    scores = torch.gather(corr, 1, idxs[:, None])[:, 0]
    stds = torch.std(corr, dim=-1, correction=0)
    return scores / torch.clamp(stds, min=1e-9), idxs, corr


def register_correlation(
    src_xyz, src_mask, dst_xyz, dst_mask,
    n_yaw: int = 72,
    extent: float = 40.0,
    res: float = 0.5,
    min_score: float = 3.0,
    min_z: float = 0.0,
) -> GlobalRegResult:
    """Priorless coarse registration by exhaustive yaw sweep + FFT
    translation correlation on x-y occupancy grids: every yaw's grid is
    correlated with the target's on grids zero-padded to twice their size
    (linear, not circular, correlation), all yaws in one batch; z from the
    mean height difference. Score = peak / std of the correlation surface;
    the best yaw is the first of the highest scores. Points at or below
    ``min_z`` (the sensor-centred ground, whose peak sits at zero shift
    whatever the motion) do not vote. ``inlier_frac`` carries the score."""
    dev = src_xyz.device
    src_mask = src_mask & (src_xyz[:, 2] > min_z)
    dst_mask = dst_mask & (dst_xyz[:, 2] > min_z)
    snrs, idxs, corr = _yaw_scores(src_xyz, src_mask, dst_xyz, dst_mask, n_yaw, extent, res)
    g = 2 * int(round(2 * extent / res))
    yaws = _yaws(n_yaw, src_xyz)
    best = torch.argmax(snrs).reshape(1)
    idx = idxs.index_select(0, best)[0]
    # corr[d] = Σ_a dst[a] src[a - d]: the peak d is dst_pos - src_pos in
    # grid cells (rows = x, cols = y)
    dx = _signed(idx // g, g).to(src_xyz.dtype) * res
    dy = _signed(idx % g, g).to(src_xyz.dtype) * res

    def mean_z(xyz, m):
        return (torch.sum(torch.where(m, xyz[:, 2], 0.0))
                / torch.clamp(torch.sum(m), min=1))

    t = torch.stack([dx, dy, mean_z(dst_xyz, dst_mask) - mean_z(src_xyz, src_mask)])
    snr = snrs.index_select(0, best)[0]
    return GlobalRegResult(
        pose=Pose(yaw_quat(yaws.index_select(0, best)[0]), t),
        inlier_frac=snr,
        n_corr=torch.full((), n_yaw, dtype=torch.int64, device=dev),
        ok=snr > min_score,
    )
