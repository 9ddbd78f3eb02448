"""End-to-end pipeline assembly: single- or multi-LiDAR odometry, sweep to
pose, with the online extrinsic calibration lifecycle, and the odometry plus
keyframe mapping (``FullPipeline``).

Counterpart of ``mloam_tpu/models/pipeline.py:OdometryPipeline`` and
``FullPipeline``. PyTorch runs eagerly, so what the JAX package fuses into
one jitted program per sweep is plain composition here; the method names are
kept so a reader finds the counterpart:

  first sweep     frontends + ``_push_first``
  warm-up         frontends + ``_track`` + ``_push_only``
  window full     ``_window_step_impl`` (push + window solve +
                  marginalization), in modes 2 and 1 after the tracker(s)
  steady          ``_fused_step_impl``: frontends + reference tracker +
                  de-skew + window solve over all lidars + marginalization
                  (``ext_mode`` 0, window full); the JAX package's
                  ``_fused_step_impl`` (one lidar) and ``_fused_multi_impl``
                  (unrolled per-lidar frontends) in one. With
                  ``tracker.skip_steady`` the tracker is skipped there: the
                  constant-velocity motion seeds the window and de-skews,
                  and the next motion is read back off the refined window.

The calibration lifecycle (ESTIMATE_EXTRINSIC, a per-rig setting):

  2  no prior: every lidar is tracked scan-to-scan on its own; motions
     composed over ``calib.pair_stride`` sweeps are paired with the
     reference lidar's in a hand-eye buffer when screw-consistent; the window
     solve matches the reference lidar only. When the hand-eye rotation
     converges for every lidar the extrinsics are installed and the mode
     drops to 1.
  1  refinement: extrinsic blocks join the window tangent; whenever an
     extrinsic Hessian block is well-conditioned the estimate is collected;
     after ``calib.n_calib_samples`` the Lie mean is frozen in, the
     marginalization prior is discarded and the mode drops to 0.
  0  pure odometry with fixed extrinsics, all lidars contributing.

Modes 2 and 1 read the device on the host (the hand-eye gate, the extrinsic
blocks' eigenvalues), as the JAX package does; the steady mode-0 step does
not. The first sweep with a full window runs the steady step (the JAX
package runs it unfused; with nothing to fuse the two are the same code).
Each sweep's three stages run under the stage timers ``odom_mea_pre`` /
``odom_tracker`` / ``odom_solver`` (``utils/timing``). They read the host
clock only, so they add no wait for the device: a stage's time is the
host's time to issue it. ``sync_timing=True`` (on every pipeline, passed
down) synchronises the device at each timer's entry and exit, so each stage
is timed with its device work (the JAX package's ``MLOAM_SYNC_TIMING=1``).

Per sweep the hand-written kernels run once per lidar for label propagation
(``ops/hopper_labels``; once for the whole rig on a batched steady sweep,
below) and for k-NN (``ops/hopper_knn``) twice per tracker
(one tracker, or one per lidar in mode 2; none on a steady sweep with
``skip_steady``) and twice in the window solve.

A mapped sweep of ``FullPipeline`` adds the mapper's step
(``mapping/mapper.mapper_step``, under the timer ``map_step``): two outer
iterations of two k-NN calls each against the surround map, once the map
holds a keyframe.

``SlamPipeline`` adds loop closure behind the mapper (``loop/posegraph``):
on the sweep after a keyframe, scan-context detection and a pose-seeded fine
registration (six k-NN calls) and, with ``loop.use_global_registration``,
the FFT correlation registration and a fine registration seeded by it (six
more); the pose-graph optimization when a loop is verified.

The batched frontend for uniform rigs: when every lidar of a rig of L > 1
has the same sensor model, the steady step stacks the rig's L sweeps and
runs one frontend over the batch ``[L, R, C]``: one label launch for the rig
(the kernel over ``[L, R, C]``), every other frontend op issued once, not L
times. Its outputs, split per lidar, equal the unrolled frontends' to the
bit. A rig of mixed sensor models, the first sweep, the warm-up and
calibration modes 2 and 1 run one frontend per lidar. The JAX package
vmaps its frontend over the lidar axis only behind the opt-in switch
``MLOAM_BATCH_FE``, since on the TPU the vmapped label kernel ran slower
than unrolled copies; on the H100 the batch issues fewer device ops and its
one label launch takes less time than L single ones (``PERF.md``), so the
port has no switch and batches whenever the rig is uniform.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import numpy as np
import torch

from mloam_tpu_torch import resolve_device
from mloam_tpu_torch.config import MloamConfig
from mloam_tpu_torch.core import rangeimage as RI
from mloam_tpu_torch.core import rotations as rot
from mloam_tpu_torch.core import se3
from mloam_tpu_torch.core.rangeimage import RangeImage
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.frontend import features as F
from mloam_tpu_torch.frontend import segmentation as S
from mloam_tpu_torch.frontend.features import (FeatCloud, FeatureFrame,
                                               downsample_featcloud)
from mloam_tpu_torch.loop import posegraph as PGraph
from mloam_tpu_torch.mapping import mapper as MP
from mloam_tpu_torch.odometry import estimator as E
from mloam_tpu_torch.odometry import initializer as I
from mloam_tpu_torch.odometry import tracker as TR
from mloam_tpu_torch.utils import timing


class OdometryOutput(NamedTuple):
    pose: Pose            # world <- base at sweep start (refined)
    pose_predict: Pose    # tracker-only prediction (high-rate path)
    extrinsics: Pose      # [L] current base <- lidar estimates
    ext_mode: int         # live ESTIMATE_EXTRINSIC state
    cost: torch.Tensor
    n_corner: torch.Tensor
    n_surf: torch.Tensor
    # degeneracy diagnostics: full [n_blocks, 6] ascending measurement
    # eigenvalues per window block, and the tracker solve's [6] ascending
    # eigenvalues (zeros when tracker remap is off). None on paths that skip
    # the solve.
    win_eig: torch.Tensor | None = None
    trk_eig: torch.Tensor | None = None
    # [n_blocks] directions actually frozen by the window solve's projector
    win_frozen: torch.Tensor | None = None
    # [6] the shared-mean block spectrum the remap gate sees
    win_eig_shared: torch.Tensor | None = None
    # [6] its weakest eigvector (candidate frozen direction, up to sign)
    win_weak_dir: torch.Tensor | None = None
    win_support_neff: torch.Tensor | None = None


def _stack(fs) -> FeatCloud:
    """L clouds [N, ...] -> one [L, N, ...] (a view when L == 1)."""
    if len(fs) == 1:
        return FeatCloud(*(x[None] for x in fs[0]))
    return FeatCloud(*(torch.stack(x) for x in zip(*fs)))


def _index(tree, k):
    """Slot ``k`` of every field of a (named) tuple of stacked arrays."""
    return type(tree)(*(f[k] for f in tree))


def _stack_frames(imgs, device):
    """L synchronized sweeps of one sensor model -> one batch [L, ...]: a
    RangeImage on ``device``, or a PackedFrame (host wire arrays stacked on
    the host, so the rig's sweep crosses to the device in one copy)."""
    if isinstance(imgs[0], RI.PackedFrame):
        return RI.PackedFrame(*(np.stack(f) if isinstance(f[0], np.ndarray)
                                else torch.stack(f) for f in zip(*imgs)))
    return RangeImage(*(torch.stack([x.to(device) for x in f]) for f in zip(*imgs)))


class OdometryPipeline:
    """Single- or multi-LiDAR odometry front-to-back (no mapping backend).

    Call ``process(imgs)`` once per sweep with a list of L synchronized
    RangeImages (or PackedFrames), one per lidar. Returns an OdometryOutput.
    Runs on ``device`` — the GPU unless the caller passes another; raises
    when that device is absent.
    """

    def __init__(self, cfg: MloamConfig, device=None, sync_timing: bool = False):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.sync_timing = sync_timing
        self._rays = [RI.unit_rays(m, device=self.device)
                      for m in cfg.rig.models]
        # the batched frontend of the steady step (module docstring)
        models = cfg.rig.models
        self._uniform_rig = len(models) > 1 and all(m == models[0] for m in models)
        self.reset()

    def reset(self):
        """Reset all mutable state (the reference's restart semantics)."""
        cfg = self.cfg
        L = cfg.rig.n_lidars
        dev = self.device
        self.frame_idx = 0
        self.ext_mode = cfg.rig.extrinsic_mode if L > 1 else 0
        self.window = E.init_window(
            cfg, cfg.odometry.cap_frame_corner, cfg.odometry.cap_frame_surf,
            device=dev)
        if self.ext_mode == 1:
            # starting directly in refinement mode: the marginalization
            # prior spans [opt poses | extrinsic blocks] from frame 0
            self.window = E.reset_prior(self.window, cfg, calibrate_ext=True)
        self.prev_feats: list[FeatureFrame | None] = [None] * L
        self.last_outlier: list = [None] * L
        self.motions: list[Pose] = [Pose.identity(device=dev) for _ in range(L)]
        self.world_pose: Pose = Pose.identity(device=dev)
        self.calib_buffers = [I.MotionBuffer.empty(cfg.calib.n_pose_buffer, dev)
                              for _ in range(L)]
        # per-lidar motion accumulated over calib.pair_stride sweeps: longer
        # baselines raise the pair SNR (tracker noise is absolute while the
        # signal grows with the stride)
        self.pair_accum: list[Pose] = [Pose.identity(device=dev) for _ in range(L)]
        self.ext_samples: list[list] = [[] for _ in range(L)]
        self.ext_cov: np.ndarray | None = None

    def set_extrinsics(self, ext: Pose):
        """Install known extrinsics [L] (base <- lidar; lidar 0 the
        reference, its extrinsic the identity). In mode 1 the prior is re-initialized so the extrinsic
        prior rows pull toward the installed values."""
        self.window = E.set_extrinsics(self.window, Pose(
            ext.q.to(self.device, torch.float32), ext.t.to(self.device, torch.float32)))
        if self.ext_mode == 1:
            self.window = E.reset_prior(self.window, self.cfg, calibrate_ext=True)

    # ---------------- per-sweep stages ----------------

    def _frontend_impl(self, img, model_idx: int = 0):
        model = self.cfg.rig.models[model_idx]
        if isinstance(img, RI.PackedFrame):
            # wire-format input: reconstruct the f32 range image on the
            # device from the u16 ranges and the constant ray table
            img = RI.unpack_frame(img, self._rays[model_idx], model)
        else:
            img = RangeImage(*(x.to(self.device) for x in img))
        seg = S.segment(img, model, self.cfg.segmenter)
        ff = F.extract(img, seg.segmented, self.cfg.features)
        corner = downsample_featcloud(
            ff.less_sharp, self.cfg.odometry.corner_map_leaf,
            self.cfg.odometry.cap_frame_corner,
        )
        surf = downsample_featcloud(
            ff.less_flat, self.cfg.odometry.surf_map_leaf,
            self.cfg.odometry.cap_frame_surf,
        )
        # segmentation rejects as a third feature class for map completeness
        # (stored for the mapper's keyframes, not matched)
        *lead, r, c = img.rng.shape
        rows = torch.arange(r, dtype=torch.int32, device=self.device)[:, None] \
            .expand(img.rng.shape).reshape(*lead, -1)
        out_fc = FeatCloud(
            xyz=img.xyz.reshape(*lead, -1, 3),
            mask=seg.outlier.reshape(*lead, -1),
            time=img.time.reshape(*lead, -1),
            ring=rows,
        )
        outlier = downsample_featcloud(
            out_fc, self.cfg.mapping.outlier_leaf,
            self.cfg.mapping.cap_frame_outlier,
            precap=2 * self.cfg.mapping.cap_frame_outlier,
        )
        return ff, corner, surf, outlier

    def _frontends(self, imgs, batched: bool = False):
        """Every lidar's frontend: (ffs, corners, surfs, outliers) lists.
        ``batched``: the rig's sweeps stacked and run as one frontend over
        the batch (model 0's), its outputs split per lidar."""
        if not batched:
            outs = [self._frontend_impl(img, l) for l, img in enumerate(imgs)]
            return tuple(list(x) for x in zip(*outs))
        ff, corner, surf, outlier = self._frontend_impl(
            _stack_frames(imgs, self.device), 0)
        lidars = range(len(imgs))
        return ([FeatureFrame(*(_index(fc, l) for fc in ff)) for l in lidars],
                [_index(corner, l) for l in lidars],
                [_index(surf, l) for l in lidars],
                [_index(outlier, l) for l in lidars])

    def _track(self, prev: FeatureFrame, curr: FeatureFrame, T: Pose):
        return TR.track(prev, curr, T, self.cfg.tracker)

    def _prep_frame(self, ext: Pose, motion0: Pose, motions, corners, surfs,
                    mode2: bool):
        """De-skew per lidar with its own sweep motion and stack to [L, ...].

        Lidar l's motion is the reference motion seen through its extrinsic,
        E⁻¹∘M∘E; in mode 2 (extrinsics unknown) lidars l > 0 use their own
        tracked motion. The reference lidar is the base frame (its extrinsic
        is the identity), so it takes the reference motion as it is."""
        if not self.cfg.tracker.deskew:
            return _stack(corners), _stack(surfs)
        cs, ss = [], []
        for l in range(self.cfg.rig.n_lidars):
            if l == 0:
                m_l = motion0
            elif mode2:
                m_l = motions[l]
            else:
                El = Pose(ext.q[l], ext.t[l])
                m_l = se3.compose(se3.compose(se3.inverse(El), motion0), El)
            cs.append(TR.deskew_features(m_l, corners[l]))
            ss.append(TR.deskew_features(m_l, surfs[l]))
        return _stack(cs), _stack(ss)

    def _push_only(self, window, world_pose, motion0, motions, corners, surfs,
                   mode2):
        pred = se3.compose(world_pose, motion0)
        corner, surf = self._prep_frame(window.ext, motion0, motions,
                                        corners, surfs, mode2)
        window = E.push_frame(window, pred, corner, surf, self.cfg)
        return window, pred

    def _push_first(self, window, world_pose, corners, surfs):
        return E.push_frame(window, world_pose, _stack(corners),
                            _stack(surfs), self.cfg)

    def _window_step_impl(self, window, world_pose, motion0, motions,
                          corners, surfs, mode2, calibrate_ext, lidars):
        """Push + window solve + marginalization. The JAX package's
        ``_window_ref`` (mode 2: ``lidars=(0,)``), ``_window_calib`` (mode 1:
        ``calibrate_ext``) and ``_window_all`` (mode 0)."""
        pred = se3.compose(world_pose, motion0)
        corner, surf = self._prep_frame(window.ext, motion0, motions,
                                        corners, surfs, mode2)
        window = E.push_frame(window, pred, corner, surf, self.cfg)
        window, solve = E.optimize_window(window, self.cfg, calibrate_ext,
                                          lidars)
        window = E.marginalize_pivot(window, solve, self.cfg, calibrate_ext)
        refined = Pose(window.poses.q[-1], window.poses.t[-1])
        return window, solve, pred, refined

    def _fused_step_impl(self, window, world_pose, motion0, prev_feat0, imgs):
        """Whole-sweep step of the steady pure-odometry phase (ext_mode 0,
        window full): every lidar's frontend (one batched frontend for the
        rig when ``_uniform_rig``), the reference-lidar tracker,
        de-skew of every lidar through its extrinsic, window solve over all
        lidars' correspondences and marginalization, each stage under its
        timer.

        With ``tracker.skip_steady`` there is no tracker: the constant-
        velocity motion ``motion0`` seeds the window and de-skews every
        lidar, the window's scan-to-local-map solve refines it, and the next
        motion is the refined inter-sweep motion read back off the window,
        inverse(poses[-2]) ∘ poses[-1]; no tracker spectrum is returned."""
        L = self.cfg.rig.n_lidars
        with timing.timer("odom_mea_pre", sync=self.sync_timing):
            ffs, corners, surfs, outliers = self._frontends(
                imgs, batched=self._uniform_rig)
        skip = self.cfg.tracker.skip_steady
        with timing.timer("odom_tracker", sync=self.sync_timing):
            if skip:
                motion, trk_eig = motion0, None
                desk = (FeatureFrame(*(TR.deskew_features(motion0, f) for f in ffs[0]))
                        if self.cfg.tracker.deskew else ffs[0])
            else:
                res, desk = self._track(prev_feat0, ffs[0], motion0)
                motion, trk_eig = res.pose, res.eig
        with timing.timer("odom_solver", sync=self.sync_timing):
            window, solve, pred, refined = self._window_step_impl(
                window, world_pose, motion, (motion,) * L, corners, surfs,
                mode2=False, calibrate_ext=False, lidars=tuple(range(L)))
        if skip:
            motion = se3.compose(
                se3.inverse(Pose(window.poses.q[-2], window.poses.t[-2])), refined)
        return (window, refined, motion, desk, pred, solve, tuple(outliers),
                trk_eig)

    def _steady(self, imgs) -> tuple:
        """One steady sweep: the fused step, and the host state it moves."""
        (self.window, refined, motion, desk, pred, solve, outliers,
         trk_eig) = self._fused_step_impl(
            self.window, self.world_pose, self.motions[0],
            self.prev_feats[0], imgs)
        self.motions[0] = motion
        self.prev_feats[0] = desk
        self.last_outlier = list(outliers)
        self.world_pose = refined
        self.frame_idx += 1
        return refined, pred, solve, trk_eig

    def _is_steady(self) -> bool:
        # a pipeline restored from a checkpoint has no previous sweep's
        # features: it re-enters through the first-sweep branch, as the JAX
        # package's does (its fused paths require prev_feats[0] too)
        return (self.ext_mode == 0 and self.prev_feats[0] is not None
                and self.frame_idx >= self.cfg.odometry.window_size)

    @torch.no_grad()
    def process_chunk(self, imgs_stacked):
        """Process K synchronized sweeps (replay). Preconditions: the steady
        step must be active (warm window, pure odometry). ``imgs_stacked``:
        for L == 1 a RangeImage/PackedFrame with a leading K axis; for L > 1
        a tuple of L such.

        Returns per-frame stacked (pose_q [K,4], pose_t [K,3], pred_q,
        pred_t, cost, n_corner, n_surf). The state advances exactly as K
        ``process`` calls would: the same step in the same order."""
        L = self.cfg.rig.n_lidars
        if not self._is_steady():
            raise RuntimeError(
                "process_chunk requires the steady pure-odometry phase "
                "(ext_mode 0, window full, a previous sweep tracked)")
        per_lidar = (imgs_stacked,) if L == 1 else tuple(imgs_stacked)
        if len(per_lidar) != L:
            raise ValueError(f"process_chunk: {len(per_lidar)} sequences for {L} lidars")
        k = per_lidar[0][0].shape[0]
        ys = []
        for i in range(k):
            refined, pred, solve, _ = self._steady([_index(x, i) for x in per_lidar])
            ys.append((refined.q, refined.t, pred.q, pred.t, solve.cost,
                       solve.n_corner, solve.n_surf))
        return tuple(torch.stack(y) for y in zip(*ys))

    # ---------------- calibration lifecycle ----------------

    def _try_init_calib(self):
        """Hand-eye solve for every non-ref lidar; install on convergence."""
        cfg = self.cfg
        exts = [Pose.identity(device=self.device)]
        for l in range(1, cfg.rig.n_lidars):
            est, rsol = I.calibrate(self.calib_buffers[l],
                                    planar=cfg.calib.planar,
                                    sv_threshold=cfg.calib.rot_converge_sv)
            if not bool(rsol.converged):
                return
            exts.append(est)
        ext = Pose(torch.stack([e.q for e in exts]),
                   torch.stack([e.t for e in exts]))
        self.window = E.set_extrinsics(self.window, ext)
        self.window = E.reset_prior(self.window, cfg, calibrate_ext=True)
        self.ext_mode = 1

    def _collect_calib_sample(self, solve):
        """Extrinsic voting: collect samples whenever an extrinsic Hessian
        block is well-conditioned; freeze the Lie mean after
        n_calib_samples."""
        cfg = self.cfg
        L = cfg.rig.n_lidars
        n_opt = cfg.odometry.opt_window_size + 1
        eig = solve.eig_min.cpu().numpy()
        done = True
        for l in range(1, L):
            if eig[n_opt + (l - 1)] > cfg.calib.lambda_threshold:
                self.ext_samples[l].append(
                    (self.window.ext.q[l].cpu().numpy(),
                     self.window.ext.t[l].cpu().numpy()))
            if len(self.ext_samples[l]) < cfg.calib.n_calib_samples:
                done = False
        if not done:
            return
        exts_q = [np.array([1.0, 0, 0, 0], np.float32)]
        exts_t = [np.zeros(3, np.float32)]
        covs = []
        for l in range(1, L):
            qs = torch.from_numpy(np.stack([s[0] for s in self.ext_samples[l]]))
            ts = torch.from_numpy(np.stack([s[1] for s in self.ext_samples[l]]))
            # drop the first third (the reference's computeMeanPose)
            k = qs.shape[0] // 3
            samples = Pose(qs[k:].to(self.device), ts[k:].to(self.device))
            mu = se3.mean_pose(samples)
            cov = se3.tangent_scatter(samples, mu)
            exts_q.append(mu.q.cpu().numpy())
            exts_t.append(mu.t.cpu().numpy())
            covs.append(cov.cpu().numpy())
        ext = Pose(torch.from_numpy(np.stack(exts_q)).to(self.device),
                   torch.from_numpy(np.stack(exts_t)).to(self.device))
        self.ext_cov = np.stack(covs)
        self.window = E.set_extrinsics(self.window, ext)
        self.window = E.reset_prior(self.window, cfg, calibrate_ext=False)
        self.ext_mode = 0

    # ---------------- host orchestration ----------------

    def _solved_output(self, refined, pred, solve, trk_eig) -> OdometryOutput:
        return OdometryOutput(
            pose=refined, pose_predict=pred, extrinsics=self.window.ext,
            ext_mode=self.ext_mode, cost=solve.cost,
            n_corner=solve.n_corner, n_surf=solve.n_surf,
            win_eig=solve.eig_blocks, trk_eig=trk_eig,
            win_frozen=solve.frozen, win_eig_shared=solve.eig_shared,
            win_weak_dir=solve.weak_dir,
            win_support_neff=solve.support_neff,
        )

    @torch.no_grad()
    def process(self, imgs: list) -> OdometryOutput:
        cfg = self.cfg
        L = cfg.rig.n_lidars
        assert len(imgs) == L

        # steady pure odometry: the whole-sweep step
        if self._is_steady():
            return self._solved_output(*self._steady(imgs))

        with timing.timer("odom_mea_pre", sync=self.sync_timing):
            ffs, corners, surfs, outliers = self._frontends(imgs)
            self.last_outlier = outliers

        if self.prev_feats[0] is None:
            self.prev_feats = ffs
            pose = self.world_pose
            self.window = self._push_first(self.window, pose, corners, surfs)
            self.frame_idx += 1
            zero = torch.zeros((), device=self.device)
            return OdometryOutput(
                pose=pose, pose_predict=pose, extrinsics=self.window.ext,
                ext_mode=self.ext_mode, cost=zero,
                n_corner=zero.to(torch.int64), n_surf=zero.to(torch.int64),
            )

        # --- scan-to-scan tracking (the reference always; all lidars in
        # mode 2)
        with timing.timer("odom_tracker", sync=self.sync_timing):
            res0, desk0 = self._track(self.prev_feats[0], ffs[0], self.motions[0])
        self.motions[0] = res0.pose
        new_prev = [desk0]
        mode2 = self.ext_mode == 2
        if mode2:
            self.pair_accum[0] = se3.compose(self.pair_accum[0], res0.pose)
            for l in range(1, L):
                res_l, desk_l = self._track(self.prev_feats[l], ffs[l],
                                            self.motions[l])
                self.motions[l] = res_l.pose
                new_prev.append(desk_l)
                self.pair_accum[l] = se3.compose(self.pair_accum[l], res_l.pose)
            if self.frame_idx % cfg.calib.pair_stride == 0:
                for l in range(1, L):
                    self.calib_buffers[l] = I.add_pair(
                        self.calib_buffers[l], self.pair_accum[0],
                        self.pair_accum[l],
                        eps_r=cfg.calib.screw_rot_epsilon,
                        eps_t=cfg.calib.screw_trans_epsilon)
                self.pair_accum = [Pose.identity(device=self.device)
                                   for _ in range(L)]
                self._try_init_calib()
        else:
            new_prev += ffs[1:]
        self.prev_feats = new_prev

        step_args = (
            self.window, self.world_pose, res0.pose, tuple(self.motions),
            tuple(corners), tuple(surfs),
        )
        if self.frame_idx >= cfg.odometry.window_size:
            # the solve follows the mode as it stands now (a hand-eye success
            # this sweep already solves with the extrinsic blocks), the
            # de-skew the mode the sweep was tracked in
            calibrate_ext = self.ext_mode == 1
            lidars = (0,) if self.ext_mode == 2 else tuple(range(L))
            with timing.timer("odom_solver", sync=self.sync_timing):
                self.window, solve, pred, refined = self._window_step_impl(
                    *step_args, mode2=mode2, calibrate_ext=calibrate_ext,
                    lidars=lidars)
            self.world_pose = refined
            if self.ext_mode == 1:
                self._collect_calib_sample(solve)
            out = self._solved_output(refined, pred, solve, res0.eig)
        else:
            self.window, pred = self._push_only(*step_args, mode2=mode2)
            self.world_pose = pred
            out = OdometryOutput(
                pose=pred, pose_predict=pred, extrinsics=self.window.ext,
                ext_mode=self.ext_mode, cost=res0.cost,
                n_corner=res0.n_edge, n_surf=res0.n_plane,
                trk_eig=res0.eig,
            )
        self.frame_idx += 1
        return out


class FullOutput(NamedTuple):
    odom: OdometryOutput
    map_pose: Pose            # map <- base (best available estimate)
    map_cov: torch.Tensor | None
    mapped: bool              # whether the mapper ran this sweep
    # smallest eigenvalue of the scan-to-map Hessian on mapped sweeps (the
    # mapper's degeneracy probe); None on pass-through sweeps
    map_eig_min: torch.Tensor | None = None
    # device bool: the mapper inserted a keyframe this sweep (None on
    # pass-through sweeps); not read here
    inserted_kf: torch.Tensor | None = None
    # directions the mapper's remap froze this sweep (None on pass-through)
    map_frozen: torch.Tensor | None = None


class FullPipeline:
    """Odometry + uncertainty-aware keyframe mapping.

    Counterpart of ``mloam_tpu/models/pipeline.py:FullPipeline`` (the
    reference's odometry node + lidar_mapper_keyframe node): the mapper
    consumes every ``mapping.skip_frames``-th sweep once the window is warm
    and maintains the map<-odom drift correction; between mapping updates
    the corrected odometry pose is reported. Whether a sweep is mapped is
    decided by host integers. Runs on ``device``: the GPU unless the caller
    passes another; raises when that device is absent.
    """

    def __init__(self, cfg: MloamConfig, device=None, sync_timing: bool = False):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.sync_timing = sync_timing
        self.odom = OdometryPipeline(cfg, device=self.device, sync_timing=sync_timing)
        self.mapper_state = MP.init_state(cfg, device=self.device)
        # whether the calibrated extrinsic covariance has been installed into
        # the mapper (the reference mapper reads it off /extrinsics once the
        # calibration status drops to 0)
        self._ext_cov_installed = False
        # last mapped sweep's merged (corner, surf) base-frame clouds, for the
        # loop-closure pipeline's keyframe handling
        self.last_merged = None

    def _install_ext_cov(self):
        """Plumb the frozen calibration covariance (``OdometryPipeline.ext_cov``,
        set at the ESTIMATE_EXTRINSIC 1->0 transition) into the mapper: from
        then on mapping runs on the calibrated extrinsic uncertainty instead
        of the config prior."""
        L = self.cfg.rig.n_lidars
        ec = np.zeros((L, 6, 6), np.float32)
        ec[1:] = np.asarray(self.odom.ext_cov)
        self.mapper_state = self.mapper_state._replace(
            ext_cov=torch.from_numpy(ec).to(self.device))
        self._ext_cov_installed = True

    @staticmethod
    def _merge_outlier_impl(ext: Pose, outliers) -> FeatCloud:
        """Project per-lidar outlier clouds through the extrinsics into the
        base frame and concatenate."""
        parts = [fc._replace(xyz=se3.transform_points(Pose(ext.q[l], ext.t[l]), fc.xyz))
                 for l, fc in enumerate(outliers)]
        return FeatCloud(*(torch.cat(x) for x in zip(*parts)))

    def _merge_impl(self, ext: Pose, corner_stack: FeatCloud, surf_stack: FeatCloud):
        """The newest window slot of each lidar, projected through the
        extrinsics into the base frame and concatenated in lidar order."""
        L = self.cfg.rig.n_lidars

        def proj(stack):
            return self._merge_outlier_impl(
                ext, [_index(_index(stack, -1), l) for l in range(L)])

        return proj(corner_stack), proj(surf_stack)

    @torch.no_grad()
    def process(self, imgs: list) -> FullOutput:
        cfg = self.cfg
        out = self.odom.process(imgs)
        if not self._ext_cov_installed and self.odom.ext_cov is not None:
            self._install_ext_cov()
        idx = self.odom.frame_idx - 1  # frame just processed
        run_map = idx % cfg.mapping.skip_frames == 0 and idx >= cfg.odometry.window_size
        if run_map:
            win = self.odom.window
            corner_b, surf_b = self._merge_impl(win.ext, win.corner, win.surf)
            outlier_b = self._merge_outlier_impl(win.ext, self.odom.last_outlier)
            with timing.timer("map_step", sync=self.sync_timing):
                self.mapper_state, mout = MP.mapper_step(
                    self.mapper_state, out.pose, corner_b, surf_b, cfg,
                    outlier=outlier_b)
            timing.record("map_step_rebuild" if mout.stale else "map_step_reuse",
                          timing.last("map_step"))
            self.last_merged = (corner_b, surf_b)
            return FullOutput(
                odom=out, map_pose=mout.pose, map_cov=mout.cov, mapped=True,
                map_eig_min=mout.eig_min, inserted_kf=mout.inserted_kf,
                map_frozen=mout.frozen)
        map_pose = se3.compose(self.mapper_state.pose_map_odom, out.pose)
        return FullOutput(odom=out, map_pose=map_pose, map_cov=None, mapped=False)


class SlamOutput(NamedTuple):
    full: FullOutput
    loop_found: bool
    n_loops: int


# the SLAM layer's host waits, by kind: the one-sweep-old flags behind their
# events (keyframe inserted, loop verified) and the loop-correction read of a
# verified loop (``SlamPipeline._accept_loop``)
waits: collections.Counter = collections.Counter()


class _Deferred:
    """Device values copied to pinned host memory behind a CUDA event, read
    a sweep later: ``get`` waits for that event only, not for the work queued
    since (``bool`` of a CUDA tensor would wait for all of it). On the CPU
    the values are kept as they are."""

    def __init__(self, kind: str, *values: torch.Tensor):
        self.kind = kind
        self.event = None
        if values[0].is_cuda:
            self.host = [torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                         for v in values]
            for h, v in zip(self.host, values):
                h.copy_(v, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = list(values)

    def get(self) -> list:
        if self.event is not None:
            self.event.synchronize()
            waits[self.kind] += 1
        return [h.item() for h in self.host]


class SlamPipeline:
    """Complete system: odometry + keyframe mapping + loop closure.

    Counterpart of ``mloam_tpu/models/pipeline.py:SlamPipeline`` (the
    reference's three processes: odometry, mapping, loop closure, here one
    host loop). Every ``loop.skip_interval``-th keyframe the mapper inserts
    enters the loop graph; a verified loop is recorded and triggers the
    pose-graph optimization. As in the reference the loop-corrected
    keyframe trajectory is a separate output; the mapper's frame is not
    rewritten.

    The JAX package's one-sweep pipelining is kept: a mapped sweep's
    keyframe flag is read at the next sweep (``_drain_kf``), which then
    adds the keyframe and submits detection + verification without reading
    anything; that result is read one sweep later (``_drain_verify``).
    Each read waits on an event recorded right after the value's copy into
    pinned host memory, never on the work queued since. A verified loop
    reads the poses it corrects (``_accept_loop``, the temporal-consistency
    gate) and runs the optimization. ``loop_kf_count`` mirrors the graph's
    keyframe count on the host. Runs on ``device``: the GPU unless the
    caller passes another; raises when that device is absent.
    """

    def __init__(self, cfg: MloamConfig, loop_capacity: int | None = None,
                 device=None, sync_timing: bool = False):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.full = FullPipeline(cfg, device=self.device, sync_timing=sync_timing)
        self._loop_capacity = int(loop_capacity if loop_capacity is not None
                                  else cfg.loop.capacity)
        self.loop_state = PGraph.init_state(
            self._loop_capacity,
            cfg.rig.n_lidars * cfg.odometry.cap_frame_corner,
            cfg.rig.n_lidars * cfg.odometry.cap_frame_surf,
            cfg.loop, device=self.device)
        self.kf_counter = 0
        self.n_loops = 0
        self.loop_kf_count = 0
        # detections submitted so far (each runs try_close_loop once)
        self.n_detections = 0
        # detections awaiting temporal consistency:
        # (query_idx, cand_idx, zq, zt, correction_t [3])
        self._pending_loops: list = []
        # in flight: (query_idx, _Deferred(found, cand), zq, zt)
        self._pending_verify = None
        # in flight: (_Deferred(inserted_kf), map pose, merged clouds)
        self._pending_kf = None

    def _loop_correction_t(self, q_idx: int, cand: int, zt) -> np.ndarray:
        """Translation the loop edge would apply to the query keyframe:
        (T_cand ∘ Z).t − T_query.t. Used by the temporal-consistency gate."""
        ls = self.loop_state
        corr = (rot.quat_rotate(ls.poses.q[cand], zt) + ls.poses.t[cand]
                - ls.poses.t[q_idx])
        waits["loop_correction_read"] += 1
        return corr.cpu().numpy()

    def _accept_loop(self, q_idx: int, cand: int, zq, zt) -> bool:
        """Temporal-consistency gate: ``temporal_consistency_n`` detections
        implying the same drift correction (within tol meters) before the
        edges are recorded and the graph optimized. With n = 1 (the default,
        the reference's pass-through check) every verified detection is
        committed at once."""
        lc = self.cfg.loop
        corr = self._loop_correction_t(q_idx, cand, zt)
        window = 2 * max(lc.skip_interval, 1) + 2
        self._pending_loops = [p for p in self._pending_loops if q_idx - p[0] <= window]
        self._pending_loops.append((q_idx, cand, zq, zt, corr))
        consistent = [p for p in self._pending_loops
                      if np.linalg.norm(p[4] - corr) < lc.temporal_consistency_tol]
        if len(consistent) < max(lc.temporal_consistency_n, 1):
            return False
        for qi, cj, pzq, pzt, _ in consistent:
            self.loop_state = PGraph.record_loop(self.loop_state, True, cj, qi, pzq, pzt)
        self._pending_loops = []
        self.loop_state = PGraph.optimize(self.loop_state, iters=lc.pgo_gn_iters,
                                          dof4=lc.dof4)
        self.n_loops += len(consistent)
        return True

    def corrected_trajectory(self):
        """Loop-corrected keyframe trajectory (t [n, 3], q [n, 4], numpy)
        after draining the in-flight keyframe and verification."""
        self.flush()
        n = self.loop_kf_count
        return (self.loop_state.poses.t[:n].cpu().numpy(),
                self.loop_state.poses.q[:n].cpu().numpy())

    def _drain_verify(self) -> bool:
        """Read the previous sweep's detection / verification and commit an
        accepted loop."""
        if self._pending_verify is None:
            return False
        q_idx, flags, zq, zt = self._pending_verify
        self._pending_verify = None
        found, cand = flags.get()
        if found:
            return self._accept_loop(q_idx, int(cand), zq, zt)
        return False

    def _drain_kf(self):
        """Handle the previous mapped sweep's keyframe: if the mapper
        inserted one and it is a loop-interval keyframe, add it to the loop
        graph and submit detection + verification, read at the next
        sweep."""
        lc = self.cfg.loop
        if self._pending_kf is None:
            return
        flag, map_pose, (corner_b, surf_b) = self._pending_kf
        self._pending_kf = None
        if not flag.get()[0]:
            return
        self.kf_counter += 1
        if self.kf_counter % max(lc.skip_interval, 1) != 0:
            return
        self.loop_state = PGraph.add_keyframe(self.loop_state, map_pose, corner_b,
                                              surf_b, lc)
        if self.loop_kf_count < self._loop_capacity:
            self.loop_kf_count += 1
        q_idx = self.loop_kf_count - 1
        if q_idx > lc.num_exclude_recent:
            found, cand, zq, zt, _, _ = PGraph.try_close_loop(
                self.loop_state, q_idx, lc, self.cfg,
                use_global_reg=lc.use_global_registration)
            self._pending_verify = (q_idx, _Deferred("verify_event", found, cand), zq, zt)
            self.n_detections += 1

    @torch.no_grad()
    def process(self, imgs: list) -> SlamOutput:
        out = self.full.process(imgs)
        loop_found = self._drain_verify()
        self._drain_kf()
        if out.mapped and out.inserted_kf is not None:
            self._pending_kf = (_Deferred("kf_flag_event", out.inserted_kf),
                                out.map_pose, self.full.last_merged)
        return SlamOutput(full=out, loop_found=loop_found, n_loops=self.n_loops)

    @torch.no_grad()
    def flush(self) -> bool:
        """Drain the in-flight keyframe handling and loop verification (end
        of sequence)."""
        found = self._drain_verify()
        self._drain_kf()
        return self._drain_verify() or found
