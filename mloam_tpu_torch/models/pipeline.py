"""End-to-end odometry pipeline assembly: single-LiDAR, sweep to pose.

Counterpart of ``mloam_tpu/models/pipeline.py:OdometryPipeline``. PyTorch
runs eagerly, so what the JAX package fuses into one jitted program per sweep
is plain composition here; the method names are kept so a reader finds the
counterpart:

  first sweep     frontend + ``_push_first``
  warm-up         frontend + ``_track`` + ``_push_only``
  window full     ``_fused_step_impl``: frontend + tracker + de-skew + window
                  solve + marginalization (``_window_all``)

The JAX package runs its first sweep with a full window unfused (the "warm
window" step) and fuses the steady ones; with nothing to fuse the two are
the same code here, so every sweep from the ``window_size``-th on takes
``_fused_step_impl``. Its three stages run under the stage timers
``odom_mea_pre`` / ``odom_tracker`` / ``odom_solver`` (``utils/timing``).

Per sweep the hand-written kernels run once for label propagation
(``ops/hopper_labels``) and four times for k-NN (``ops/hopper_knn``: two
scan-to-scan matchers in the tracker, two map matchers in the window solve).

Not ported yet, each refused with ``NotImplementedError``: multi-LiDAR rigs
(and with them the online calibration lifecycle, ``ext_mode`` 1/2),
``process_chunk``, the tracker-less steady path (``skip_steady``), and the
mapping / loop-closure pipelines.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mloam_tpu_torch import resolve_device
from mloam_tpu_torch.config import MloamConfig
from mloam_tpu_torch.core import rangeimage as RI
from mloam_tpu_torch.core import se3
from mloam_tpu_torch.core.rangeimage import RangeImage
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.frontend import features as F
from mloam_tpu_torch.frontend import segmentation as S
from mloam_tpu_torch.frontend.features import (FeatCloud, FeatureFrame,
                                               downsample_featcloud)
from mloam_tpu_torch.odometry import estimator as E
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


def _stack1(f: FeatCloud) -> FeatCloud:
    """[N, ...] -> [L=1, N, ...]."""
    return FeatCloud(*(x[None] for x in f))


class OdometryPipeline:
    """Single-LiDAR odometry front-to-back (no mapping backend).

    Call ``process(imgs)`` once per sweep with a list holding one RangeImage
    (or PackedFrame). Returns an OdometryOutput. Runs on ``device`` — the GPU
    unless the caller passes another; raises when that device is absent.
    """

    def __init__(self, cfg: MloamConfig, device=None):
        self.device = resolve_device(device)
        L = cfg.rig.n_lidars
        if L > 1:
            raise NotImplementedError(
                "n_lidars > 1: the multi-LiDAR steady step, and with it "
                "ext_mode 1/2, is not ported yet (ROADMAP: multi-lidar step, "
                "then A9)")
        # the window solve refuses what it has not ported; fail at
        # construction, not at the first warm sweep
        E.refuse_unported(cfg, calibrate_ext=False, analytic=True)
        if cfg.tracker.skip_steady:
            raise NotImplementedError(
                "tracker.skip_steady=True: the tracker-less steady path is "
                "not ported yet (ROADMAP A10, with the tuned operating points)")
        if cfg.tracker.loss_mode != "huber":
            raise NotImplementedError(
                f"tracker.loss_mode={cfg.tracker.loss_mode!r}: only 'huber' "
                "is ported (ROADMAP A10)")
        self.cfg = cfg
        self._rays = [RI.unit_rays(m, device=self.device)
                      for m in cfg.rig.models]
        self.reset()

    def reset(self):
        """Reset all mutable state."""
        cfg = self.cfg
        self.frame_idx = 0
        self.ext_mode = 0
        self.window = E.init_window(
            cfg, cfg.odometry.cap_frame_corner, cfg.odometry.cap_frame_surf,
            device=self.device)
        self.prev_feats: list[FeatureFrame | None] = [None]
        self.last_outlier: list = [None]
        self.motions: list[Pose] = [Pose.identity(device=self.device)]
        self.world_pose: Pose = Pose.identity(device=self.device)

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
        r, c = img.rng.shape
        rows = torch.arange(r, dtype=torch.int32, device=self.device)[:, None] \
            .expand(r, c).reshape(-1)
        out_fc = FeatCloud(
            xyz=img.xyz.reshape(-1, 3),
            mask=seg.outlier.reshape(-1),
            time=img.time.reshape(-1),
            ring=rows,
        )
        outlier = downsample_featcloud(
            out_fc, self.cfg.mapping.outlier_leaf,
            self.cfg.mapping.cap_frame_outlier,
            precap=2 * self.cfg.mapping.cap_frame_outlier,
        )
        return ff, corner, surf, outlier

    def _track(self, prev: FeatureFrame, curr: FeatureFrame, T: Pose):
        return TR.track(prev, curr, T, self.cfg.tracker)

    def _prep_frame(self, motion0: Pose, corner: FeatCloud, surf: FeatCloud):
        """De-skew with the sweep motion and stack to [L=1, ...]."""
        if self.cfg.tracker.deskew:
            corner = TR.deskew_features(motion0, corner)
            surf = TR.deskew_features(motion0, surf)
        return _stack1(corner), _stack1(surf)

    def _push_only(self, window, world_pose, motion0, corner, surf):
        pred = se3.compose(world_pose, motion0)
        corner, surf = self._prep_frame(motion0, corner, surf)
        window = E.push_frame(window, pred, corner, surf, self.cfg)
        return window, pred

    def _push_first(self, window, world_pose, corner, surf):
        return E.push_frame(window, world_pose, _stack1(corner),
                            _stack1(surf), self.cfg)

    def _window_all(self, window, world_pose, motion0, corner, surf):
        pred = se3.compose(world_pose, motion0)
        corner, surf = self._prep_frame(motion0, corner, surf)
        window = E.push_frame(window, pred, corner, surf, self.cfg)
        window, solve = E.optimize_window(window, self.cfg, False, (0,))
        window = E.marginalize_pivot(window, solve, self.cfg, False)
        refined = Pose(window.poses.q[-1], window.poses.t[-1])
        return window, solve, pred, refined

    def _fused_step_impl(self, window, world_pose, motion0, prev_feat0, img):
        """Whole-sweep step of the single-lidar pure-odometry path once the
        window is full: frontend + tracker + de-skew + window solve +
        marginalization, each stage under its timer."""
        with timing.timer("odom_mea_pre"):
            ff, corner, surf, outlier = self._frontend_impl(img, 0)
        with timing.timer("odom_tracker"):
            res, desk = self._track(prev_feat0, ff, motion0)
        with timing.timer("odom_solver"):
            window, solve, pred, refined = self._window_all(
                window, world_pose, res.pose, corner, surf)
        return window, refined, res.pose, desk, pred, solve, outlier, res.eig

    def process_chunk(self, imgs_stacked):
        raise NotImplementedError(
            "process_chunk: the chunked replay path is not ported yet "
            "(ROADMAP: multi-lidar step + process_chunk)")

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
        assert len(imgs) == 1

        # window full: the whole-sweep step
        if self.frame_idx >= cfg.odometry.window_size:
            (self.window, refined, motion, desk, pred,
             solve, outlier0, trk_eig) = self._fused_step_impl(
                self.window, self.world_pose, self.motions[0],
                self.prev_feats[0], imgs[0],
            )
            self.motions[0] = motion
            self.prev_feats[0] = desk
            self.last_outlier[0] = outlier0
            self.world_pose = refined
            self.frame_idx += 1
            return self._solved_output(refined, pred, solve, trk_eig)

        with timing.timer("odom_mea_pre"):
            ff, corner, surf, outlier = self._frontend_impl(imgs[0], 0)
            self.last_outlier[0] = outlier

        if self.prev_feats[0] is None:
            self.prev_feats = [ff]
            pose = self.world_pose
            self.window = self._push_first(self.window, pose, corner, surf)
            self.frame_idx += 1
            zero = torch.zeros((), device=self.device)
            return OdometryOutput(
                pose=pose, pose_predict=pose, extrinsics=self.window.ext,
                ext_mode=self.ext_mode, cost=zero,
                n_corner=zero.to(torch.int64), n_surf=zero.to(torch.int64),
            )

        # --- warm-up: scan-to-scan tracking fills the window, no solve yet
        with timing.timer("odom_tracker"):
            res0, desk0 = self._track(self.prev_feats[0], ff, self.motions[0])
        self.motions[0] = res0.pose
        self.prev_feats = [desk0]
        self.window, pred = self._push_only(
            self.window, self.world_pose, res0.pose, corner, surf)
        self.world_pose = pred
        self.frame_idx += 1
        return OdometryOutput(
            pose=pred, pose_predict=pred, extrinsics=self.window.ext,
            ext_mode=self.ext_mode, cost=res0.cost,
            n_corner=res0.n_edge, n_surf=res0.n_plane,
            trk_eig=res0.eig,
        )


class FullPipeline:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "FullPipeline: the keyframe mapper is not ported yet (ROADMAP A11)")


class SlamPipeline:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SlamPipeline: loop closure and pose-graph optimization are not "
            "ported yet (ROADMAP A12)")
