"""Per-platform configuration presets.

Counterpart of ``mloam_tpu/models/platforms.py`` (the reference's yaml
config set): SR (simulated jackal, 2x VLP-16), RHD (handheld, 2x VLP-16), RV
Hercules (vehicle, 4x VLP-16), Oxford (2x HDL-32), KITTI (1x HDL-64), and the
simulator fixture platform, and the operating points applied on top of any
preset: ``realtime_tuned`` and the indoor / degenerate-geometry
``indoor_degenerate``.
"""

from __future__ import annotations

import dataclasses

from mloam_tpu_torch.config import LidarRig, MloamConfig
from mloam_tpu_torch.core.rangeimage import LidarModel, hdl64_ring_table

VLP16 = LidarModel(n_rings=16, n_cols=1800, fov_up_deg=15.0, fov_down_deg=-15.0)
HDL32 = LidarModel(n_rings=32, n_cols=2160, fov_up_deg=10.67, fov_down_deg=-30.67)
HDL64 = LidarModel(n_rings=64, n_cols=1800, fov_up_deg=2.0, fov_down_deg=-24.8)
SIM16 = LidarModel(n_rings=16, n_cols=1800)


def _rig_budget(cfg: MloamConfig) -> MloamConfig:
    """Rig-normalized per-sweep feature budget for multi-lidar rigs.

    The window-solve cost scales with the TOTAL per-sweep feature count;
    overlapping-FOV lidars don't see L× the unique structure (local-map
    density is bounded by the voxel leaves), so the single-rig budget is
    split across the rig instead of multiplied by it."""
    L = cfg.rig.n_lidars
    if L <= 1:
        return cfg
    corner = max(768 // L, 256)
    surf = 2 * corner
    return dataclasses.replace(
        cfg,
        odometry=dataclasses.replace(
            cfg.odometry,
            cap_frame_corner=corner,
            cap_frame_surf=surf,
            localmap_precap_corner=2 * corner,
            localmap_precap_surf=5 * surf,
        ),
    )


def simu_jackal(n_lidars: int = 2, extrinsic_mode: int = 2) -> MloamConfig:
    """SR: config_simu_jackal.yaml (2x VLP-16, online calibration)."""
    return _rig_budget(MloamConfig(rig=LidarRig(models=(SIM16,) * n_lidars,
                                                extrinsic_mode=extrinsic_mode)))


def handheld(extrinsic_mode: int = 1) -> MloamConfig:
    """RHD: config_handheld.yaml (2x VLP-16)."""
    return _rig_budget(MloamConfig(rig=LidarRig(models=(VLP16, VLP16),
                                                extrinsic_mode=extrinsic_mode)))


def vehicle_hercules(extrinsic_mode: int = 1) -> MloamConfig:
    """RV: config_realvehicle_hercules.yaml (4x VLP-16)."""
    return _rig_budget(MloamConfig(rig=LidarRig(models=(VLP16,) * 4,
                                                extrinsic_mode=extrinsic_mode)))


def oxford(extrinsic_mode: int = 0) -> MloamConfig:
    """OR: config_realvehicle_oxford.yaml (2x HDL-32)."""
    return _rig_budget(MloamConfig(rig=LidarRig(models=(HDL32, HDL32),
                                                extrinsic_mode=extrinsic_mode)))


def kitti() -> MloamConfig:
    """KITTI: config_realvehicle_kitti.yaml (1x HDL-64, fixed extrinsics),
    with the HDL-64's two-density beam ladder (uniform elevation binning
    mis-bins the lower block's 1/2-deg-spaced rings)."""
    model = HDL64._replace(ring_elevations_deg=hdl64_ring_table())
    cfg = MloamConfig(rig=LidarRig(models=(model,), extrinsic_mode=0))
    return dataclasses.replace(
        cfg, segmenter=dataclasses.replace(cfg.segmenter, ground_rows=30))


def realtime_tuned(cfg: MloamConfig) -> MloamConfig:
    """The realtime operating point on top of any preset: one window
    Gauss-Newton iteration, two tracker iterations, stride-0.6 good-feature
    compaction in the window, a less-flat cap of 2560, 8 label-propagation
    rounds and local-map precaps of 512 / 2560."""
    return dataclasses.replace(
        cfg,
        odometry=dataclasses.replace(
            cfg.odometry, gn_iters=1, gf_ratio=0.6, gf_method="stride",
            gf_compact=True,
            localmap_precap_corner=512, localmap_precap_surf=2560),
        tracker=dataclasses.replace(cfg.tracker, gn_iters=2),
        segmenter=dataclasses.replace(cfg.segmenter, label_iters=8),
        features=dataclasses.replace(cfg.features, cap_less_flat=2560),
    )


def synthetic(n_lidars: int = 1, extrinsic_mode: int = 0) -> MloamConfig:
    """The simulator fixture platform."""
    return _rig_budget(MloamConfig(rig=LidarRig(models=(SIM16,) * n_lidars,
                                                extrinsic_mode=extrinsic_mode)))


def indoor_degenerate(cfg: MloamConfig) -> MloamConfig:
    """The indoor / degenerate-geometry operating point: arm the solution
    remap of the window and of the mapper at 175, with the persistence,
    purity and support gates, canonical-axis snapping and projector-consistent
    marginalization the config carries. The default ships it disarmed;
    arming it is a choice of environment. 175 sits between the corridor
    window's weakest eigenvalues (113-156 at 0.01 m range noise) and those of
    rich scenes at that noise (>= 232), as the JAX package calibrated it."""
    return dataclasses.replace(
        cfg,
        odometry=dataclasses.replace(cfg.odometry, eig_threshold=175.0),
        mapping=dataclasses.replace(cfg.mapping, eig_threshold=175.0),
    )
