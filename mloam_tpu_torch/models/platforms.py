"""Per-platform configuration presets.

Counterpart of ``mloam_tpu/models/platforms.py``. Ported so far: the sensor
constants, the rig budget rule and the simulator fixture platform
(``synthetic``); the other presets follow the multi-LiDAR and calibration
paths they configure.
"""

from __future__ import annotations

import dataclasses

from mloam_tpu_torch.config import LidarRig, MloamConfig
from mloam_tpu_torch.core.rangeimage import LidarModel

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


def synthetic(n_lidars: int = 1, extrinsic_mode: int = 0) -> MloamConfig:
    """The simulator fixture platform."""
    return _rig_budget(MloamConfig(rig=LidarRig(models=(SIM16,) * n_lidars,
                                                extrinsic_mode=extrinsic_mode)))
