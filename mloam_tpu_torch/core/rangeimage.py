"""Range-image schema of spinning-LiDAR sweeps.

The range image *is* the canonical scan tensor: all frontend ops are dense
[R, C] tensor programs. Counterpart of ``mloam_tpu/core/rangeimage.py``:
``project`` takes an unordered cloud into the grid, ``hdl64_ring_table`` is
the HDL-64's non-uniform beam ladder.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class RangeImage(NamedTuple):
    xyz: torch.Tensor       # [R, C, 3]
    rng: torch.Tensor       # [R, C] euclidean range, 0 where invalid
    valid: torch.Tensor     # [R, C] bool
    time: torch.Tensor      # [R, C] relative sweep time in [0, 1)
    intensity: torch.Tensor  # [R, C]

    @property
    def shape(self):
        return tuple(self.rng.shape)


class LidarModel(NamedTuple):
    """Geometry of one spinning LiDAR (static; part of the config tree)."""

    n_rings: int = 16
    n_cols: int = 1800
    fov_up_deg: float = 15.0
    fov_down_deg: float = -15.0
    min_range: float = 0.3
    max_range: float = 100.0
    scan_period: float = 0.1
    # per-ring elevation table in degrees, ASCENDING (ring 0 = bottom), for
    # sensors whose beams are not uniformly spaced; None = uniform linspace
    # [fov_down, fov_up].
    ring_elevations_deg: tuple | None = None


def hdl64_ring_table() -> tuple:
    """The HDL-64's non-uniform beam ladder: the upper 32 beams at 1/3 deg
    spacing from +2 down to -8.33 deg, the lower 32 at 1/2 deg from -8.83
    down to -24.33 deg, returned ASCENDING (ring 0 = the -24.33 bottom
    beam) to match this module's row convention."""
    upper = [2.0 - i / 3.0 for i in range(32)]
    lower = [-8.83 - i / 2.0 for i in range(32)]
    return tuple(reversed(upper + lower))


def _col_time(r: int, c: int, dtype, device, lead=()) -> torch.Tensor:
    return (torch.arange(c, dtype=dtype, device=device) / c).expand(*lead, r, c)


def _deg2rad(deg, dtype, device) -> torch.Tensor:
    """Degrees to radians in ``dtype`` (converted first, then scaled)."""
    return torch.deg2rad(torch.as_tensor(deg, dtype=dtype, device=device))


def project(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    model: LidarModel,
    intensity: torch.Tensor | None = None,
) -> RangeImage:
    """Project a flat padded cloud [N, 3] into a range image.

    Collisions keep the *closest* return per cell: a scatter-min on range,
    then a scatter-min on the point index among the points at that range, so
    exact ties go to the lowest index. Payloads are gathered from the
    winner. Relative time is derived from the azimuth column assuming a
    uniform sweep starting at the -x axis.
    """
    r, c = model.n_rings, model.n_cols
    dtype, dev = xyz.dtype, xyz.device
    rng = torch.linalg.norm(xyz, dim=-1)
    ok = mask & (rng > model.min_range) & (rng < model.max_range)

    azimuth = torch.atan2(xyz[:, 1], xyz[:, 0])  # [-pi, pi)
    col = torch.floor((azimuth + math.pi) / (2 * math.pi) * c).to(torch.int64)
    col = torch.clamp(col, 0, c - 1)

    horiz = torch.linalg.norm(xyz[:, :2], dim=-1)
    vert = torch.atan2(xyz[:, 2], torch.clamp(horiz, min=1e-9))
    if model.ring_elevations_deg is not None:
        # non-uniform beam table: nearest-elevation binning, in the field of
        # view when within half the local ring gap of the nearest beam
        elev = _deg2rad(model.ring_elevations_deg, dtype, dev)
        d = torch.abs(vert[:, None] - elev[None, :])             # [N, R]
        near, ring = torch.min(d, dim=1)
        gaps = torch.diff(elev)
        half_gap = 0.5 * torch.cat([
            gaps[:1], torch.minimum(gaps[:-1], gaps[1:]), gaps[-1:]])
        ok = ok & (near <= half_gap[ring] * 1.001)
    else:
        fov_up = _deg2rad(model.fov_up_deg, dtype, dev)
        fov_down = _deg2rad(model.fov_down_deg, dtype, dev)
        ring_f = (vert - fov_down) / (fov_up - fov_down) * (r - 1)
        ring = torch.round(ring_f).to(torch.int64)
        ok = ok & (ring_f > -0.5) & (ring_f < r - 0.5)
        ring = torch.clamp(ring, 0, r - 1)

    flat = ring * c + col
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    img_rng = torch.full((r * c,), float("inf"), dtype=dtype, device=dev) \
        .scatter_reduce(0, flat, torch.where(ok, rng, inf), "amin")
    winner = ok & (rng == img_rng[flat])
    big = torch.iinfo(torch.int64).max
    idx = torch.arange(xyz.shape[0], device=dev)
    img_idx = torch.full((r * c,), big, dtype=torch.int64, device=dev) \
        .scatter_reduce(0, flat, torch.where(winner, idx, big), "amin")
    cell_valid = torch.isfinite(img_rng)
    src = torch.where(cell_valid, img_idx, 0)

    img_xyz = xyz[src].reshape(r, c, 3)
    img_int = (intensity[src] if intensity is not None
               else torch.zeros((r * c,), dtype=dtype, device=dev)).reshape(r, c)
    valid2d = cell_valid.reshape(r, c)
    return RangeImage(
        xyz=torch.where(valid2d[..., None], img_xyz, 0.0),
        rng=torch.where(cell_valid, img_rng, 0.0).reshape(r, c),
        valid=valid2d,
        time=_col_time(r, c, dtype, dev),
        intensity=torch.where(valid2d, img_int, 0.0),
    )


def from_grid(xyz: torch.Tensor, valid: torch.Tensor,
              intensity: torch.Tensor | None = None) -> RangeImage:
    """Wrap an already-gridded sweep (e.g. from the simulator) as a RangeImage."""
    r, c = valid.shape
    rng = torch.linalg.norm(xyz, dim=-1) * valid
    inten = (intensity if intensity is not None
             else torch.zeros((r, c), dtype=xyz.dtype, device=xyz.device))
    return RangeImage(xyz=xyz, rng=rng, valid=valid,
                      time=_col_time(r, c, xyz.dtype, xyz.device),
                      intensity=inten)


def unit_rays(model: LidarModel, dtype=torch.float32, device=None) -> torch.Tensor:
    """[R, C, 3] unit ray directions in the sensor frame: ring elevations
    from the model's per-ring table when present, else the linear ladder;
    azimuth at column centers."""
    r, c = model.n_rings, model.n_cols
    if model.ring_elevations_deg is not None:
        vert = torch.deg2rad(torch.tensor(model.ring_elevations_deg,
                                          dtype=dtype, device=device))
    else:
        vert = torch.deg2rad(torch.linspace(
            model.fov_down_deg, model.fov_up_deg, r, dtype=dtype,
            device=device))
    az = ((torch.arange(c, dtype=dtype, device=device) + 0.5) / c
          * 2 * math.pi - math.pi)
    cv, sv = torch.cos(vert)[:, None], torch.sin(vert)[:, None]
    ca, sa = torch.cos(az)[None, :], torch.sin(az)[None, :]
    return torch.stack([cv * ca, cv * sa, sv.expand(r, c)], dim=-1)


RANGE_QUANTUM = 0.002  # meters per count — native spinning-lidar wire units


class PackedFrame(NamedTuple):
    """Compressed sweep wire format: ONE small host-to-device buffer per
    sweep.

    ``rng_q`` is range in 2 mm counts (0 = no return) — the native
    resolution of real spinning-LiDAR packet formats, 65535 counts = 131 m.
    xyz / valid / time are reconstructed ON DEVICE from a constant per-model
    ray table: xyz = rng * ray(ring, col), exact for ray-aligned grids (real
    sensor streams and the simulator both are). Host side the fields are
    numpy uint16 / uint8; ``unpack_frame`` takes either those or tensors.
    """

    rng_q: np.ndarray        # [R, C] uint16, 2 mm units, 0 = invalid
    intensity_q: np.ndarray  # [R, C] uint8


def pack_frame(img: RangeImage) -> PackedFrame:
    """RangeImage -> wire format. Pure numpy ON THE HOST (this is the
    producer side of the transfer; device tensors are pulled back first).
    Assumes the grid is ray-aligned."""
    rng = img.rng.detach().cpu().numpy()
    valid = img.valid.detach().cpu().numpy()
    inten = img.intensity.detach().cpu().numpy()
    q = np.round(rng / RANGE_QUANTUM)
    q = np.where(valid, np.clip(q, 1, 65535), 0).astype(np.uint16)
    inten_q = np.clip(np.round(inten * 255.0), 0, 255).astype(np.uint8)
    return PackedFrame(rng_q=q, intensity_q=inten_q)


def _wire_to_device(a, device) -> torch.Tensor:
    """uint16/uint8 wire field -> int32 tensor on ``device`` (PyTorch's
    uint16 support is thin; counts fit int32 exactly)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int32)
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(device)


def unpack_frame(pf: PackedFrame, rays: torch.Tensor,
                 model: LidarModel) -> RangeImage:
    """Wire format -> RangeImage, on the device of ``rays`` (the [R, C, 3]
    unit ray table). Fields [R, C], or [L, R, C] for the sweeps of L lidars
    that share ``model`` and its ray table: each image unpacked as alone."""
    device = rays.device
    rq = _wire_to_device(pf.rng_q, device)
    rng = rq.to(torch.float32) * RANGE_QUANTUM
    valid = (rq > 0) & (rng > model.min_range) & (rng < model.max_range)
    xyz = torch.where(valid[..., None], rng[..., None] * rays, 0.0)
    *lead, r, c = valid.shape
    return RangeImage(
        xyz=xyz,
        rng=torch.where(valid, rng, 0.0),
        valid=valid,
        time=_col_time(r, c, torch.float32, device, lead),
        intensity=_wire_to_device(pf.intensity_q, device).to(torch.float32) / 255.0,
    )


def flatten(img: RangeImage):
    """Range image -> flat padded cloud arrays (xyz, mask, time, intensity)."""
    r, c = img.valid.shape
    return (
        img.xyz.reshape(r * c, 3),
        img.valid.reshape(r * c),
        img.time.reshape(r * c),
        img.intensity.reshape(r * c),
    )
