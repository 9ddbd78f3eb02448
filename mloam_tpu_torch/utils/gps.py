"""Geodetic conversions: LLA → ECEF → ENU. The port's own copy of
``mloam_tpu/utils/gps.py`` (numpy, equal on the same inputs).

Counterpart of the reference's ``common/gps_tools.hpp`` (LLA→ENU for the
RV/Oxford ground-truth paths). WGS-84, numpy, vectorized.
"""

from __future__ import annotations

import numpy as np

_A = 6378137.0             # WGS-84 semi-major axis
_F = 1.0 / 298.257223563
_E2 = _F * (2.0 - _F)


def lla_to_ecef(lat_deg, lon_deg, alt):
    lat = np.radians(np.asarray(lat_deg, np.float64))
    lon = np.radians(np.asarray(lon_deg, np.float64))
    alt = np.asarray(alt, np.float64)
    sl, cl = np.sin(lat), np.cos(lat)
    n = _A / np.sqrt(1.0 - _E2 * sl * sl)
    x = (n + alt) * cl * np.cos(lon)
    y = (n + alt) * cl * np.sin(lon)
    z = (n * (1.0 - _E2) + alt) * sl
    return np.stack([x, y, z], axis=-1)


def lla_to_enu(lat_deg, lon_deg, alt, ref_lla):
    """ENU coordinates of points relative to ref (lat, lon, alt)."""
    ref = lla_to_ecef(*ref_lla)
    p = lla_to_ecef(lat_deg, lon_deg, alt) - ref
    lat0 = np.radians(ref_lla[0])
    lon0 = np.radians(ref_lla[1])
    sl, cl = np.sin(lat0), np.cos(lat0)
    so, co = np.sin(lon0), np.cos(lon0)
    R = np.array([
        [-so, co, 0.0],
        [-sl * co, -sl * so, cl],
        [cl * co, cl * so, sl],
    ])
    return p @ R.T
