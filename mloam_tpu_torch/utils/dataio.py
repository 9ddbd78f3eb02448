"""Dataset I/O: the host C++ reader and its plain numpy versions.

Counterpart of ``mloam_tpu/utils/dataio.py``. The decode / grid / prefetch
path is host C++ (``csrc/dataset.cpp``, the port's own copy of the JAX
package's loader), built at first use with the host C++ compiler by
``ops/_build.load_host`` into ``mloam_tpu_torch/_build/`` and driven through
``ctypes``. Nothing is built at import, and a failed build raises: unlike the
JAX package, no function here quietly falls back to numpy when the library
is missing. The numpy readers (``read_kitti_bin_plain``, ``read_pcd_plain``)
and the ``project`` + ``pack_frame`` gridder (``grid_pack_plain``) are the
plain versions the tests hold the library against.

Includes the kittiHelper counterpart (``estimator/src/kittiHelper.cpp``):
KITTI raw velodyne .bin sequences -> packed .npz shards of fixed-capacity
padded clouds. The wire arrays (``rng_q`` uint16, ``intensity_q`` uint8)
stay numpy on the host; ``core/rangeimage.unpack_frame`` copies them to the
device.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator

import numpy as np
import torch

from mloam_tpu_torch.core import rangeimage as RI
from mloam_tpu_torch.ops import _build

_lib = None

_F32P = ctypes.POINTER(ctypes.c_float)
_U16P = ctypes.POINTER(ctypes.c_uint16)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def library() -> ctypes.CDLL:
    """The dataset library, built on first use (raises if it cannot be)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load_host("dataset")
    lib.ds_open.restype = ctypes.c_void_p
    lib.ds_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
                            ctypes.c_int, ctypes.c_int64, ctypes.c_int64]
    lib.ds_next.restype = ctypes.c_int64
    lib.ds_next.argtypes = [ctypes.c_void_p, _F32P]
    lib.ds_close.restype = None
    lib.ds_close.argtypes = [ctypes.c_void_p]
    for name in ("ds_read_kitti_bin", "ds_read_pcd"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_char_p, _F32P, ctypes.c_int64]
    lib.ds_grid_pack.restype = None
    lib.ds_grid_pack.argtypes = [
        _F32P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, _U16P, _U8P]
    lib.ds_vlp16_decode.restype = ctypes.c_int64
    lib.ds_vlp16_decode.argtypes = [
        _U8P, ctypes.c_int64, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_int, _U16P, _U8P]
    lib.dsp_open.restype = ctypes.c_void_p
    lib.dsp_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double]
    lib.dsp_next.restype = ctypes.c_int64
    lib.dsp_next.argtypes = [ctypes.c_void_p, _U16P, _U8P]
    lib.dsp_close.restype = None
    lib.dsp_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _fmt_code(fmt: str) -> int:
    if fmt not in ("kitti", "pcd"):
        raise ValueError(f"unknown point-cloud format {fmt!r} (kitti or pcd)")
    return 0 if fmt == "kitti" else 1


def _path_array(paths: list[str]):
    missing = [p for p in paths if not os.path.isfile(p)]
    if missing:
        raise FileNotFoundError(f"{len(missing)} file(s) not found, first: {missing[0]}")
    return (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])


def _points(points) -> np.ndarray:
    pts = np.ascontiguousarray(points, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 4:
        raise ValueError(f"points must be [N, 4] x, y, z, intensity; got {pts.shape}")
    return pts


def _check_uniform(model: RI.LidarModel):
    # the C++ gridder bins on the linear elevation ladder of the model
    if model.ring_elevations_deg is not None:
        raise ValueError("the dataset gridder takes a uniform elevation ladder; "
                         "this model has a per-ring table")


# ------------------------------------------------------------------ readers

def read_kitti_bin(path: str, max_pts: int = 150_000) -> np.ndarray:
    """[N, 4] float32 (x, y, z, intensity) of a KITTI velodyne .bin file."""
    buf = np.empty((max_pts, 4), np.float32)
    n = library().ds_read_kitti_bin(os.fsencode(path), buf.ctypes.data_as(_F32P), max_pts)
    if n < 0:
        raise IOError(f"failed to read {path}")
    return buf[:n].copy()


def read_kitti_bin_plain(path: str, max_pts: int = 150_000) -> np.ndarray:
    """The plain version of ``read_kitti_bin``."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)[:max_pts]


def read_pcd(path: str, max_pts: int = 500_000) -> np.ndarray:
    """[N, 4] float32 from an ascii or binary PCD with x y z [intensity]."""
    buf = np.empty((max_pts, 4), np.float32)
    n = library().ds_read_pcd(os.fsencode(path), buf.ctypes.data_as(_F32P), max_pts)
    if n < 0:
        raise IOError(f"failed to parse {path}")
    return buf[:n].copy()


def read_pcd_plain(path: str, max_pts: int = 500_000) -> np.ndarray:
    """The plain version of ``read_pcd`` (the JAX package's
    ``_read_pcd_numpy``)."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline()
            if not line:
                raise IOError(f"failed to parse {path}: no DATA line")
            key, _, rest = line.decode("ascii", "ignore").strip().partition(" ")
            header[key] = rest.split()
            if key == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header.get("SIZE", ["4"] * len(fields))]
        types = header.get("TYPE", ["F"] * len(fields))
        n = int(header["POINTS"][0])
        mode = header["DATA"][0]
        np_types = {("F", 4): "f4", ("F", 8): "f8", ("U", 1): "u1",
                    ("U", 4): "u4", ("I", 4): "i4"}
        dtype = np.dtype({"names": fields,
                          "formats": [np_types[(t, s)] for t, s in zip(types, sizes)]})
        if mode == "ascii":
            arr = np.loadtxt(f, max_rows=n, ndmin=2)
            rec = {name: arr[:, i] for i, name in enumerate(fields)}
        else:
            raw = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype)
            rec = {name: raw[name] for name in fields}
    n = min(n, max_pts)
    out = np.zeros((n, 4), np.float32)
    for i, name in enumerate(("x", "y", "z")):
        out[:, i] = rec[name][:n]
    if "intensity" in rec:
        out[:, 3] = rec["intensity"][:n]
    return out


class PrefetchReader:
    """Frame streaming over a file list: a C++ worker thread decodes the
    files into a bounded ring of ``capacity`` frames while the caller
    consumes them. Every path must exist when the reader is made."""

    def __init__(self, paths: list[str], fmt: str = "kitti",
                 max_pts: int = 150_000, capacity: int = 4):
        self.max_pts = max_pts
        self._lib = library()
        self._handle = self._lib.ds_open(_path_array(paths), len(paths),
                                         _fmt_code(fmt), max_pts, capacity)

    def __iter__(self) -> Iterator[np.ndarray]:
        buf = np.empty((self.max_pts, 4), np.float32)
        while self._handle is not None:
            n = self._lib.ds_next(self._handle, buf.ctypes.data_as(_F32P))
            if n <= 0:
                break
            yield buf[:n].copy()

    def close(self):
        if self._handle is not None:
            self._lib.ds_close(self._handle)
            self._handle = None


# ---------------------------------------------------------- wire format

# hardware laser id -> grid ring (0 = lowest elevation) for the VLP-16's
# interleaved firing ladder: even ids are -15..-1 deg, odd ids +1..+15
VLP16_RING_TABLE = np.array(
    [i // 2 if i % 2 == 0 else 8 + i // 2 for i in range(16)], np.int32)


def grid_pack(points: np.ndarray, model: RI.LidarModel) -> tuple[np.ndarray, np.ndarray]:
    """[N, 4] xyzi points -> PackedFrame arrays (u16 2 mm ranges, u8
    intensity) by the C++ gridder: nearest ring on the model's linear
    elevation ladder, floor azimuth column, closest return wins (the first
    point of the smallest 2 mm count)."""
    _check_uniform(model)
    pts = _points(points)
    rng_q = np.empty((model.n_rings, model.n_cols), np.uint16)
    inten_q = np.empty((model.n_rings, model.n_cols), np.uint8)
    library().ds_grid_pack(
        pts.ctypes.data_as(_F32P), pts.shape[0], model.n_rings, model.n_cols,
        model.fov_up_deg, model.fov_down_deg, model.min_range, model.max_range,
        rng_q.ctypes.data_as(_U16P), inten_q.ctypes.data_as(_U8P))
    return rng_q, inten_q


def grid_pack_plain(points: np.ndarray, model: RI.LidarModel) -> tuple[np.ndarray, np.ndarray]:
    """The plain version of ``grid_pack``: ``project`` + ``pack_frame`` on
    the CPU in float64, the C++ gridder's precision. The ranges are equal to
    the bit; a cell whose two or more returns share the winning 2 mm count
    may keep another of their intensities (``project`` keeps the closest
    float range, the C++ the first such point)."""
    _check_uniform(model)
    pts = torch.from_numpy(_points(points)).double()
    img = RI.project(pts[:, :3], torch.ones(pts.shape[0], dtype=torch.bool), model,
                     intensity=pts[:, 3])
    pf = RI.pack_frame(img)
    return pf.rng_q, pf.intensity_q


def vlp16_decode(packets: bytes | np.ndarray, model: RI.LidarModel,
                 ring_table: np.ndarray | None = None
                 ) -> tuple[np.ndarray, np.ndarray, int]:
    """One sweep of Velodyne-style 1206-byte packets -> PackedFrame arrays.

    The sensor's 2 mm distance counts pass straight into the wire format (no
    float conversion on the host). Returns (rng_q [R, C] u16, intensity_q
    [R, C] u8, number of returns decoded)."""
    buf = (np.frombuffer(packets, np.uint8) if isinstance(packets, bytes)
           else np.ascontiguousarray(packets, np.uint8))
    table = np.ascontiguousarray(
        VLP16_RING_TABLE if ring_table is None else ring_table, np.int32)
    if table.shape != (16,):
        raise ValueError(f"ring_table must map the 16 laser ids; got {table.shape}")
    rng_q = np.empty((model.n_rings, model.n_cols), np.uint16)
    inten_q = np.empty((model.n_rings, model.n_cols), np.uint8)
    n = library().ds_vlp16_decode(
        buf.ctypes.data_as(_U8P), buf.size,
        table.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        model.n_rings, model.n_cols,
        rng_q.ctypes.data_as(_U16P), inten_q.ctypes.data_as(_U8P))
    return rng_q, inten_q, int(n)


def encode_vlp16_packets(ring: np.ndarray, col: np.ndarray,
                         rng_q: np.ndarray, inten: np.ndarray,
                         n_cols: int,
                         ring_table: np.ndarray | None = None) -> bytes:
    """Synthesize Velodyne-style packets from per-return (ring, col, 2 mm
    count, intensity) arrays: the test and simulation encoder dual of
    ``vlp16_decode``. Emits one 16-channel firing sequence per distinct
    column (two sequences per 100-byte block, 12 blocks per 1206-byte
    packet)."""
    table = VLP16_RING_TABLE if ring_table is None else ring_table
    ring_to_ch = np.empty(16, np.int64)
    ring_to_ch[np.asarray(table)] = np.arange(16)
    seqs = []
    for c in np.unique(col):
        m = col == c
        dist = np.zeros(16, np.uint16)
        ii = np.zeros(16, np.uint8)
        dist[ring_to_ch[ring[m]]] = rng_q[m]
        ii[ring_to_ch[ring[m]]] = inten[m]
        seqs.append((int(round(c * 36000 / n_cols)), dist, ii))
    out = bytearray()
    for i in range(0, len(seqs), 24):  # 24 sequences = 12 blocks = 1 packet
        pkt = bytearray()
        chunk = seqs[i:i + 24]
        for b in range(12):
            if 2 * b >= len(chunk):
                pkt += b"\x00" * 100  # invalid block (flag != 0xFFEE)
                continue
            s1 = chunk[2 * b]
            pkt += bytes([0xFF, 0xEE, s1[0] & 0xFF, (s1[0] >> 8) & 0xFF])
            for seq in (s1, chunk[2 * b + 1] if 2 * b + 1 < len(chunk) else None):
                for ch in range(16):
                    if seq is None:
                        pkt += b"\x00\x00\x00"
                    else:
                        d, it = int(seq[1][ch]), int(seq[2][ch])
                        pkt += bytes([d & 0xFF, (d >> 8) & 0xFF, it])
        pkt += b"\x00" * 6  # timestamp / factory tail
        assert len(pkt) == 1206
        out += pkt
    return bytes(out)


class PackedPrefetchReader:
    """PackedFrame streaming: the C++ worker decodes each file AND grids and
    quantizes it, so iteration yields ready-to-ship (rng_q, intensity_q) wire
    buffers (86 KB a sweep for a VLP-16). Every path must exist when the
    reader is made."""

    def __init__(self, paths: list[str], model: RI.LidarModel, fmt: str = "kitti",
                 max_pts: int = 150_000, capacity: int = 4):
        _check_uniform(model)
        self.model = model
        self._lib = library()
        self._handle = self._lib.dsp_open(
            _path_array(paths), len(paths), _fmt_code(fmt), max_pts, capacity,
            model.n_rings, model.n_cols, model.fov_up_deg, model.fov_down_deg,
            model.min_range, model.max_range)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        shape = (self.model.n_rings, self.model.n_cols)
        while self._handle is not None:
            rng_q = np.empty(shape, np.uint16)
            inten_q = np.empty(shape, np.uint8)
            if self._lib.dsp_next(self._handle, rng_q.ctypes.data_as(_U16P),
                                  inten_q.ctypes.data_as(_U8P)) <= 0:
                break
            yield rng_q, inten_q

    def close(self):
        if self._handle is not None:
            self._lib.dsp_close(self._handle)
            self._handle = None


def convert_kitti_sequence(velodyne_dir: str, out_path: str,
                           max_frames: int | None = None,
                           cap: int = 131_072) -> int:
    """KITTI velodyne directory -> one .npz shard of padded clouds + masks
    (kittiHelper counterpart). Returns the number of frames written."""
    files = sorted(os.path.join(velodyne_dir, f)
                   for f in os.listdir(velodyne_dir) if f.endswith(".bin"))
    if max_frames:
        files = files[:max_frames]
    xyzi = np.zeros((len(files), cap, 4), np.float32)
    mask = np.zeros((len(files), cap), bool)
    reader = PrefetchReader(files, "kitti", cap)
    try:
        for i, pts in enumerate(reader):
            xyzi[i, :pts.shape[0]] = pts
            mask[i, :pts.shape[0]] = True
    finally:
        reader.close()
    np.savez_compressed(out_path, xyzi=xyzi, mask=mask)
    return len(files)
