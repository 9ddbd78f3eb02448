"""The port's dataset I/O against the JAX package's and against its own plain
versions, on files the tests write: its C++ library (``csrc/dataset.cpp``)
builds here with the host compiler; every reader, the gridder, the VLP-16
codec, both prefetch rings and ``convert_kitti_sequence`` equal the JAX
package's (to the bit: the same C++ semantics); the library equals the numpy
plain versions (readers to the bit, ascii PCD to 1e-4 as the text holds;
the gridder's ranges to the bit and its intensities wherever one return
holds the winning 2 mm count); a missing file raises."""

import os

import numpy as np
import pytest

from mloam_tpu.core.rangeimage import LidarModel as JModel
from mloam_tpu.utils import dataio as J
from mloam_tpu_torch.core import rangeimage as RI
from mloam_tpu_torch.ops import _build
from mloam_tpu_torch.utils import dataio as T

MODEL_T = RI.LidarModel(n_rings=16, n_cols=360)
MODEL_J = JModel(n_rings=16, n_cols=360)


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("velodyne")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(5):
        pts = rng.uniform(-50, 50, (1000 + 100 * i, 4)).astype(np.float32)
        pts[:, 3] = rng.uniform(0, 1, len(pts))
        p = str(d / f"{i:06d}.bin")
        pts.tofile(p)
        paths.append(p)
    return str(d), paths


def _write_pcd(path, pts, mode):
    hdr = ("VERSION .7\nFIELDS x y z intensity\nSIZE 4 4 4 4\nTYPE F F F F\n"
           f"COUNT 1 1 1 1\nWIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
           f"POINTS {len(pts)}\nDATA {mode}\n")
    with open(path, "wb") as f:
        f.write(hdr.encode())
        if mode == "ascii":
            f.write("".join(f"{p[0]} {p[1]} {p[2]} {p[3]}\n" for p in pts).encode())
        else:
            f.write(np.asarray(pts, np.float32).tobytes())


def test_the_library_builds_here_with_the_host_compiler():
    lib = T.library()
    assert lib is _build.load_host("dataset")
    for sym in ("ds_open", "ds_next", "ds_close", "ds_read_kitti_bin", "ds_read_pcd",
                "ds_grid_pack", "ds_vlp16_decode", "dsp_open", "dsp_next", "dsp_close"):
        assert hasattr(lib, sym)
    built = list(_build.BUILD_DIR.glob("libdataset_*.so"))
    assert built and all(p.stat().st_size > 0 for p in built)


def test_kitti_bin_equals_the_reference_and_the_plain_version(kitti_dir):
    _, paths = kitti_dir
    want = np.fromfile(paths[2], np.float32).reshape(-1, 4)
    got = T.read_kitti_bin(paths[2])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, J.read_kitti_bin(paths[2]))
    np.testing.assert_array_equal(got, T.read_kitti_bin_plain(paths[2]))
    np.testing.assert_array_equal(T.read_kitti_bin(paths[2], 100),
                                  T.read_kitti_bin_plain(paths[2], 100))


@pytest.mark.parametrize("mode", ["ascii", "binary"])
def test_pcd_equals_the_reference_and_the_plain_version(mode, tmp_path):
    pts = np.random.default_rng(1).uniform(-5, 5, (64, 4)).astype(np.float32)
    if mode == "ascii":
        pts = np.round(pts, 3)
    path = str(tmp_path / f"c_{mode}.pcd")
    _write_pcd(path, pts, mode)
    got = T.read_pcd(path)
    np.testing.assert_array_equal(got, J.read_pcd(path))
    np.testing.assert_allclose(got, pts, atol=1e-4 if mode == "ascii" else 0)
    plain = T.read_pcd_plain(path)
    if mode == "binary":
        np.testing.assert_array_equal(got, plain)
    else:
        np.testing.assert_allclose(got, plain, atol=1e-4)
    np.testing.assert_array_equal(T.read_pcd(path, 10), got[:10])


def test_prefetch_stream_equals_the_reference(kitti_dir):
    _, paths = kitti_dir
    reader = T.PrefetchReader(paths, "kitti", capacity=2)
    got = list(reader)
    reader.close()
    jr = J.PrefetchReader(paths, "kitti", capacity=2)
    want = list(jr)
    jr.close()
    assert len(got) == len(want) == len(paths)
    for p, a, b in zip(paths, got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, T.read_kitti_bin_plain(p))


def test_convert_kitti_sequence_equals_the_reference(kitti_dir, tmp_path):
    d, paths = kitti_dir
    n_t = T.convert_kitti_sequence(d, str(tmp_path / "t.npz"), cap=2048)
    n_j = J.convert_kitti_sequence(d, str(tmp_path / "j.npz"), cap=2048)
    assert n_t == n_j == len(paths)
    t, j = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    np.testing.assert_array_equal(t["xyzi"], j["xyzi"])
    np.testing.assert_array_equal(t["mask"], j["mask"])
    assert int(t["mask"][0].sum()) == 1000
    assert T.convert_kitti_sequence(d, str(tmp_path / "t3.npz"), max_frames=3, cap=2048) == 3


def _cloud(seed, n=20_000):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-40, 40, (n, 4)).astype(np.float32)
    pts[:, 3] = rng.uniform(0, 1, n)
    return pts


def _tied_cells(pts, model):
    """Cells where two or more returns share the winning 2 mm count."""
    xyz = pts[:, :3].astype(np.float64)
    rng = np.linalg.norm(xyz, axis=1)
    q = np.clip(np.round(rng / RI.RANGE_QUANTUM), 1, 65535)
    ring_f = ((np.arctan2(xyz[:, 2], np.maximum(np.linalg.norm(xyz[:, :2], axis=1), 1e-9))
               - np.radians(model.fov_down_deg))
              / np.radians(model.fov_up_deg - model.fov_down_deg) * (model.n_rings - 1))
    col = np.clip(np.floor((np.arctan2(xyz[:, 1], xyz[:, 0]) + np.pi) / (2 * np.pi)
                           * model.n_cols), 0, model.n_cols - 1).astype(int)
    ok = (rng > model.min_range) & (rng < model.max_range) & (ring_f > -0.5) \
        & (ring_f < model.n_rings - 0.5)
    cell = np.clip(np.round(ring_f), 0, model.n_rings - 1).astype(int) * model.n_cols + col
    best = np.full(model.n_rings * model.n_cols, np.inf)
    np.minimum.at(best, cell[ok], q[ok])
    winners = np.bincount(cell[ok][q[ok] == best[cell[ok]]],
                          minlength=model.n_rings * model.n_cols)
    return (winners > 1).reshape(model.n_rings, model.n_cols)


@pytest.mark.parametrize("seed", [3, 4])
def test_grid_pack_equals_the_reference_and_the_plain_version(seed):
    pts = _cloud(seed)
    rq, iq = T.grid_pack(pts, MODEL_T)
    jrq, jiq = J.grid_pack(pts, MODEL_J)
    np.testing.assert_array_equal(rq, jrq)
    np.testing.assert_array_equal(iq, jiq)
    prq, piq = T.grid_pack_plain(pts, MODEL_T)
    np.testing.assert_array_equal(rq, prq)
    tied = _tied_cells(pts, MODEL_T)
    np.testing.assert_array_equal(iq[~tied], piq[~tied])
    assert (rq > 0).sum() > 2500 and tied.sum() < 50


def test_the_library_calls_refuse_what_the_c_side_would_overrun():
    model = RI.LidarModel(n_rings=64, n_cols=1800,
                          ring_elevations_deg=RI.hdl64_ring_table())
    with pytest.raises(ValueError, match="per-ring"):
        T.grid_pack(_cloud(5, 100), model)
    with pytest.raises(ValueError, match=r"\[N, 4\]"):
        T.grid_pack(_cloud(5, 100)[:, :3], MODEL_T)
    with pytest.raises(ValueError, match="16 laser ids"):
        T.vlp16_decode(b"", MODEL_T, ring_table=np.arange(8))


def _returns(seed, n_cols):
    """Per-return (ring, col, count, intensity) of a uniform azimuth sweep,
    a random subset of rings firing in each column."""
    rng = np.random.default_rng(seed)
    ring_l, col_l = [], []
    for c in range(n_cols):
        rs = np.flatnonzero(rng.uniform(size=16) < 0.7)
        rs = rs if rs.size else np.array([rng.integers(0, 16)])
        ring_l.append(rs)
        col_l.append(np.full(rs.size, c))
    ring, col = np.concatenate(ring_l), np.concatenate(col_l)
    counts = rng.integers(200, 50_000, ring.size).astype(np.uint16)
    inten = rng.integers(0, 256, ring.size).astype(np.uint8)
    return ring, col, counts, inten


def test_vlp16_codec_equals_the_reference_and_round_trips():
    ring, col, counts, inten = _returns(7, MODEL_T.n_cols)
    pkts = T.encode_vlp16_packets(ring, col, counts, inten, MODEL_T.n_cols)
    assert pkts == J.encode_vlp16_packets(ring, col, counts, inten, MODEL_J.n_cols)
    assert len(pkts) % 1206 == 0
    rq, iq, n = T.vlp16_decode(pkts, MODEL_T)
    jrq, jiq, jn = J.vlp16_decode(pkts, MODEL_J)
    np.testing.assert_array_equal(rq, jrq)
    np.testing.assert_array_equal(iq, jiq)
    assert n == jn == ring.size
    exp_r = np.zeros((16, MODEL_T.n_cols), np.uint16)
    exp_i = np.zeros((16, MODEL_T.n_cols), np.uint8)
    exp_r[ring, col] = counts
    exp_i[ring, col] = inten
    np.testing.assert_array_equal(rq, exp_r)
    np.testing.assert_array_equal(iq, exp_i)
    # the same bytes as a numpy buffer
    np.testing.assert_array_equal(T.vlp16_decode(np.frombuffer(pkts, np.uint8), MODEL_T)[0], rq)


def test_vlp16_closest_return_wins():
    p1 = T.encode_vlp16_packets(np.array([4]), np.array([10]), np.array([3000], np.uint16),
                                np.array([9], np.uint8), MODEL_T.n_cols)
    p2 = T.encode_vlp16_packets(np.array([4]), np.array([10]), np.array([1500], np.uint16),
                                np.array([7], np.uint8), MODEL_T.n_cols)
    rq, iq, _ = T.vlp16_decode(p1 + p2, MODEL_T)
    assert (rq[4, 10], iq[4, 10]) == (1500, 7)
    assert (J.vlp16_decode(p1 + p2, MODEL_J)[0] == rq).all()


def test_packed_prefetch_reader_equals_grid_pack_and_the_reference(kitti_dir):
    _, paths = kitti_dir
    reader = T.PackedPrefetchReader(paths, MODEL_T, "kitti", max_pts=4096)
    got = list(reader)
    reader.close()
    jr = J.PackedPrefetchReader(paths, MODEL_J, "kitti", max_pts=4096)
    want = list(jr)
    jr.close()
    assert len(got) == len(want) == len(paths)
    for path, (rq, iq), (jrq, jiq) in zip(paths, got, want):
        erq, eiq = T.grid_pack(T.read_kitti_bin(path, 4096), MODEL_T)
        np.testing.assert_array_equal(rq, erq)
        np.testing.assert_array_equal(iq, eiq)
        np.testing.assert_array_equal(rq, jrq)
        np.testing.assert_array_equal(iq, jiq)
    # the wire buffers unpack into a range image within the model's limits
    import torch

    img = RI.unpack_frame(RI.PackedFrame(*got[0]), RI.unit_rays(MODEL_T, device="cpu"),
                          MODEL_T)
    r = img.rng[img.valid]
    assert r.numel() > 0 and bool((r > MODEL_T.min_range).all()) \
        and bool((r < MODEL_T.max_range).all())
    assert img.rng.dtype == torch.float32


MISSING = {
    "read_kitti_bin": (lambda p: T.read_kitti_bin(p), IOError),
    "read_pcd": (lambda p: T.read_pcd(p), IOError),
    "read_kitti_bin_plain": (lambda p: T.read_kitti_bin_plain(p), OSError),
    "read_pcd_plain": (lambda p: T.read_pcd_plain(p), OSError),
    "PrefetchReader": (lambda p: T.PrefetchReader([p]), FileNotFoundError),
    "PackedPrefetchReader": (lambda p: T.PackedPrefetchReader([p], MODEL_T), FileNotFoundError),
}


@pytest.mark.parametrize("name", list(MISSING))
def test_a_missing_file_raises(name, tmp_path):
    fn, exc = MISSING[name]
    with pytest.raises(exc):
        fn(str(tmp_path / "absent.bin"))
    assert not os.path.exists(tmp_path / "absent.bin")
