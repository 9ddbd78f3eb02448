"""The port's host utilities against the JAX package's, on the same inputs:
``utils/algos`` and ``utils/gps`` (numpy: equal to the bit), the realtime
gate (the same admit / drop decisions on the same clock and stamps), the
publisher (queue semantics, and ``publish_odometry_output`` from an output
converted from the JAX package's: the same messages, to the bit, with one
copy to the host), and the plots (each writes a PNG; an exported PCD map is
the JAX package's byte for byte)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mloam_tpu.core.se3 import Pose as JPose
from mloam_tpu.models.pipeline import OdometryOutput as JOutput
from mloam_tpu.utils import algos as JA
from mloam_tpu.utils import gps as JG
from mloam_tpu.utils import publisher as JPub
from mloam_tpu.utils import realtime as JR
from mloam_tpu.utils import viz as JV
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.models.pipeline import OdometryOutput
from mloam_tpu_torch.utils import algos as TA
from mloam_tpu_torch.utils import gps as TG
from mloam_tpu_torch.utils import publisher as TPub
from mloam_tpu_torch.utils import realtime as TR
from mloam_tpu_torch.utils import viz as TV


# ------------------------------------------------------------------ algos

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hull_and_area_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(40 + 20 * seed, 2))
    h_t, h_j = TA.convex_hull_2d(pts), JA.convex_hull_2d(pts)
    np.testing.assert_array_equal(h_t, h_j)
    assert TA.polygon_area(h_t) == JA.polygon_area(h_j) > 0
    line = np.stack([np.arange(5.0), 2 * np.arange(5.0)], 1)   # collinear
    np.testing.assert_array_equal(TA.convex_hull_2d(line), JA.convex_hull_2d(line))


@pytest.mark.parametrize("shape", [(5, 5), (4, 7), (7, 4)])
def test_hungarian_equals_the_reference(shape):
    cost = np.random.default_rng(sum(shape)).uniform(0, 10, shape)
    rt, ct = TA.hungarian(cost)
    rj, cj = JA.hungarian(cost)
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_array_equal(ct, cj)
    assert len(rt) == min(shape)


def test_undirected_graph_components_equal_the_reference():
    rng = np.random.default_rng(4)
    edges = rng.integers(0, 30, (18, 2))
    gt, gj = TA.UndirectedGraph(30), JA.UndirectedGraph(30)
    for a, b in edges:
        gt.add_edge(int(a), int(b))
        gj.add_edge(int(a), int(b))
    assert gt.components() == gj.components()
    assert len(gt.components()) < 30


def test_gps_equals_the_reference():
    rng = np.random.default_rng(5)
    lat = rng.uniform(-80, 80, 50)
    lon = rng.uniform(-180, 180, 50)
    alt = rng.uniform(-100, 3000, 50)
    np.testing.assert_array_equal(TG.lla_to_ecef(lat, lon, alt), JG.lla_to_ecef(lat, lon, alt))
    ref = (51.75, -1.25, 70.0)
    near_lat, near_lon = ref[0] + rng.normal(0, 1e-3, 20), ref[1] + rng.normal(0, 1e-3, 20)
    np.testing.assert_array_equal(TG.lla_to_enu(near_lat, near_lon, alt[:20], ref),
                                  JG.lla_to_enu(near_lat, near_lon, alt[:20], ref))


# ------------------------------------------------------------ realtime gate

def _random_clock():
    # a processing time per sweep drawn around the sensor period
    return np.cumsum(np.random.default_rng(6).exponential(0.12, 200)).tolist()


# the three clocks of tests/test_dataio.py:93-126 (wall time 1x, 2x, 3x the
# stream's, at their lag budgets) and one random clock
CLOCKS = {
    "keeps_up": ([i * 0.1 for i in range(100)], 0.2, 50),
    "behind_2x": ([i * 0.2 for i in range(100)], 0.25, 40),
    "behind_3x": ([i * 0.3 for i in range(100)], 0.35, 20),
    "random": (_random_clock(), 0.2, 150),
}


@pytest.mark.parametrize("name", list(CLOCKS))
def test_gate_decisions_equal_the_reference(name):
    ticks, lag, n = CLOCKS[name]

    def run(mod):
        clk = iter(ticks)
        gate = mod.RealtimeGate(max_lag_s=lag, clock=lambda: next(clk))
        decisions = [gate.admit(i * 0.1) for i in range(n)]
        return decisions, gate.stats()

    assert run(TR) == run(JR)

    def through(mod):
        clk = iter(ticks)
        gate = mod.RealtimeGate(max_lag_s=lag, clock=lambda: next(clk))
        return [f for _, f in mod.gated(iter([(i * 0.1, i) for i in range(n)]), gate)]

    kept = through(TR)
    assert kept == through(JR)
    if name != "keeps_up":
        assert 0 < len(kept) < n


# ---------------------------------------------------------------- publisher

def _queue_trace(mod):
    pub = mod.Publisher()
    got, now = [], []
    sub = pub.subscribe("/cloud", got.append, queue_size=3)
    pub.subscribe("/cloud", now.append, spin=True)
    for i in range(7):
        pub.publish("/cloud", i)
        if i == 2:
            pub.spin_once()
    n = pub.spin_once()
    return got, now, n, sub.dropped, pub.dropped("/cloud"), dict(pub.n_published)


def test_publisher_queues_equal_the_reference():
    trace = _queue_trace(TPub)
    assert trace == _queue_trace(JPub)
    assert trace[0] == [0, 1, 2, 4, 5, 6] and trace[3] == 1   # the oldest shed


class CountingTensor(torch.Tensor):
    """Counts the calls that bring a tensor's values to the host."""

    calls: list = []

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in ("cpu", "item", "tolist", "numpy", "__array__"):
            cls.calls.append(name)
        return super().__torch_function__(func, types, args, kwargs or {})


def test_publish_odometry_output_equals_the_reference_in_one_copy():
    rng = np.random.default_rng(7)

    def unit(n):
        q = rng.normal(size=(n, 4)).astype(np.float32)
        return q / np.linalg.norm(q, axis=1, keepdims=True)

    pq, pt, rq, rt = unit(1)[0], rng.normal(size=3).astype(np.float32), unit(1)[0], \
        rng.normal(size=3).astype(np.float32)
    eq, et = unit(2), rng.normal(size=(2, 3)).astype(np.float32)
    cov = rng.normal(size=(1, 6, 6))
    jout = JOutput(pose=JPose(jnp.asarray(pq), jnp.asarray(pt)),
                   pose_predict=JPose(jnp.asarray(rq), jnp.asarray(rt)),
                   extrinsics=JPose(jnp.asarray(eq), jnp.asarray(et)), ext_mode=1,
                   cost=jnp.asarray(0.0), n_corner=jnp.asarray(0), n_surf=jnp.asarray(0))

    def c(a):
        return torch.from_numpy(np.array(a)).as_subclass(CountingTensor)

    tout = OdometryOutput(pose=Pose(c(jout.pose.q), c(jout.pose.t)),
                          pose_predict=Pose(c(jout.pose_predict.q), c(jout.pose_predict.t)),
                          extrinsics=Pose(c(jout.extrinsics.q), c(jout.extrinsics.t)),
                          ext_mode=1, cost=c(0.0), n_corner=c(0), n_surf=c(0))

    def collect(mod, out):
        pub, msgs = mod.Publisher(), []
        for topic in ("/laser_odom", "/laser_odom_predict", "/extrinsics"):
            pub.subscribe(topic, msgs.append, spin=True)
        mod.publish_odometry_output(pub, out, stamp=2.5, ext_cov=cov)
        return msgs

    CountingTensor.calls = []
    got = collect(TPub, tout)
    assert CountingTensor.calls.count("cpu") == 1, CountingTensor.calls
    assert "item" not in CountingTensor.calls and "tolist" not in CountingTensor.calls
    want = collect(JPub, jout)
    assert [type(m).__name__ for m in got] == [type(m).__name__ for m in want]
    for a, b in zip(got, want):
        for f in a.__dataclass_fields__:
            x, y = getattr(a, f), getattr(b, f)
            if isinstance(y, (np.ndarray, jnp.ndarray)):
                assert np.asarray(x).shape == np.asarray(y).shape
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            else:
                assert x == y, f


# -------------------------------------------------------------------- plots

@pytest.fixture(scope="module")
def plot_inputs():
    rng = np.random.default_rng(8)
    t = np.cumsum(rng.normal(0, 0.1, (30, 3)), axis=0)
    xyz = rng.uniform(-10, 10, (500, 3)).astype(np.float32)
    mask = rng.uniform(size=500) < 0.8
    return t, xyz, mask


PLOTS = {
    "plot_trajectory": lambda t, xyz, m: dict(est_t=t, gt_t=t + 0.01, loops=[(0, 20)]),
    "plot_map": lambda t, xyz, m: dict(xyz=xyz, mask=m, traj_t=t),
    "plot_plane_normals": lambda t, xyz, m: dict(points=xyz, normals=xyz / 10, mask=m),
    "plot_scan_context": lambda t, xyz, m: dict(descriptor=xyz[:200, 0].reshape(10, 20)),
    "plot_pose_graph": lambda t, xyz, m: dict(node_t=t, loop_edges=[(1, 25)], corrected_t=t),
}


@pytest.mark.parametrize("fn", list(PLOTS))
def test_each_plot_writes_a_png(fn, plot_inputs, tmp_path):
    path = tmp_path / f"{fn}.png"
    getattr(TV, fn)(str(path), **PLOTS[fn](*plot_inputs))
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_export_map_pcd_writes_the_reference_bytes(plot_inputs, tmp_path):
    _, xyz, mask = plot_inputs
    TV.export_map_pcd(str(tmp_path / "t.pcd"), xyz, mask)
    JV.export_map_pcd(str(tmp_path / "j.pcd"), xyz, mask)
    assert (tmp_path / "t.pcd").read_bytes() == (tmp_path / "j.pcd").read_bytes()
    assert f"POINTS {int(mask.sum())}" in (tmp_path / "t.pcd").read_text()
