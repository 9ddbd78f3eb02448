"""Stage timers that do not wait for the device.

``utils/timing.timer`` reads the host clock only unless asked to
synchronise (``sync=True``), so the pipelines' stage timers
(``odom_mea_pre``, ``odom_tracker``, ``odom_solver``, ``map_step``) issue no
device wait by default, and one at each stage's entry and exit with
``sync_timing=True`` (the JAX package's ``MLOAM_SYNC_TIMING=1``).
``timing._sync``, the synchronising branch, is wrapped to count its calls (on
the CPU it waits for nothing). At 8x360 with a 4-sweep window: inside
``process`` no call by default over every sweep, steady sweeps included;
with ``sync_timing=True`` two per stage recorded, on the odometry, mapping
and SLAM pipelines; ``run_synthetic.run``'s per-sweep ``odom_process``
timer still waits at each end of every sweep; the stage stats and the
mapper's rebuild / reuse split are recorded in both modes.
"""

import dataclasses

import pytest

from mloam_tpu_torch.core.rangeimage import LidarModel, RangeImage
from mloam_tpu_torch.models import pipeline as P
from mloam_tpu_torch.models import platforms, run_synthetic
from mloam_tpu_torch.utils import timing

N = 7
STAGES = ("odom_mea_pre", "odom_tracker", "odom_solver", "map_step")


def small(cfg):
    """8x360 sensors, small caps and a 4-sweep window."""
    return dataclasses.replace(
        cfg, rig=dataclasses.replace(cfg.rig, models=(LidarModel(n_rings=8, n_cols=360),)),
        features=dataclasses.replace(cfg.features, cap_less_flat=512),
        odometry=dataclasses.replace(cfg.odometry, window_size=4, opt_window_size=2,
                                     cap_frame_corner=128, cap_frame_surf=256,
                                     localmap_precap_corner=256, localmap_precap_surf=640),
        mapping=dataclasses.replace(cfg.mapping, max_keyframes=8, cap_map_corner=1024,
                                    cap_map_surf=2048, skip_frames=1))


CFG = small(platforms.synthetic(n_lidars=1))


@pytest.fixture(scope="module")
def frames():
    seqs, _ = run_synthetic.render_rig(CFG, N, seed=0, device="cpu")
    return [[RangeImage(*(f[i] for f in seqs[0]))] for i in range(N)]


@pytest.fixture
def waits(monkeypatch):
    calls = [0]
    real = timing._sync

    def counted():
        calls[0] += 1
        real()

    monkeypatch.setattr(timing, "_sync", counted)
    timing.reset()
    yield calls
    timing.reset()


def _records():
    return sum(len(timing._registry.get(k, [])) for k in STAGES)


def _drive(pipe, frames, waits):
    """(device waits, stage records) inside each ``process`` call."""
    out = []
    for f in frames:
        w0, r0 = waits[0], _records()
        pipe.process(f)
        out.append((waits[0] - w0, _records() - r0))
    return out


@pytest.mark.parametrize("kind", ["odometry", "full", "slam"])
@pytest.mark.parametrize("sync_timing", [False, True], ids=["default", "sync_timing"])
def test_stage_timers_wait_only_with_sync_timing(frames, waits, kind, sync_timing):
    pipe = {"odometry": lambda: P.OdometryPipeline(CFG, device="cpu", sync_timing=sync_timing),
            "full": lambda: P.FullPipeline(CFG, device="cpu", sync_timing=sync_timing),
            "slam": lambda: P.SlamPipeline(CFG, loop_capacity=8, device="cpu",
                                           sync_timing=sync_timing)}[kind]()
    odom = {"odometry": pipe, "full": getattr(pipe, "odom", None),
            "slam": getattr(getattr(pipe, "full", None), "odom", None)}[kind]
    assert odom.sync_timing is sync_timing
    per_sweep = _drive(pipe, frames, waits)
    assert all(r >= 1 for _, r in per_sweep)
    if sync_timing:
        # one wait at each stage's entry and exit, the steady sweeps' three
        # stages (and a mapped sweep's map_step) included
        assert [w for w, _ in per_sweep] == [2 * r for _, r in per_sweep]
        assert max(r for _, r in per_sweep[CFG.odometry.window_size + 1:]) >= 3
    else:
        assert [w for w, _ in per_sweep] == [0] * N
    # the frontend every sweep, the tracker from the second, the window
    # solve once the window is full
    n = {k: timing.stats(k)["n"] for k in STAGES[:3]}
    assert n == {"odom_mea_pre": N, "odom_tracker": N - 1,
                 "odom_solver": N - CFG.odometry.window_size}
    if kind != "odometry":
        steps = timing.stats("map_step")["n"]
        split = sum((timing.stats(k) or {"n": 0})["n"]
                    for k in ("map_step_rebuild", "map_step_reuse"))
        assert steps >= 1 and split == steps


def test_the_per_sweep_timer_still_waits_at_each_end(waits):
    """``run_synthetic.run``'s ``odom_process`` timer synchronises at the
    start and the end of every sweep, and nothing else waits."""
    per_sweep, seen = [], [0]

    def on_sweep(i, out, pipe):
        per_sweep.append(waits[0] - seen[0])
        seen[0] = waits[0]

    res = run_synthetic.run(n_frames=N, verbose=False, device="cpu", cfg=CFG,
                            on_sweep=on_sweep)
    assert per_sweep == [2] * N
    assert len(res["sweep_ms"]) == N and timing.stats("odom_process")["n"] == N
    assert timing.stats("odom_solver")["n"] == N - CFG.odometry.window_size


def test_timer_records_host_time_without_waiting(waits):
    with timing.timer("host_only"):
        pass
    with timing.timer("synchronised", sync=True):
        pass
    assert waits[0] == 2
    assert timing.stats("host_only")["n"] == 1 and timing.stats("synchronised")["n"] == 1
    assert timing.last("host_only") >= 0.0
