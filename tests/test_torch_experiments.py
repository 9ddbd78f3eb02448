"""The port's experiment programs against the JAX package's.

The fixed perturbation directions of ``inject_ext`` are the JAX package's
draws (to f32 rounding, 1e-7), ``mc``'s four cells are the JAX package's
configurations field by field, and ``long``'s drift trace equals the JAX
program's computation on the same arrays (1e-5 m: f32 pose algebra in a
different order). Every program's measurement runs at 8x360 for 3-6 sweeps
on the CPU, writes into a temporary directory, and its summary has the keys
of the JAX package's record under ``results/<program>/summary.json``, each
difference listed in ``DIFFERENCES`` with its reason; its plots' inputs draw
to PNGs. ``scaling`` runs its solvers at 64 poses on stacked meshes, with
the JAX program's own gates, and has the record's measured rows."""

import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mloam_tpu.core import se3 as jse3
from mloam_tpu.core.se3 import Pose as JPose
from mloam_tpu.models import platforms as jplatforms
from mloam_tpu_torch.core.rangeimage import LidarModel
from mloam_tpu_torch.models import experiments as X

RECORDS = pathlib.Path(__file__).resolve().parent.parent / "results"


def test_inject_ext_directions_equal_the_jax_draws():
    for key, d in ((42, X.D_RHO), (43, X.D_PHI)):
        v = jax.random.normal(jax.random.PRNGKey(key), (3,))
        v = np.asarray(v / jnp.linalg.norm(v))
        np.testing.assert_allclose(np.asarray(d, np.float32), v, atol=1e-7)
        assert abs(np.linalg.norm(d) - 1.0) < 1e-6


def test_mc_cells_equal_the_jax_configurations():
    cells = X.mc_cells()
    want = {}
    for rig in (1, 2):       # mloam_tpu/models/experiments.py:149-155
        for preset in ("default", "tuned"):
            cfg = jplatforms.synthetic(n_lidars=rig, extrinsic_mode=0)
            if preset == "tuned":
                cfg = jplatforms.realtime_tuned(cfg)
            want[f"{'single' if rig == 1 else 'dual'}_{preset}"] = (cfg, rig)
    assert list(cells) == list(want)
    for name, (cfg, rig) in cells.items():
        assert rig == want[name][1]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want[name][0]), name


def test_long_drift_trace_equals_the_jax_program_on_the_same_arrays():
    rng = np.random.default_rng(9)
    n = 230
    gt_t = np.cumsum(rng.normal(0, 0.2, (n, 3)), axis=0).astype(np.float32)
    q = rng.normal(size=(n, 4))
    gt_q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    est_t = (gt_t - gt_t[0] + rng.normal(0, 0.05, (n, 3))).astype(np.float32)
    # mloam_tpu/models/experiments.py:925-936
    g0 = JPose(jnp.asarray(gt_q[0]), jnp.asarray(gt_t[0]))
    gt_rel = np.stack([np.asarray(jse3.compose(jse3.inverse(g0),
                                               JPose(jnp.asarray(gt_q[i]), jnp.asarray(gt_t[i]))).t)
                       for i in range(n)])
    err = np.linalg.norm(est_t - gt_rel, axis=1)
    seg = [float(err[min(k + 99, len(err) - 1)]) for k in range(0, len(err), 100)]
    t_rel, t_err, t_seg = X.drift_trace(est_t, gt_t, gt_q)
    np.testing.assert_allclose(t_rel, gt_rel, atol=1e-5)
    np.testing.assert_allclose(t_err, err, atol=1e-5)
    np.testing.assert_allclose(t_seg, seg, atol=1e-5)
    assert len(t_seg) == 3


def small(cfg):
    """8x360 sensors, small caps and a 4-sweep window."""
    L = cfg.rig.n_lidars
    return dataclasses.replace(
        cfg, rig=dataclasses.replace(cfg.rig, models=(LidarModel(n_rings=8, n_cols=360),) * L),
        features=dataclasses.replace(cfg.features, cap_less_flat=512),
        odometry=dataclasses.replace(cfg.odometry, window_size=4, opt_window_size=2,
                                     cap_frame_corner=128, cap_frame_surf=256,
                                     localmap_precap_corner=256, localmap_precap_surf=640),
        mapping=dataclasses.replace(cfg.mapping, max_keyframes=8, cap_map_corner=1024,
                                    cap_map_surf=2048))


KW = {"device": "cpu", "configure": small}

# program -> (record, measurement, writer, files the writer must leave)
PROGRAMS = {
    "single": ("single", lambda: X.measure_single(4, **KW), X.write_single,
               {"traj_est_seed0.tum", "summary.json", "plots.json", "plots.npz"}),
    "mc": ("mc", lambda: X.measure_mc(1, 3, **KW), X.write_mc,
           {"traj_trial0.tum", "summary.json"}),
    "inject_ext": ("inject_ext", lambda: X.measure_inject_ext(3, 0, 1, ("gt", "inj"), **KW),
                   X.write_inject_ext, {"summary.json"}),
    "calib": ("calib", lambda: X.measure_calib(4, **KW), X.write_calib,
              {"summary.json", "extrinsic_trace.json"}),
    "slam_wander": ("slam", lambda: X.measure_slam(6, **KW), X.write_slam,
                    {"traj_est.tum", "summary.json", "map.pcd", "plots.json", "plots.npz"}),
    "slam_loop": ("slam", lambda: X.measure_slam(6, traj="loop", **KW), X.write_slam,
                  {"traj_est.tum", "summary.json", "map.pcd", "plots.json", "plots.npz"}),
    "corridor": ("corridor", lambda: X.measure_corridor(4, **KW), X.write_corridor,
                 {"summary.json", "plots.json", "plots.npz"}),
    "dynamic": ("dynamic", lambda: X.measure_dynamic(3, **KW), X.write_dynamic,
                {"summary.json", "plots.json", "plots.npz"}),
    "long": ("long", lambda: X.measure_long(4, **KW), X.write_long,
             {"traj_est.tum", "summary.json", "plots.json", "plots.npz"}),
    "scaling": ("scaling", lambda: X.measure_scaling(64, device="cpu"), X.write_scaling,
                {"summary.json"}),
}

# (keys of the record the port's summary lacks, keys it has beyond the record)
DIFFERENCES = {
    # "note" was added to the record file by hand; the JAX program writes none
    "mc": ({"note"}, set()),
    # "analysis" was added to the record by hand; this run takes 2 of 5 levels
    "inject_ext": ({"analysis", "ref", "cad", "ini"}, set()),
    # the JAX program writes both since its record was made
    "calib": (set(), {"lidars", "mapper_ext_cov_installed"}),
    # both programs write the keyframe ATE only when a loop closed
    "slam_wander": ({"kf_ate_corrected_m", "kf_ate_odom_m"}, set()),
    "slam_loop": ({"kf_ate_corrected_m", "kf_ate_odom_m"}, set()),
    # the JAX program writes the mapper's block since its record was made
    "corridor": (set(), {"mapper"}),
    # likewise the timing note
    "long": (set(), {"timing_note"}),
    # the JAX program reads its chip ms from a file (chip_ms); the port times
    # the card itself (card_ms, and the report in model: null on the CPU),
    # writes the collectives its meshes count, and names the device it ran on
    "scaling": ({"chip_ms"}, {"collectives_per_gn", "card_ms", "device"}),
}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_program_measures_and_writes_with_the_records_keys(name, tmp_path):
    record, measure, write, files = PROGRAMS[name]
    res = measure()
    s = res["summary"]
    d = pathlib.Path(write(res, str(tmp_path)))
    assert d.parent == tmp_path and files <= {p.name for p in d.iterdir()}
    assert json.loads((d / "summary.json").read_text()) == json.loads(json.dumps(s))
    rec = json.loads((RECORDS / record / "summary.json").read_text())
    lacks, extra = DIFFERENCES.get(name, (set(), set()))
    assert set(s) == (set(rec) - lacks) | extra, sorted(set(s) ^ set(rec))
    if "platform" in s:
        assert s["platform"] == "cpu"
    # nested records: the per-cell, per-level, per-run and per-mode keys
    nested = {"mc": lambda x: x["cells"]["single_default"],
              "inject_ext": lambda x: x["gt"],
              "corridor": lambda x: x["remap_on"],
              "dynamic": lambda x: x["modes"],
              "scaling": lambda x: x["measured"]}
    if name in nested:
        got, want = set(nested[name](s)), set(nested[name](rec))
        assert got == want | ({"candidate_frames"} if name == "corridor" else set())
    if (d / "plots.json").exists():
        pngs = X.draw(str(d))
        assert pngs and all(pathlib.Path(p).read_bytes()[:4] == b"\x89PNG" for p in pngs)
