"""The distributed solvers' scaling report, port vs JAX package.

``measure_dd_costs`` against the JAX one on a virtual CPU mesh (4 of
conftest's 8 devices, 1-D and 2x2, as ``tests/test_torch_mesh.py`` makes
them) at a 64-pose survey graph with a 16-point x 64-candidate BA map: the
partition, the input bytes a shard holds and the collective bytes a GN
iteration moves within a node (``intra``: the JAX package's ``ici``) and
across nodes (``inter``: ``dcn``) equal; the port counts every call, the
compiled HLO combines some (recorded, not compared). At the report's full
shapes, on the host only: the four rows' partitions and input bytes equal
the JAX record's (``results/scaling/summary.json``, whose figures are held
here as constants); and the bare pose graph's collective bytes, counted by
one GN iteration on the CPU, equal it too. ``efficiency_from_card_ms``
equals ``efficiency_from_measured_ms`` with the JAX module's fabric
constants set to the same fabric, to 1e-12 relative. The report runs end
to end at a small shape, and the PCG's legacy model gives the JAX formula's
bytes.
"""

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from mloam_tpu.models import experiments as JX
from mloam_tpu.parallel import scaling_model as JSM
from mloam_tpu.parallel.mesh import FACTOR_AXIS, HOST_AXIS
from mloam_tpu_torch.models import experiments as X
from mloam_tpu_torch.parallel import mesh as M
from mloam_tpu_torch.parallel import scaling_model as SM

# the JAX record (results/scaling/summary.json, "model"): partition
# (interiors, intra separators a host, global separators, owned separators),
# input bytes a shard, collective bytes a GN iteration (ici, dcn)
RECORD = {
    "intra_8gpu_ba": ((121, 0, 81, 11), 17328336, 973252, 0),
    "inter_2node_ba": ((123, 49, 39, 9), 17328232, 1119360, 319204),
    "intra_8gpu_pgo": ((121, 0, 81, 11), 26832, 973252, 0),
    "inter_2node_pgo": ((123, 49, 39, 9), 26728, 1119360, 319204),
}
# model_cg_legacy.bytes_psum_per_gn_iter of the same record (1024 poses)
RECORD_CG_LEGACY_BYTES = 3317764
FABRIC = SM.hgx_h100(2.5e-5)


def _partition(meas):
    p = meas["partition"]
    return (p["interior_per_shard"], p["intra_sep_per_host"], p["global_sep"],
            p["owned_sep_per_shard"])


def _meshes(layout):
    devs = np.asarray(jax.devices()[:4])
    if layout == "1d":
        return Mesh(devs, (FACTOR_AXIS,)), M.make_mesh(4, device="cpu")
    return (Mesh(devs.reshape(2, 2), (HOST_AXIS, FACTOR_AXIS)),
            M.make_multihost_mesh(2, 2, device="cpu"))


@pytest.mark.parametrize("layout", ["1d", "2x2"])
def test_measure_dd_costs_matches_the_jax_one(layout):
    jmesh, mesh = _meshes(layout)
    kw = dict(n_loops=4, ba_points=16, ba_map=64, assoc_chunk=8)
    got = SM.measure_dd_costs(64, mesh, **kw)
    want = JSM.measure_dd_costs(64, jmesh, **kw)
    for k in ("input_bytes_per_device", "n_poses", "n_edges", "mesh", "partition", "ba"):
        assert got[k] == want[k], k
    c, jc = got["collectives_per_gn"], want["collectives_per_gn"]
    assert c["intra"]["bytes"] == jc["ici"]["bytes"] > 0
    assert c["inter"]["bytes"] == jc["dcn"]["bytes"]
    assert (c["inter"]["bytes"] > 0) == (layout == "2x2")
    assert c["intra"]["count"] >= jc["ici"]["count"] and c["inter"]["count"] >= jc["dcn"]["count"]
    assert sum(v["bytes"] for v in c["by_axes"].values()) == (c["intra"]["bytes"]
                                                              + c["inter"]["bytes"])


@pytest.mark.parametrize("name", list(RECORD))
def test_the_report_shapes_equal_the_record(name):
    part, input_bytes, intra, inter = RECORD[name]
    hosts = 2 if name.startswith("inter") else 1
    mesh = M.make_multihost_mesh(2, 8, device="cpu") if hosts == 2 else M.make_mesh(8, device="cpu")
    ba = (1024, 4096) if name.endswith("_ba") else (0, 0)
    got = SM.dd_layout(1024 * hosts, mesh, ba_points=ba[0], ba_map=ba[1])
    assert _partition(got) == part
    assert got["input_bytes_per_device"] == input_bytes
    assert got["n_edges"] == (4118 if hosts == 1 else 8214)
    if not name.endswith("_ba"):
        # the bare graph's GN iteration runs here; the BA map adds no collective
        c = SM.measure_dd_costs(1024 * hosts, mesh)["collectives_per_gn"]
        assert (c["intra"]["bytes"], c["inter"]["bytes"]) == (intra, inter)


def _as_jax(meas):
    c = meas["collectives_per_gn"]
    return {**meas, "collectives_per_gn": {"ici": c["intra"], "dcn": c["inter"]}}


@pytest.mark.parametrize("shape", [[8], [2, 8]], ids=["one_node", "two_nodes"])
def test_efficiency_equals_the_jax_arithmetic(monkeypatch, shape):
    meas = {"mesh": {"shape": shape}, "input_bytes_per_device": 17328336,
            "collectives_per_gn": {"intra": {"bytes": 1119360, "count": 3},
                                   "inter": {"bytes": 319204 if len(shape) == 2 else 0,
                                             "count": 6 if len(shape) == 2 else 0}}}
    for k, v in (("ICI_BW", FABRIC.intra_bw), ("DCN_BW", FABRIC.inter_bw),
                 ("ICI_LAT", FABRIC.intra_lat_s), ("DCN_LAT", FABRIC.inter_lat_s)):
        monkeypatch.setattr(JSM, k, v)
    got = SM.efficiency_from_card_ms(meas, 101.6, 0.26, FABRIC, iters=10)
    want = JSM.efficiency_from_measured_ms(_as_jax(meas), 101.6, 0.26, iters=10)
    names = {"t_comm_intra_ms_per_gn": "t_comm_ici_ms_per_gn",
             "t_comm_inter_ms_per_gn": "t_comm_dcn_ms_per_gn"}
    for k, v in got.items():
        if k == "fabric":
            assert v == dataclasses.asdict(FABRIC)
            continue
        w = want[names.get(k, k)]
        assert v == pytest.approx(w, rel=1e-12, abs=0), k
    assert set(got) - {"fabric"} == set(names) | (set(want) - set(names.values()))
    assert 0.0 < got["efficiency_full_solve_measured"] < got["efficiency_per_iter_measured"] <= 1


def test_the_fabric_is_the_callers():
    f = SM.hgx_h100(3e-5)
    assert (f.intra_bw, f.inter_bw, f.intra_lat_s, f.inter_lat_s) == (450e9, 50e9, 3e-5, 3e-5)
    assert "NVLink" in f.source and "ConnectX-7" in f.source and "measured" in f.source
    assert {fl.name for fl in dataclasses.fields(SM.Fabric)} == {
        "intra_bw", "inter_bw", "intra_lat_s", "inter_lat_s", "source"}
    assert all(fl.default is dataclasses.MISSING for fl in dataclasses.fields(SM.Fabric))


def test_the_report_runs_end_to_end_at_a_small_shape():
    card = {"ba": {"shard_ms_per_gn": 120.0, "sep_solve_ms_per_gn": 0.3},
            "pgo": {"shard_ms_per_gn": 100.0, "sep_solve_ms_per_gn": 0.3}}
    rep = SM.dd_scaling_report(FABRIC, card, ba_points=8, ba_map=32, n_poses_chip=64,
                               n_poses_host=128, device="cpu")
    assert list(rep) == ["intra_8gpu_ba", "inter_2node_ba", "intra_8gpu_pgo", "inter_2node_pgo"]
    for name, r in rep.items():
        assert r["mesh"]["shape"] == ([8] if name.startswith("intra") else [2, 8])
        assert (r["collectives_per_gn"]["inter"]["bytes"] == 0) == name.startswith("intra")
        assert r["ba"]["points"] == (8 if name.endswith("_ba") else 0)
        for k in ("efficiency_per_iter_measured", "efficiency_full_solve_measured"):
            assert 0.0 < r[k] <= 1.0
    shape_only = SM.dd_scaling_report(None, None, ba_points=8, ba_map=32, n_poses_chip=64,
                                      n_poses_host=128, device="cpu")
    assert "efficiency_per_iter_measured" not in shape_only["intra_8gpu_pgo"]


def test_the_legacy_pcg_model_gives_the_jax_formula():
    jax_model = JX._pgo_comm_compute_model(1024, 4118, 8, max(1024 // 8, 32))
    counted = {"psum:factor": {"calls": 260.0, "bytes": 6.4e6}}
    got = X.cg_legacy_model(1024, 4118, counted, 350.0, 256, FABRIC)
    assert got["bytes_psum_per_gn_iter"] == jax_model["bytes_psum_per_gn_iter"] \
        == RECORD_CG_LEGACY_BYTES
    assert got["bytes_formula_at_run_cg_iters"] == 1024 * 168 + 4 + 256 * 1024 * 24
    for name, shards in (("intra_8gpu", 8), ("inter_2node", 16)):
        r = got[name]
        assert r["shards"] == shards
        assert r["measured_shard_ms_per_gn"] == pytest.approx(350.0 / shards)
        assert 0.0 < r["efficiency_per_iter_measured"] <= 1.0
    assert got["intra_8gpu"]["t_comm_inter_ms_per_gn"] == 0.0
    assert got["inter_2node"]["t_comm_intra_ms_per_gn"] == 0.0
    assert "intra_8gpu" not in X.cg_legacy_model(1024, 4118, counted, None, 256, None)
