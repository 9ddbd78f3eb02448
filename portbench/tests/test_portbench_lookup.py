"""A configuration, a traffic mix, a cell and a metric added as new files in
a copy of the harness are found by name, with no existing file edited."""

import hashlib
import json

from portbench import harness


def _digests(pkg):
    return {p.relative_to(pkg): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in pkg.rglob("*") if p.is_file()}


def test_new_files_are_found_by_name(small_tree):
    pkg, root = small_tree
    before = _digests(pkg)
    conf = json.loads((pkg / "configs/kitti00_graph.json").read_text())
    conf.update(n_poses=260, n_loops=8)
    (pkg / "configs/short_drive.json").write_text(json.dumps(conf))
    mix = json.loads((pkg / "traffic/loop_closures.json").read_text())
    mix["gn_steps"] = 5
    (pkg / "traffic/loop_closures_5.json").write_text(json.dumps(mix))
    (pkg / "limits/short_drive_loops.json").write_text(
        json.dumps({"pose_t_m": 1, "pose_r_rad": 1}))
    (pkg / "metrics/window.solves.py").write_text(
        "def read(ctx):\n    w = ctx.get('window')\n    return None if not w else w.get('solves')\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="short_drive",
                                 file="portbench/configs/short_drive.json"))
    bench["workloads"].append({"name": "short_drive_loops", "config": "short_drive",
                               "traffic": "loop_closures_5", "chips": 1, "why": "x"})
    next(m for m in bench["end_to_end"] if m["name"] == "pgo_gn_ms")["workloads"].append(
        "short_drive_loops")
    bench["per_layer"].append({"name": "window.solves", "unit": "solves", "better": "higher",
                               "source": "host_clock", "layer": "pose graph",
                               "moves": "pgo_gn_ms"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(pkg)
    assert all(after[k] == v for k, v in before.items())   # nothing edited
    b = harness.benchmark(root)
    cell = harness.cell_spec(b, "short_drive_loops")
    c, t, lim = harness.cell_files(cell, pkg)
    assert c["n_poses"] == 260 and t["gn_steps"] == 5 and lim["pose_t_m"] == 1
    assert harness.kind_module(t, pkg).__name__.endswith("pgo_loops")
    per = [m["name"] for m in harness.cell_metrics(b, "short_drive_loops", True)]
    assert "window.solves" in per            # no workloads key: every cell of pgo_gn_ms
    assert "pgo.factor_ms" not in per        # listed for its own cells only
    got = harness.read_metrics([m for m in b["per_layer"] if m["name"] == "window.solves"],
                               {"window": {"solves": 7, "seconds": 1.0}}, pkg)
    assert got == {"window.solves": {"value": 7.0, "unit": "solves"}}
    # a reader that finds nothing leaves its metric out
    assert harness.read_metrics([m for m in b["per_layer"] if m["name"] == "window.solves"],
                                {}, pkg) == {}
