"""The last line: the contract's keys, ``checks`` last, and the metrics a
cell reports chosen from ``BENCHMARK.json``."""

import json

from portbench import harness


def test_result_line_keys_and_order():
    line = harness.result_line(
        True, 40, 0, {"pgo_gn_ms": {"value": 212.5, "unit": "ms"}},
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
         "memory_peak_bytes": 123},
        {"pose_t_m": {"value": 0.0, "limit": 1e-6}},
        {"device_ops": [["k", 0.1]], "idle_gaps": [["python", 0.2]]})
    d = json.loads(line)
    assert list(d) == ["correct", "attempted", "failed", "metrics", "device",
                       "breakdown", "checks"]
    assert "\n" not in line
    d = json.loads(harness.result_line(False, 1, 1, {}, {}, {}))
    assert "breakdown" not in d and list(d)[-1] == "checks" and d["correct"] is False


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        e2e = [m["name"] for m in harness.cell_metrics(bench, w["name"], False)]
        per = harness.cell_metrics(bench, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert per, w["name"]
        for m in per:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_every_metric_has_a_reader_and_every_cell_its_files():
    bench = harness.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"])), m["name"]
    for w in bench["workloads"]:
        conf, traffic, limits = harness.cell_files(w)
        assert harness.kind_module(traffic).run
        assert limits
