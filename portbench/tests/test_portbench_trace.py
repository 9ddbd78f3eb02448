"""The busy-interval union, idle share, kernel sums and idle gaps on
synthetic profiler events."""

import pytest

from portbench import trace as T


def _trace(device, host=(), window_s=1.0, units=1, launched=None):
    return T.Trace(list(device), list(host), launched or {}, window_s, units)


def test_union_merges_overlaps_and_keeps_gaps():
    dev = [("a", 0.0, 0.1), ("b", 0.05, 0.2), ("c", 0.5, 0.6), ("d", 0.6, 0.7)]
    assert T.union(dev) == [(0.0, 0.2), (0.5, 0.7)]
    tr = _trace(dev)
    assert T.busy_s(tr) == pytest.approx(0.4)
    assert T.idle_pct(tr) == pytest.approx(60.0)


def test_overlapping_streams_are_not_counted_twice():
    # two kernels fully overlapping: busy is the longer one, not the sum
    tr = _trace([("k1", 0.1, 0.3), ("k2", 0.15, 0.25)], window_s=0.5)
    assert T.busy_s(tr) == pytest.approx(0.2)
    assert T.idle_pct(tr) == pytest.approx(60.0)


def test_no_device_op_reads_nothing():
    assert T.idle_pct(_trace([])) is None


def test_device_ops_summed_by_name_largest_first():
    dev = [("potrf", 0.0, 0.001), ("potrf", 0.002, 0.004),
           ("gemm", 0.01, 0.0115), ("elementwise", 0.02, 0.0205)]
    ops = T.device_ops(_trace(dev))
    assert [n for n, _ in ops] == ["potrf", "gemm", "elementwise"]
    assert ops[0][1] == pytest.approx(0.003)


def test_factor_ms_reads_the_kernels_under_the_two_host_ops():
    from portbench import harness

    read = harness.metric_reader("pgo.factor_ms")
    launched = {"aten::linalg_cholesky_ex": 0.30, "aten::cholesky_solve": 0.02, "aten::mul": 0.5}
    ctx = {"trace": _trace([("k", 0.0, 1.0)], launched=launched), "traced_steps": 2}
    assert read(ctx) == pytest.approx(160.0)
    assert read({}) is None
    assert read({"trace": _trace([("k", 0.0, 1.0)]), "traced_steps": 2}) is None


def test_idle_gaps_named_by_the_outermost_host_op():
    dev = [("k", 0.0, 0.1), ("k", 0.3, 0.4), ("k", 0.6, 0.7), ("k", 0.75, 0.8)]
    host = [("aten::einsum", 0.12, 0.28), ("aten::bmm", 0.15, 0.2),
            ("aten::add", 0.71, 0.74)]
    gaps = dict(T.idle_gaps(_trace(dev, host)))
    assert gaps["aten::einsum"] == pytest.approx(0.2)   # the 0.1-0.3 gap
    assert gaps["python"] == pytest.approx(0.2)         # 0.4-0.6: no host op ran
    assert gaps["aten::add"] == pytest.approx(0.05)
    assert "aten::bmm" not in gaps


def test_breakdown_lists_at_most_ten_entries():
    dev = [(f"k{i}", i * 1.0, i * 1.0 + 0.5) for i in range(30)]
    b = T.breakdown(_trace(dev, window_s=30.0))
    assert len(b["device_ops"]) == 10 and len(b["idle_gaps"]) <= 10
    assert all(isinstance(x[1], float) for x in b["device_ops"])
