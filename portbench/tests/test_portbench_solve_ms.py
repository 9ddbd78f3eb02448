"""The reader of ``pgo.solve_ms`` on synthetic traces: the device ops inside
the ``pgo.solve`` ranges, clipped to them and counted once where they
overlap, a step; nothing without the span."""

from portbench import harness
from portbench import trace as T


def _reader():
    return harness.metric_reader("pgo.solve_ms")


def test_the_ops_inside_the_span_are_summed_a_step():
    tr = T.Trace(device=[("pgo.solve", 1.0, 2.0), ("pgo.solve", 3.0, 4.0),
                         ("kernel_a", 1.1, 1.5), ("kernel_b", 1.4, 1.6),   # overlap: 0.5 s
                         ("kernel_c", 3.5, 4.5),                         # clipped: 0.5 s
                         ("kernel_d", 2.2, 2.8)],                        # outside
                 host=[], launched={}, window_s=5.0, units=1)
    got = _reader()({"trace": tr, "traced_steps": 2})
    assert abs(got - 500.0) < 1e-9


def test_no_span_reads_nothing():
    tr = T.Trace(device=[("kernel_a", 1.0, 2.0)], host=[], launched={"aten::mm": 1.0},
                 window_s=5.0, units=1)
    assert _reader()({"trace": tr, "traced_steps": 2}) is None
    assert _reader()({"traced_steps": 2}) is None
