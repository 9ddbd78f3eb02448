"""pgo.solve_ms: device ms a Gauss-Newton step in the step's linear solve:
the time the device ran ops inside the program's ``pgo.solve`` spans (the
device-side range that the profiler records for a
``torch.profiler.record_function`` around the assembly of the damped system
from the pair sums, its factorisation and both substitutions, whichever
solver runs them), the union of those ops, over the traced steps.

The ops are found by time, within the span's device-side range, and not by
the host op that launched them (``trace.launched``): a kernel that the
program launches from a library of its own, outside PyTorch's dispatcher,
is traced on the device but linked to no host op. The device runs one
stream, so the ops within the range are the solve's. A program without the
span gives nothing."""

from portbench import trace as T

NAME = "pgo.solve"


def _overlap(a: list, b: list) -> float:
    """Seconds in both of two sorted lists of disjoint (start, end)."""
    i = j = 0
    out = 0.0
    while i < len(a) and j < len(b):
        out += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def read(ctx):
    tr, steps = ctx.get("trace"), ctx.get("traced_steps")
    if tr is None or not steps:
        return None
    spans = T.union([d for d in tr.device if d[0] == NAME])
    if not spans:
        return None
    ops = T.union([d for d in tr.device if d[0] != NAME])
    return _overlap(ops, spans) * 1e3 / steps
