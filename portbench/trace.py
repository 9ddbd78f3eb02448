"""The reduction from a ``torch.profiler`` trace to the numbers the metrics
read: device intervals and their union (busy time), device time by kernel
name and by the host op that launched it, and the longest idle gaps by what
the host was doing.

The arithmetic takes plain interval lists, so it is tested on synthetic
events on the CPU; ``collect`` is the one place that reads a profiler.
Times are in seconds.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from typing import NamedTuple


class Trace(NamedTuple):
    device: list      # [(name, start_s, end_s)] every device op
    host: list        # [(name, start_s, end_s)] every host op
    launched: dict    # {host op name: device seconds of the kernels it launched, children included}
    window_s: float   # host wall of the traced block, synchronised at both ends
    units: int        # units of work (solves) traced


def _is_device(e) -> bool:
    return "CUDA" in str(getattr(e, "device_type", ""))


def collect(prof, window_s: float, units: int) -> Trace:
    """Read a finished ``torch.profiler.profile`` of ``units`` units."""
    device, host, launched = [], [], {}
    for e in prof.events():
        tr = e.time_range
        span = (e.name, tr.start * 1e-6, tr.end * 1e-6)
        if _is_device(e):
            device.append(span)
        else:
            host.append(span)
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = getattr(e, "cuda_time_total", 0.0)
            if t:
                launched[e.name] = launched.get(e.name, 0.0) + t * 1e-6
    return Trace(device, host, launched, window_s, units)


@contextlib.contextmanager
def profiled(sync, out: dict):
    """Profile the block (host and device activity), synchronised at both
    ends; sets ``out["prof"]`` and ``out["window_s"]``."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield
        sync()
        out["window_s"] = time.perf_counter() - t0
    out["prof"] = prof


def union(intervals: list) -> list[tuple[float, float]]:
    """Merged (start, end) of ``[(name, start, end)]``, sorted."""
    merged: list[list[float]] = []
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_s(tr: Trace) -> float:
    """Seconds in which some device op ran (the union of their intervals)."""
    return sum(e - s for s, e in union(tr.device))


def idle_pct(tr: Trace) -> float | None:
    """Share of the traced window with no device op running, in %."""
    if tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - busy_s(tr) / tr.window_s)


def by_name(spans: list) -> dict[str, float]:
    """{name: summed seconds} of ``spans``."""
    out: dict[str, float] = {}
    for name, s, e in spans:
        out[name] = out.get(name, 0.0) + (e - s)
    return out


def _top_level(host: list) -> list[tuple[float, float, str]]:
    """The host ops no other host op contains, sorted by start."""
    out, reach = [], float("-inf")
    for name, s, e in sorted(host, key=lambda x: (x[1], -x[2])):
        if s >= reach:
            out.append((s, e, name))
            reach = e
        else:
            reach = max(reach, e)
    return out


def idle_gaps(tr: Trace, top: int = 10) -> list[list]:
    """The device's idle time between its first and last op, summed by what
    the host was doing at each gap's middle: the outermost host op there, or
    ``python`` where none ran (the interpreter between ops). The ``top``
    largest, [[name, seconds]]."""
    busy = union(tr.device)
    outer = _top_level(tr.host)
    starts = [s for s, _, _ in outer]
    sums: dict[str, float] = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        k = bisect.bisect_right(starts, mid) - 1
        name = outer[k][2] if k >= 0 and outer[k][1] >= mid else "python"
        sums[name] = sums.get(name, 0.0) + (s1 - e0)
    return [[n, s] for n, s in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]


def device_ops(tr: Trace, top: int = 10) -> list[list]:
    """The ``top`` device ops by summed time, [[name, seconds]]."""
    v = by_name(tr.device)
    return [[n[:120], x] for n, x in sorted(v.items(), key=lambda kv: -kv[1])[:top]]


def breakdown(tr: Trace) -> dict:
    return {"device_ops": device_ops(tr), "idle_gaps": idle_gaps(tr)}
