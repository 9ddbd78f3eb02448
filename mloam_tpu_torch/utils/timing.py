"""Named stage timers with a global registry.

Same stable stage names as the JAX package's registry (odom_mea_pre,
odom_process, odom_solver, ...). PyTorch returns from a CUDA op before the
device finishes, so by default a ``timer`` reads the host clock only, as
the JAX package's does: the time it records is the host's time to issue
the stage, and the device is not waited for. ``timer(name, sync=True)``
synchronises the device before it reads the clock on entry and on exit (the
counterpart of ``block_until_ready`` at the JAX package's call sites); on a
CPU-only process that is a no-op.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import numpy as np
import torch

_registry: dict[str, list[float]] = defaultdict(list)


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextmanager
def timer(name: str, sync: bool = False):
    if sync:
        _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            _sync()
        _registry[name].append(time.perf_counter() - t0)


def record(name: str, seconds: float):
    _registry[name].append(seconds)


def last(name: str) -> float:
    """The latest time recorded under ``name``, in seconds."""
    return _registry[name][-1]


def stats(name: str):
    v = np.asarray(_registry.get(name, []))
    if v.size == 0:
        return None
    return {
        "n": int(v.size),
        "mean_ms": float(v.mean() * 1e3),
        "min_ms": float(v.min() * 1e3),
        "max_ms": float(v.max() * 1e3),
        "p50_ms": float(np.percentile(v, 50) * 1e3),
        "p95_ms": float(np.percentile(v, 95) * 1e3),
    }


def report() -> str:
    lines = [f"{'stage':<28}{'n':>6}{'mean':>9}{'p50':>9}{'p95':>9}{'max':>9}  (ms)"]
    for name in sorted(_registry):
        s = stats(name)
        lines.append(
            f"{name:<28}{s['n']:>6}{s['mean_ms']:>9.2f}{s['p50_ms']:>9.2f}"
            f"{s['p95_ms']:>9.2f}{s['max_ms']:>9.2f}"
        )
    return "\n".join(lines)


def reset():
    _registry.clear()


def all_stats():
    return {k: stats(k) for k in _registry}
