"""Real-time backpressure: frame-drop gating for live sensor streams. The
port's own copy of ``mloam_tpu/utils/realtime.py``: the same decisions on the
same clock and stamps.

Counterpart of the reference's load shedding — the odometry node drops
buffered sweeps when processing lags the stream (``rosNodeSR.cpp:111-123``)
and the mapper drops its backlog to stay current
(``lidar_mapper_keyframe.cpp:1048-1053``). Here the policy is a host-side
gate in front of the pipeline: admit a frame only while wall-clock progress
keeps up with stream progress, within a bounded lag budget.

The gate is pure host logic (no device work), deterministic under an
injected clock, and keeps the same observable the reference logs: a running
drop counter.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Iterator


class RealtimeGate:
    """Admit/drop decisions for a timestamped frame stream.

    ``admit(t)`` is called with each frame's stream timestamp (seconds,
    monotone increasing). The first admitted frame anchors stream time to
    wall time; afterwards a frame is admitted iff processing lag
    (wall elapsed − stream elapsed) is at most ``max_lag_s``. Dropped frames
    increment ``n_dropped`` (the reference's ``frame_drop_cnt``).
    """

    def __init__(self, max_lag_s: float = 0.2,
                 clock: Callable[[], float] = time.monotonic):
        self.max_lag_s = float(max_lag_s)
        self._clock = clock
        self._wall0: float | None = None
        self._t0: float | None = None
        self.n_admitted = 0
        self.n_dropped = 0

    def admit(self, t: float) -> bool:
        now = self._clock()
        if self._wall0 is None:
            self._wall0, self._t0 = now, t
            self.n_admitted += 1
            return True
        lag = (now - self._wall0) - (t - self._t0)
        if lag > self.max_lag_s:
            self.n_dropped += 1
            return False
        self.n_admitted += 1
        return True

    def stats(self) -> dict:
        return {"admitted": self.n_admitted, "dropped": self.n_dropped}


def gated(stream: Iterable[tuple[float, object]],
          gate: RealtimeGate) -> Iterator[tuple[float, object]]:
    """Filter an iterator of (timestamp, frame) through the gate."""
    for t, frame in stream:
        if gate.admit(t):
            yield t, frame
