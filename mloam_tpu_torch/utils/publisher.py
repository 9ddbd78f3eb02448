"""In-process typed pub/sub: the port's output surface for embedders. The
port's own copy of ``mloam_tpu/utils/publisher.py``: the same message types,
topics and queue semantics.

Counterpart of the reference's publishing layer — the templated ROS helpers
(``mloam_common/libs/include/common/publisher.hpp``), the estimator's
``registerPub/pubOdometry/pubPointCloud`` (``estimator/src/utility/
visualization.cpp:59-80``) and the ``mloam_msgs`` schema
(``Extrinsics.msg``/``Keyframes.msg``). There is no ROS here: consumers
subscribe callables to named topics; the SLAM host loop publishes typed
messages after each sweep. Per-subscriber bounded queues reproduce the
reference's ``queue_size`` semantics (depth 2-10 on its topics) with
drop-oldest backpressure and drop counters — a slow consumer (disk writer,
socket) never stalls the real-time loop.

Messages are plain host-side dataclasses (numpy, not device tensors): the
publisher boundary is where data leaves the GPU, as the reference's boundary
between the estimator thread and TCPROS. ``publish_odometry_output`` brings a
sweep's tensors to the host in one copy.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

__all__ = [
    "OdometryMsg", "ExtrinsicsMsg", "CloudMsg", "KeyframesMsg", "LoopMsg",
    "Publisher", "Subscription", "publish_odometry_output",
]


@dataclass(frozen=True)
class OdometryMsg:
    """nav_msgs/Odometry counterpart (pubOdometry, visualization.cpp)."""

    stamp: float
    frame_id: str
    t: np.ndarray            # [3]
    q: np.ndarray            # [4] wxyz
    cov: np.ndarray | None = None   # [6, 6] pose covariance


@dataclass(frozen=True)
class ExtrinsicsMsg:
    """mloam_msgs/Extrinsics counterpart: live calibration status + the
    per-lidar extrinsic estimates with covariance (Extrinsics.msg:1-3)."""

    stamp: float
    status: int              # live ESTIMATE_EXTRINSIC mode (2/1/0)
    q: np.ndarray            # [L, 4]
    t: np.ndarray            # [L, 3]
    cov: np.ndarray | None = None   # [L-1, 6, 6] (non-reference lidars)


@dataclass(frozen=True)
class CloudMsg:
    """sensor_msgs/PointCloud2 counterpart (fixed-capacity padded cloud)."""

    stamp: float
    frame_id: str
    xyz: np.ndarray          # [N, 3]
    mask: np.ndarray         # [N] bool
    intensity: np.ndarray | None = None


@dataclass(frozen=True)
class KeyframesMsg:
    """mloam_msgs/Keyframes counterpart (poses with covariance)."""

    stamp: float
    status: int
    q: np.ndarray            # [K, 4]
    t: np.ndarray            # [K, 3]
    cov: np.ndarray | None = None   # [K, 6, 6]


@dataclass(frozen=True)
class LoopMsg:
    """/loop_info counterpart: an accepted loop edge."""

    stamp: float
    query_index: int
    match_index: int
    rel_q: np.ndarray        # [4]
    rel_t: np.ndarray        # [3]


@dataclass
class Subscription:
    callback: Callable[[Any], None]
    queue_size: int
    queue: deque = field(default_factory=deque)
    dropped: int = 0

    def push(self, msg: Any) -> None:
        if len(self.queue) >= self.queue_size:
            self.queue.popleft()
            self.dropped += 1
        self.queue.append(msg)

    def drain(self) -> int:
        n = 0
        while self.queue:
            self.callback(self.queue.popleft())
            n += 1
        return n


class Publisher:
    """Named-topic registry with per-subscriber bounded queues.

    ``publish`` enqueues (never blocks, drop-oldest on overflow —
    rosNodeSR.cpp:111-123 frame-shedding semantics); ``spin_once`` drains
    every queue through its callback on the caller's thread. Immediate
    mode (``spin=True`` on subscribe) invokes the callback inline at
    publish time for cheap consumers.
    """

    def __init__(self):
        self._subs: dict[str, list[Subscription]] = {}
        self._immediate: dict[str, list[Callable[[Any], None]]] = {}
        self.n_published: dict[str, int] = {}

    def subscribe(self, topic: str, callback: Callable[[Any], None],
                  queue_size: int = 10, spin: bool = False) -> Subscription:
        sub = Subscription(callback=callback, queue_size=queue_size)
        if spin:
            self._immediate.setdefault(topic, []).append(callback)
        else:
            self._subs.setdefault(topic, []).append(sub)
        return sub

    def publish(self, topic: str, msg: Any) -> None:
        self.n_published[topic] = self.n_published.get(topic, 0) + 1
        for cb in self._immediate.get(topic, ()):  # inline consumers
            cb(msg)
        for sub in self._subs.get(topic, ()):
            sub.push(msg)

    def spin_once(self) -> int:
        """Drain all queues; returns the number of callbacks invoked."""
        n = 0
        for subs in self._subs.values():
            for sub in subs:
                n += sub.drain()
        return n

    def dropped(self, topic: str) -> int:
        return sum(s.dropped for s in self._subs.get(topic, ()))


def publish_odometry_output(pub: Publisher, out, stamp: float,
                            ext_cov: np.ndarray | None = None) -> None:
    """Publish one OdometryOutput as the reference's topic set:
    /laser_odom (pose), /laser_odom_predict (high-rate prediction),
    /extrinsics (status + per-lidar estimates + covariance).

    The output's pose, prediction and extrinsics are concatenated on their
    device and copied to the host once: one wait for the device per
    published sweep, not one per field."""
    parts = (out.pose.t, out.pose.q, out.pose_predict.t, out.pose_predict.q,
             out.extrinsics.q, out.extrinsics.t)
    flat = torch.cat([p.reshape(-1).float() for p in parts]).cpu().numpy()
    sizes = [p.numel() for p in parts]
    t, q, pt, pq, eq, et = np.split(flat, np.cumsum(sizes)[:-1])
    pub.publish("/laser_odom", OdometryMsg(stamp=stamp, frame_id="world", t=t, q=q))
    pub.publish("/laser_odom_predict", OdometryMsg(
        stamp=stamp, frame_id="world", t=pt, q=pq))
    pub.publish("/extrinsics", ExtrinsicsMsg(
        stamp=stamp, status=int(out.ext_mode),
        q=eq.reshape(out.extrinsics.q.shape), t=et.reshape(out.extrinsics.t.shape),
        cov=ext_cov,
    ))
