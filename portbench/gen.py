"""Traffic generator of the benchmark: every input a cell feeds the program
and the reference, made from ``--seed`` alone.

``drive_graph`` builds the keyframe pose graph of one drive that revisits
its start, as M-LOAM's loop module holds it (``mloam_loop/src/
pose_graph.cpp``): one pose a keyframe, sequential edges from each keyframe
to its ``neighbors`` predecessors measured from the odometry (lines
555-569), and loop edges from the revisit to the first pass (lines
572-597), measured by registration. Sizes and noise come from the
configuration file; the layout of the drive is fixed by it, only the noise
is drawn from the seed, so every seed gives the same work.

The drive: ``n_poses - n_loops * loop_every`` keyframes ``step_m`` apart on
one closed turn, then ``n_loops * loop_every`` more that drive its start
again. Loop detection runs every ``loop_every``-th keyframe of the revisit
and closes on a keyframe up to ``loop_offset_max`` places from the one at
the same spot (a detector finds a near keyframe, not the same place).

The odometry is the truth with a random walk of step errors (``odom_sigma_t``
metres, ``odom_sigma_r`` radians a step); a loop edge is the true relative
pose with a registration error (``loop_sigma_*``). Everything is worked in
float64 with numpy and handed out as float32, the program's precision; the
reference reads the same float32 values.

Nothing here imports the program under test. Each draw comes from a
generator seeded by ``sub_seed(seed, ...)``, a 64-bit mix of the cell's seed
and the draw's purpose, so the same seed gives the same inputs, and any seed
(negative, or wider than 32 bits) is taken as it is.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for the draw ``path`` of the cell seed ``seed``."""
    words = [int(seed) % (1 << 64)] + [int(p) % (1 << 64) for p in path]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def rng(seed: int, *path: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *path))


def _hat(v: np.ndarray) -> np.ndarray:
    z = np.zeros(v.shape[:-1])
    return np.stack([np.stack([z, -v[..., 2], v[..., 1]], -1),
                     np.stack([v[..., 2], z, -v[..., 0]], -1),
                     np.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def so3_exp(phi: np.ndarray) -> np.ndarray:
    """Rotation matrices [..., 3, 3] of rotation vectors [..., 3]."""
    th = np.linalg.norm(phi, axis=-1)[..., None, None]
    K = _hat(phi)
    small = th < 1e-8
    a = np.where(small, 1.0, np.sin(th) / np.where(small, 1.0, th))
    b = np.where(small, 0.5, (1.0 - np.cos(th)) / np.where(small, 1.0, th * th))
    return np.eye(3) + a * K + b * (K @ K)


def matrix_to_quat(R: np.ndarray) -> np.ndarray:
    """[..., 4] (w, x, y, z) unit quaternions, w >= 0, of rotation matrices
    (Shepperd's method: the largest of the four squares is taken first)."""
    R = np.asarray(R, dtype=np.float64)
    tr = np.trace(R, axis1=-2, axis2=-1)
    d = np.stack([tr, R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    k = np.argmax(d, axis=-1)
    q = np.empty(R.shape[:-2] + (4,))
    for c in range(4):
        m = k == c
        if not m.any():
            continue
        r = R[m]
        if c == 0:
            s = 2.0 * np.sqrt(1.0 + tr[m])
            q[m] = np.stack([0.25 * s, (r[:, 2, 1] - r[:, 1, 2]) / s,
                             (r[:, 0, 2] - r[:, 2, 0]) / s, (r[:, 1, 0] - r[:, 0, 1]) / s], -1)
        else:
            i, j, l = c - 1, c % 3, (c + 1) % 3
            s = 2.0 * np.sqrt(1.0 + r[:, i, i] - r[:, j, j] - r[:, l, l])
            v = np.empty((r.shape[0], 4))
            v[:, 0] = (r[:, l, j] - r[:, j, l]) / s
            v[:, 1 + i] = 0.25 * s
            v[:, 1 + j] = (r[:, j, i] + r[:, i, j]) / s
            v[:, 1 + l] = (r[:, l, i] + r[:, i, l]) / s
            q[m] = v
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return np.where(q[..., :1] < 0, -q, q)


class DriveGraph(NamedTuple):
    """The inputs of one cell, float32 where the program reads them."""

    start_q: np.ndarray   # [n, 4] odometry poses (w, x, y, z): the first solve's start
    start_t: np.ndarray   # [n, 3]
    i: np.ndarray         # [E] int64 edge source
    j: np.ndarray         # [E] int64 edge target, measurement Z = T_i^-1 T_j
    z_q: np.ndarray       # [E, 4]
    z_t: np.ndarray       # [E, 3]
    weight: np.ndarray    # [E] sqrt-weight of a live edge
    loop: np.ndarray      # [E] int64: the loop's order of closing, -1 for a sequential edge
    gt_R: np.ndarray      # [n, 3, 3] float64 truth
    gt_t: np.ndarray      # [n, 3]


def drive_layout(conf: dict) -> tuple[int, np.ndarray, np.ndarray]:
    """(keyframes on the first pass, loop query keyframes, loop candidates):
    fixed by the configuration alone."""
    n, m, every = int(conf["n_poses"]), int(conf["n_loops"]), int(conf["loop_every"])
    lap = n - m * every
    if lap < 2 * every or m < 1:
        raise ValueError(f"a drive of {n} keyframes holds no {m} loops {every} apart")
    off_max = int(conf["loop_offset_max"])
    k = np.arange(m)
    query = lap + k * every
    offset = (k * 5) % (2 * off_max + 1) - off_max
    cand = np.clip(query - lap + offset, 0, lap - 1)
    return lap, query, cand


def drive_graph(conf: dict, seed: int) -> DriveGraph:
    n = int(conf["n_poses"])
    lap, query, cand = drive_layout(conf)
    step = float(conf["step_m"])
    # the truth: the k-th keyframe at angle 2 pi (k mod lap) / lap on a circle
    # of circumference lap * step, heading along it
    th = 2.0 * math.pi * (np.arange(n) % lap) / lap
    r = lap * step / (2.0 * math.pi)
    gt_t = np.stack([r * np.sin(th), r * (1.0 - np.cos(th)), np.zeros(n)], -1)
    gt_R = so3_exp(np.stack([np.zeros(n), np.zeros(n), th], -1))

    # the odometry: true steps with a random walk of errors
    g = rng(seed, 1)
    rel_R = np.einsum("kba,kbc->kac", gt_R[:-1], gt_R[1:])
    rel_t = np.einsum("kba,kb->ka", gt_R[:-1], gt_t[1:] - gt_t[:-1])
    e_t = g.normal(0.0, float(conf["odom_sigma_t"]), (n - 1, 3))
    e_r = g.normal(0.0, float(conf["odom_sigma_r"]), (n - 1, 3))
    meas_R = rel_R @ so3_exp(e_r)
    meas_t = rel_t + e_t
    od_R = np.empty((n, 3, 3))
    od_t = np.empty((n, 3))
    od_R[0], od_t[0] = gt_R[0], gt_t[0]
    for k in range(1, n):
        od_t[k] = od_t[k - 1] + od_R[k - 1] @ meas_t[k - 1]
        od_R[k] = od_R[k - 1] @ meas_R[k - 1]

    def relative(Ra, ta, Rb, tb):
        return (np.einsum("kba,kbc->kac", Ra, Rb),
                np.einsum("kba,kb->ka", Ra, tb - ta))

    ii, jj = [], []
    for s in range(1, int(conf["neighbors"]) + 1):
        ii.append(np.arange(0, n - s))
        jj.append(np.arange(s, n))
    si, sj = np.concatenate(ii), np.concatenate(jj)
    sz_R, sz_t = relative(od_R[si], od_t[si], od_R[sj], od_t[sj])

    gl = rng(seed, 2)
    lz_R, lz_t = relative(gt_R[cand], gt_t[cand], gt_R[query], gt_t[query])
    lz_R = lz_R @ so3_exp(gl.normal(0.0, float(conf["loop_sigma_r"]), (len(query), 3)))
    lz_t = lz_t + gl.normal(0.0, float(conf["loop_sigma_t"]), (len(query), 3))

    f32 = np.float32
    return DriveGraph(
        start_q=matrix_to_quat(od_R).astype(f32), start_t=od_t.astype(f32),
        i=np.concatenate([si, cand]).astype(np.int64),
        j=np.concatenate([sj, query]).astype(np.int64),
        z_q=matrix_to_quat(np.concatenate([sz_R, lz_R])).astype(f32),
        z_t=np.concatenate([sz_t, lz_t]).astype(f32),
        weight=np.concatenate([np.full(len(si), float(conf["seq_weight"])),
                               np.full(len(query), float(conf["loop_weight"]))]).astype(f32),
        loop=np.concatenate([np.full(len(si), -1), np.arange(len(query))]).astype(np.int64),
        gt_R=gt_R, gt_t=gt_t)
