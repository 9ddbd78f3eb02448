"""Checkpoint / resume: snapshots of the whole pipeline state.

Counterpart of ``mloam_tpu/utils/checkpoint.py``, with the same file format:
one compressed ``.npz`` whose keys are the ``/``-joined paths of the state's
NamedTuple fields (a ``None`` leaf saved as ``<path>/__none__``) plus a JSON
``__meta__`` of the host counters. Every state NamedTuple has the same fields
in both packages, so a file either package writes loads into the other's
pipeline of the same configuration.

Each leaf comes back in its template's kind: a tensor on the template's
device and in its dtype (the port keeps int64 where the JAX package keeps
int32), a host int as an int (``MapperState.step`` is a host counter in the
port, a device scalar in the JAX package). A field the file lacks raises
``KeyError``, as in the JAX package.

The reference persists only the loop pose graph and the final maps
(``pose_graph.cpp:655-770``, ``lidar_mapper_keyframe.cpp:853-919``); the
JAX package snapshots the window, the mapper's keyframe ring, the loop graph,
the calibration buffers and the host counters, and so does the port. It does
not save the previous sweep's features, the calibration pair accumulators,
samples or covariance: a restored pipeline re-enters through the first-sweep
branch (it pushes its next sweep into the window and tracks from there), as
the JAX package's does.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch


def _flatten(prefix: str, tree: Any, out: dict):
    if hasattr(tree, "_fields"):  # NamedTuple
        for name in tree._fields:
            _flatten(f"{prefix}{name}/", getattr(tree, name), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(f"{prefix}{i}/", v, out)
    elif tree is None:
        out[prefix + "__none__"] = np.zeros(0)
    elif isinstance(tree, torch.Tensor):
        out[prefix.rstrip("/")] = tree.detach().cpu().numpy()
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)


def _unflatten(prefix: str, template: Any, data: dict):
    if hasattr(template, "_fields"):
        return type(template)(**{
            name: _unflatten(f"{prefix}{name}/", getattr(template, name), data)
            for name in template._fields})
    if isinstance(template, (list, tuple)):
        seq = [_unflatten(f"{prefix}{i}/", v, data) for i, v in enumerate(template)]
        return seq if isinstance(template, list) else tuple(seq)
    if template is None:
        return None
    arr = data[prefix.rstrip("/")]
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=template.device, dtype=template.dtype)
    if isinstance(template, bool):
        return bool(arr)
    if isinstance(template, int):
        return int(arr)
    if isinstance(template, float):
        return float(arr)
    return arr


def _copy_to_host(tree: Any) -> Any:
    """Every device tensor of ``tree`` copied to the host: the leaves are
    queued as asynchronous copies into pinned memory and waited for once,
    so a GPU state costs one wait, not one per leaf."""
    leaves: list = []

    def walk(t):
        if hasattr(t, "_fields"):
            return type(t)(*(walk(x) for x in t))
        if isinstance(t, (list, tuple)):
            return type(t)(walk(x) for x in t)
        if isinstance(t, torch.Tensor) and t.is_cuda:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            leaves.append(h)
            return h
        return t

    host = walk(tree)
    if leaves:
        torch.cuda.synchronize()
    return host


def save_state(path: str, tree: Any, meta: dict | None = None):
    """Save a tree of NamedTuples / tuples / lists of tensors (plus an
    optional JSON-serializable meta dict)."""
    out: dict = {}
    _flatten("", _copy_to_host(tree), out)
    if meta is not None:
        out["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **out)


def load_state(path: str, template: Any):
    """Restore a tree saved by ``save_state`` into the kinds, devices and
    dtypes of ``template``. Returns (tree, meta)."""
    with np.load(path, allow_pickle=False) as z:
        data = dict(z)
    meta = None
    if "__meta__" in data:
        meta = json.loads(bytes(data.pop("__meta__")).decode())
    return _unflatten("", template, data), meta


def _parts(pipe):
    """(state tree, meta, pipeline kind) of a pipeline, in the JAX package's
    layout."""
    from mloam_tpu_torch.models.pipeline import (FullPipeline, OdometryPipeline,
                                                 SlamPipeline)

    if isinstance(pipe, SlamPipeline):
        o = pipe.full.odom
        tree = (o.window, pipe.full.mapper_state, pipe.loop_state,
                tuple(o.calib_buffers), tuple(o.motions), o.world_pose)
        meta = {"kind": "slam", "frame_idx": o.frame_idx, "ext_mode": o.ext_mode,
                "kf_counter": pipe.kf_counter, "n_loops": pipe.n_loops,
                "loop_kf_count": pipe.loop_kf_count}
    elif isinstance(pipe, FullPipeline):
        o = pipe.odom
        tree = (o.window, pipe.mapper_state, tuple(o.calib_buffers),
                tuple(o.motions), o.world_pose)
        meta = {"kind": "full", "frame_idx": o.frame_idx, "ext_mode": o.ext_mode}
    elif isinstance(pipe, OdometryPipeline):
        tree = (pipe.window, tuple(pipe.calib_buffers), tuple(pipe.motions),
                pipe.world_pose)
        meta = {"kind": "odom", "frame_idx": pipe.frame_idx, "ext_mode": pipe.ext_mode}
    else:
        raise TypeError(type(pipe))
    return tree, meta


def save_pipeline(path: str, pipe) -> None:
    """Snapshot an OdometryPipeline / FullPipeline / SlamPipeline."""
    from mloam_tpu_torch.models.pipeline import SlamPipeline

    if isinstance(pipe, SlamPipeline):
        # drain the one-sweep-delayed keyframe and verification stages BEFORE
        # capturing: flush() rebinds pipe.loop_state and the counters, so a
        # capture first would save a loop graph whose keyframe count lags the
        # meta counters
        pipe.flush()
    tree, meta = _parts(pipe)
    save_state(path, tree, meta)


def load_pipeline(path: str, pipe) -> None:
    """Restore a snapshot into a freshly constructed pipeline of the same
    configuration."""
    from mloam_tpu_torch.models.pipeline import FullPipeline, SlamPipeline

    template, _ = _parts(pipe)
    tree, meta = load_state(path, template)
    if isinstance(pipe, SlamPipeline):
        odom = pipe.full.odom
        (odom.window, pipe.full.mapper_state, pipe.loop_state, bufs, motions,
         odom.world_pose) = tree
        pipe.kf_counter = meta["kf_counter"]
        pipe.n_loops = meta["n_loops"]
        # snapshots older than the host count mirror: recover it from the
        # restored graph (one read)
        pipe.loop_kf_count = meta.get("loop_kf_count", int(pipe.loop_state.count))
    elif isinstance(pipe, FullPipeline):
        odom = pipe.odom
        (odom.window, pipe.mapper_state, bufs, motions, odom.world_pose) = tree
    else:
        odom = pipe
        odom.window, bufs, motions, odom.world_pose = tree
    odom.calib_buffers = list(bufs)
    odom.motions = list(motions)
    odom.frame_idx = meta["frame_idx"]
    odom.ext_mode = meta["ext_mode"]
