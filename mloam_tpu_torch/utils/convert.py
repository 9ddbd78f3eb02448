"""State carried across from the JAX package, through numpy.

The system has no learned weights; what both packages share is configuration
and state. Every function here takes the leaves of the JAX package's
container **as numpy arrays** (a caller does
``jax.tree.map(np.asarray, x)``; this package never sees a JAX type) and
returns this package's container on a given device. ``to_numpy`` is the
inverse, for comparisons.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mloam_tpu_torch import config as C
from mloam_tpu_torch.core.rangeimage import LidarModel, RangeImage
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.frontend.features import FeatCloud, FeatureFrame
from mloam_tpu_torch.loop.posegraph import LoopGraphState
from mloam_tpu_torch.loop.scancontext import ScanContextDB
from mloam_tpu_torch.mapping.keyframes import KeyframeDB
from mloam_tpu_torch.mapping.mapper import MapperState, SurroundMap
from mloam_tpu_torch.odometry.estimator import WindowState
from mloam_tpu_torch.odometry.initializer import MotionBuffer
from mloam_tpu_torch.parallel.dd_pgo import DDPartition, MapShard, PointFactors
from mloam_tpu_torch.parallel.sharded_pgo import PoseGraphEdges
from mloam_tpu_torch.solver.bal import BalProblem
from mloam_tpu_torch.sim.world import Trajectory, World
from mloam_tpu_torch.solver.marginalization import QuadPrior


def _t(a, device, dtype=None) -> torch.Tensor:
    """A tensor that owns its memory: a copy, never a view of ``a`` (a JAX
    array's numpy view is read-only, and the port writes some state, such
    as the keyframe ring, in place)."""
    a = np.array(a, order="C")
    if dtype is None:
        dtype = {"f": torch.float32, "i": torch.int32, "u": torch.int32,
                 "b": torch.bool}[a.dtype.kind]
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def config_from_reference(d: dict) -> C.MloamConfig:
    """Rebuild the config tree from ``dataclasses.asdict`` of the JAX
    package's ``MloamConfig``."""
    def build(cls, vals):
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name not in vals:
                continue
            kw[f.name] = vals[f.name]
        return cls(**kw)

    rig = d["rig"]
    models = tuple(
        LidarModel(**m) if isinstance(m, dict) else LidarModel(*m)
        for m in rig["models"])
    sub = {
        "segmenter": C.SegmenterConfig, "features": C.FeatureConfig,
        "tracker": C.TrackerConfig, "odometry": C.OdometryConfig,
        "calib": C.CalibConfig, "mapping": C.MappingConfig,
        "loop": C.LoopConfig,
    }
    return C.MloamConfig(
        rig=C.LidarRig(models=models, extrinsic_mode=rig["extrinsic_mode"]),
        **{k: build(cls, d[k]) for k, cls in sub.items()})


def pose_from_numpy(p, device="cpu") -> Pose:
    q, t = tuple(p)
    return Pose(_t(q, device), _t(t, device))


def featcloud_from_numpy(f, device="cpu") -> FeatCloud:
    xyz, mask, time, ring = tuple(f)
    return FeatCloud(_t(xyz, device), _t(mask, device, torch.bool),
                     _t(time, device), _t(ring, device, torch.int32))


def feature_frame_from_numpy(ff, device="cpu") -> FeatureFrame:
    return FeatureFrame(*(featcloud_from_numpy(f, device) for f in tuple(ff)))


def range_image_from_numpy(img, device="cpu") -> RangeImage:
    xyz, rng, valid, time, inten = tuple(img)
    return RangeImage(_t(xyz, device), _t(rng, device),
                      _t(valid, device, torch.bool), _t(time, device),
                      _t(inten, device))


def window_state_from_numpy(w, device="cpu") -> WindowState:
    """Any mode's window: the prior's size (poses, or poses and extrinsic
    blocks in calibration mode) is taken from the arrays."""
    (poses, corner, surf, ext, count, prior, prior_poses, prior_ext,
     deg_dir, deg_count) = tuple(w)
    H, b, valid = tuple(prior)
    return WindowState(
        poses=pose_from_numpy(poses, device),
        corner=featcloud_from_numpy(corner, device),
        surf=featcloud_from_numpy(surf, device),
        ext=pose_from_numpy(ext, device),
        count=_t(count, device, torch.int32),
        prior=QuadPrior(_t(H, device), _t(b, device),
                        _t(valid, device, torch.bool)),
        prior_poses=pose_from_numpy(prior_poses, device),
        prior_ext=pose_from_numpy(prior_ext, device),
        deg_dir=_t(deg_dir, device, torch.float32),
        deg_count=_t(deg_count, device, torch.int32),
    )


def motion_buffer_from_numpy(buf, device="cpu") -> MotionBuffer:
    ref_q, ref_t, tgt_q, tgt_t, mask, head = tuple(buf)
    return MotionBuffer(_t(ref_q, device), _t(ref_t, device), _t(tgt_q, device),
                        _t(tgt_t, device), _t(mask, device, torch.bool),
                        _t(head, device, torch.int32))


def keyframe_db_from_numpy(db, device="cpu") -> KeyframeDB:
    poses, cov, corner, surf, outlier, valid, head = tuple(db)
    return KeyframeDB(
        poses=pose_from_numpy(poses, device), cov=_t(cov, device),
        corner=featcloud_from_numpy(corner, device),
        surf=featcloud_from_numpy(surf, device),
        outlier=featcloud_from_numpy(outlier, device),
        valid=_t(valid, device, torch.bool), head=_t(head, device, torch.int32))


def mapper_state_from_numpy(st, device="cpu") -> MapperState:
    """The mapper's whole state: keyframe ring, drift correction, extrinsic
    covariance, the cached surround map, the step counter (a host int here)
    and the degeneracy gate's persistence state."""
    (db, pose_map_odom, last_kf_pose, ext_cov, cov_meas, cache, step,
     deg_dir, deg_count) = tuple(st)
    c_xyz, c_mask, s_xyz, s_mask, center, head, valid = tuple(cache)
    return MapperState(
        db=keyframe_db_from_numpy(db, device),
        pose_map_odom=pose_from_numpy(pose_map_odom, device),
        last_kf_pose=pose_from_numpy(last_kf_pose, device),
        ext_cov=_t(ext_cov, device, torch.float32),
        cov_meas=_t(cov_meas, device, torch.float32),
        cache=SurroundMap(_t(c_xyz, device), _t(c_mask, device, torch.bool),
                          _t(s_xyz, device), _t(s_mask, device, torch.bool),
                          _t(center, device), _t(head, device, torch.int32),
                          _t(valid, device, torch.bool)),
        step=int(step),
        deg_dir=_t(deg_dir, device, torch.float32),
        deg_count=_t(deg_count, device, torch.int32))


def scan_context_db_from_numpy(db, device="cpu") -> ScanContextDB:
    desc, ring_key, valid, head = tuple(db)
    return ScanContextDB(_t(desc, device), _t(ring_key, device),
                         _t(valid, device, torch.bool), _t(head, device, torch.int32))


def loop_state_from_numpy(st, device="cpu") -> LoopGraphState:
    """The loop graph's whole state: keyframe poses (corrected and as
    received), clouds, scan-context database and loop edges."""
    (poses, odom_poses, corner, surf, sc_db, valid, count, loop_i, loop_j,
     loop_zq, loop_zt, loop_valid, n_loops) = tuple(st)
    return LoopGraphState(
        poses=pose_from_numpy(poses, device),
        odom_poses=pose_from_numpy(odom_poses, device),
        corner=featcloud_from_numpy(corner, device),
        surf=featcloud_from_numpy(surf, device),
        sc_db=scan_context_db_from_numpy(sc_db, device),
        valid=_t(valid, device, torch.bool), count=_t(count, device, torch.int32),
        loop_i=_t(loop_i, device, torch.int32), loop_j=_t(loop_j, device, torch.int32),
        loop_zq=_t(loop_zq, device), loop_zt=_t(loop_zt, device),
        loop_valid=_t(loop_valid, device, torch.bool),
        n_loops=_t(n_loops, device, torch.int32))


def pose_graph_edges_from_numpy(e, device="cpu") -> PoseGraphEdges:
    """Edge indices as int64 (they index the pose stack)."""
    i, j, z_q, z_t, weight = tuple(e)
    return PoseGraphEdges(_t(i, device, torch.int64), _t(j, device, torch.int64),
                          _t(z_q, device), _t(z_t, device), _t(weight, device))


def point_factors_from_numpy(pf, device="cpu") -> PointFactors:
    return PointFactors(*(_t(x, device, torch.float32) for x in tuple(pf)))


def map_shard_from_numpy(ms, device="cpu") -> MapShard:
    """``valid`` stays a float mask (the JAX package's dtype)."""
    return MapShard(*(_t(x, device, torch.float32) for x in tuple(ms)))


def bal_problem_from_numpy(prob, device="cpu") -> BalProblem:
    """Index arrays as int64 (they index cameras, points, observations)."""
    cams, pts, cam_idx, pt_idx, obs, pair_i, pair_j = tuple(prob)
    i64 = torch.int64
    return BalProblem(_t(cams, device), _t(pts, device), _t(cam_idx, device, i64),
                      _t(pt_idx, device, i64), _t(obs, device),
                      _t(pair_i, device, i64), _t(pair_j, device, i64))


def dd_partition_from_numpy(part) -> DDPartition:
    """A host partition (numpy arrays and ints, as both packages build it)."""
    return DDPartition(*(np.array(x) if isinstance(x, np.ndarray) else x
                         for x in tuple(part)))


def world_from_numpy(w, device="cpu") -> World:
    c, u, v, rm, xyr, z, cm = tuple(w)
    return World(_t(c, device), _t(u, device), _t(v, device),
                 _t(rm, device, torch.bool), _t(xyr, device), _t(z, device),
                 _t(cm, device, torch.bool))


def trajectory_from_numpy(tr, device="cpu") -> Trajectory:
    amp, freq, phase, yaw_rate, wobble = tuple(tr)
    return Trajectory(_t(amp, device), _t(freq, device), _t(phase, device),
                      float(yaw_rate), float(wobble))


def to_numpy(x):
    """Tensors -> numpy arrays through any nest of (named) tuples, lists and
    dicts; everything else is returned as it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    return x
