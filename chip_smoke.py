#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``mloam_tpu_torch/csrc`` with nvcc
and reports what ``ptxas -v`` says of each (registers, shared memory, spills:
a spill in a k-NN instantiation fails the run), holds each kernel against its
plain PyTorch version on the card (label propagation: integer-exact; k-NN:
distances to 1e-5 relative, indices equal wherever neighbouring distances are
further apart than that, and equal at every slot on a grid built to tie),
times them at the shapes the main path gives them (the band Cholesky K3,
``csrc/band_chol.cu``: at the benchmark's KITTI 00 drive layout and the
600-pose ring, against cuSOLVER's dense factor of the same band and against
float64, two calls to the bit, a band that is not positive definite giving
info and a NaN step; ``ms``: CUDA events
around 20 back-to-back eager calls, as the first slice timed them;
``graph_ms``: the same calls captured in one CUDA graph and replayed, which
leaves out the host's cost of issuing them), then drives four paths, each
with the kernels' launch counters (every kernel launch counted where it is
made) set to 0 just before it and checked just after against the count its
sweeps must make:

- the main path: single-LiDAR odometry, rendered sweep to refined pose, 24
  sweeps at the full width of the synthetic VLP-16 platform, ATE < 5 cm;
  the stage timers wait for the device nowhere (the synchronising branch
  counted every sweep: only the per-sweep timer's two waits), and with
  ``sync_timing`` switched on for the last two sweeps once at each stage's
  entry and exit;
- the rig path: a dual VLP-16 rig with known extrinsics (ESTIMATE_EXTRINSIC
  0), 24 sweeps, ATE < 5 cm;
- the calibration path: the same rig from fully unknown extrinsics, 58
  sweeps of rotation-rich motion through the lifecycle 2 -> 1 -> 0, which must
  complete with a final extrinsic error under 5 mrad and 2 cm;
- the presets: 8 sweeps each of Oxford (2x HDL-32, 32x2160), KITTI (HDL-64,
  64x1800) and the Hercules vehicle (4x VLP-16, ESTIMATE_EXTRINSIC 1 as
  shipped), finite poses;
- the batch frontend path: the steady step of a uniform rig runs one
  batched frontend (label propagation once for the rig; every rig above and
  below with one sensor model launches it so, and L times a sweep until the
  window is full); it is held against the unrolled frontends (one per
  lidar, what a mixed rig runs) on the dual rig (the rig path's 24 sweeps,
  ATE < 5 cm), the Hercules rig in mode 0 with its extrinsics installed (10
  sweeps, batched and unrolled) and Oxford (the preset's 8): poses within
  1e-5 m, k-NN launches alike, every frontend output of one sweep compared
  tensor by tensor; each batched label call's inputs held against the plain
  version at every slot, with a random batch, and timed beside the batch's
  images as single calls;
- the map path: ``FullPipeline`` (odometry + uncertainty-aware keyframe
  mapping, the default ``MappingConfig``) on the single VLP-16, 24 sweeps,
  map-frame and odometry ATE < 5 cm, at least 2 keyframes, positive
  semi-definite keyframe covariances, a finite non-empty outlier channel,
  one staleness read per mapped sweep;
- the map rig path: the dual rig with known extrinsics and a prior
  extrinsic covariance (the lidars' point covariances differ), 14 sweeps,
  map-frame ATE < 5 cm;
- the tuned path: the realtime operating point (``realtime_tuned``: window
  good-feature compaction, fewer iterations, tuned caps) on the single
  VLP-16, 24 sweeps, and on the dual rig, 14 sweeps, ATE < 5 cm each;
- the slam path: ``SlamPipeline`` (odometry + mapping + loop closure with
  the FFT correlation seed) on the floor course of the JAX package's
  ``tests/test_slam_e2e.py``, 110 sweeps: at least one loop, every loop
  edge spanning at least 8 keyframes, the corrected keyframe ATE at most
  1.10x the odometry's, per-sweep map ATE < 25 cm, the correlation
  registration run, 12 k-NN launches per submitted detection, and the
  host's waits for the device (CUDA's sync debug mode over every sweep)
  only at the mapper's staleness read, ``eigh`` and a verified loop's
  correction read and optimization, besides the pipelined flags' events;
- the slam drift path: the JAX package's ``bench.py`` slam pass (the tuned
  operating point, a 15 m surround map, range noise 0.03 m, 100 sweeps):
  loops, keyframe ATE before and after the optimization and keyframe-sweep
  times recorded, gated on finite outputs, the counters and the sync probe;
- the corridor path: the degenerate tunnel of the JAX package's
  ``tests/test_degeneracy_e2e.py`` (``indoor_degenerate``, the tracker
  skipped on the steady path, 90 sweeps, range noise 0.01 m, a companion
  riding with the vehicle in bursts), once with the window's remap armed and
  once disarmed: engaged on >= 90 % of the in-tunnel sweeps, the along-x
  error under half the disarmed run's, y / z bounded, the armed run's |ez|
  within the measured spread of the JAX package's on the same rendering
  (whether |ex| and |ez| pass 0.8 m is recorded: the JAX package misses
  that on part of its own noise draws), and the armed run's host waits
  probed (only ``eigh``);
- the robust path: the JAX package's ``tests/test_robust_e2e.py`` on the
  port's world, range noise 0.02 m: with three movers (28 sweeps) gm beats
  huber by 5 % and gnc_gm beats huber; without (12 sweeps) gnc_gm is no
  more than 15 % worse;
- the silence of the window's (and on the slam floor course the mapper's)
  remap on observed scenes: no direction frozen on the main path and the
  floor course;
- a repeat check: the map path's first 16 sweeps run twice in one process from
  the same images give equal poses to the bit, and the voxel filters and
  the pose-graph solve give equal outputs over 20 calls on captured inputs;
  the order-independent segment sums are timed against ``index_add_`` on
  the inputs a sweep gives them;
- a pose-graph ladder: ``optimize_pose_graph`` on ring graphs of 256 to 4096
  poses by conjugate gradients and by the direct solve (on the band where
  the ring's order allows, the counts of band and dense steps reported, as
  on the slam paths), timed and compared, the direct solve's peak device
  memory recorded
  (``mloam_tpu_torch.utils.pgo_ladder`` runs larger rings alone).
- the ingest path: rendered sweeps written as KITTI ``.bin`` files (four
  also as binary PCD) are read back exactly by the port's C++ dataset
  reader, whose packed prefetch ring grids each to exactly the wire arrays
  of ``project`` + ``pack_frame``; VLP-16 packets of 12 sweeps decode to
  their direct packing and drive ``FullPipeline`` (map ATE < 5 cm); 8
  ``.bin`` files through ``convert_kitti_sequence`` and ``project`` drive
  ``OdometryPipeline`` (ATE < 6 cm, each output published); a live 10 Hz
  stream of 40 sweeps goes through the realtime gate into ``FullPipeline``
  (the admitted share, ms per admitted sweep and ATE recorded);
- the resume path: ``FullPipeline`` after 9 sweeps and ``SlamPipeline`` on a
  small loop course after 12 (a keyframe in flight) are saved and loaded
  into fresh pipelines: state equal to the bit, the loop graph's keyframe
  count kept, the next sweep on the first-sweep branch and finite; file
  sizes and save / load seconds recorded;
- the experiments path: the programs ``single`` (12 sweeps), ``mc`` (one
  trial of 12 sweeps in each of its four cells) and ``inject_ext`` (levels
  gt and inj, 8 sweeps of the dual rig) at full width, ATE < 5 cm (inject
  at gt), written (TUM, JSON, PCD and the plots' inputs);
- the parallel path (the distributed solvers on stacked meshes, no kernel
  launched): the ``scaling`` program at 1024 poses (the nested-dissection
  solve on 8, 2x4 and 2x8 shards within 1 cm of the dense steps and no
  worse than them + 5 mm; the edge-sharded PCG; ``dof4`` on 2x4), the
  edge-sharded ``optimize_pose_graph`` on the 600-pose ring (dense and PCG,
  within 1 mm of one device, repeated to the bit), the distributed BA at
  1024 poses x 1024 points x 4096 candidate planes (layouts agree to
  0.1 mm, the error falls), the scaling report (the JAX report's four rows:
  partition, input bytes and collective bytes by fabric equal to its
  record's, efficiencies from the card's shard ms over an HGX H100 node's
  published fabric figures, finite and in (0, 1]), the sharded surround map
  of a filled 512-slot ring (the one-device point set and covariances), the
  real-data programs over files written from seeds in the reference's
  formats (BAL at the reference file's shape, 25 LM iterations, trivial and
  huber, at the JAX tests' ratios, the 8-shard assembly; the curve and
  quintic fits), one NCCL rank equal to the stacked mesh, and the DD solve
  at 4096 poses beside the ladder's.

The k-NN calls of the corridor path's first steady sweep (its window's
two: the tracker is skipped) and its label-propagation call, the k-NN calls
of the dual rig's window solve, of the calibration path's
first warm sweeps in modes 2 and 1, of the mapper's first match against a
rebuilt surround map (both mapping paths) and of the slam path's first loop
detection (its two fine registrations: 12 calls), and the label propagation
calls of the presets, of the tuned path and of a sweep decoded from packets
are captured from those paths and held against the plain versions too.

One JSON object per line; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed phase ends the script with a non-zero exit code and no such line.
Needs one CUDA device and nvcc; no network.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import datetime
import faulthandler
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device is available", file=sys.stderr)
    sys.exit(1)

# a fatal signal in native code (a kernel's host side, the dataset reader's
# threads) prints every thread's Python stack instead of dying silently
faulthandler.enable(all_threads=True)

import numpy as np  # noqa: E402

import mloam_tpu_torch  # noqa: E402
from mloam_tpu_torch import config as C  # noqa: E402
from mloam_tpu_torch.core import rangeimage as RI  # noqa: E402
from mloam_tpu_torch.core import se3, uncertainty  # noqa: E402
from mloam_tpu_torch.core.rangeimage import LidarModel, RangeImage  # noqa: E402
from mloam_tpu_torch.core.se3 import Pose  # noqa: E402
from mloam_tpu_torch.frontend import segmentation as S  # noqa: E402
from mloam_tpu_torch.models import platforms, run_synthetic  # noqa: E402
from mloam_tpu_torch.loop import global_registration as GREG  # noqa: E402
from mloam_tpu_torch.loop import posegraph as PGraph  # noqa: E402
from mloam_tpu_torch.mapping import mapper as MP  # noqa: E402
from mloam_tpu_torch.models import experiments as EXP  # noqa: E402
from mloam_tpu_torch.models import pipeline as PIPE  # noqa: E402
from mloam_tpu_torch.models.pipeline import FullPipeline, OdometryPipeline  # noqa: E402
from mloam_tpu_torch.mapping import keyframes as KF  # noqa: E402
from mloam_tpu_torch.models import realdata as RD  # noqa: E402
from mloam_tpu_torch.parallel import dd_pgo as DD  # noqa: E402
from mloam_tpu_torch.parallel import mesh as MESH  # noqa: E402
from mloam_tpu_torch.parallel import scaling_model as SM  # noqa: E402
from mloam_tpu_torch.parallel import sharded_map as SMAP  # noqa: E402
from mloam_tpu_torch.parallel import sharded_pgo as PG  # noqa: E402
from mloam_tpu_torch.solver import bal as BAL  # noqa: E402
from mloam_tpu_torch.ops import _build, hopper_knn, hopper_labels  # noqa: E402
from mloam_tpu_torch.ops import hopper_band_chol as BC  # noqa: E402
from mloam_tpu_torch.ops import knn as knn_ops  # noqa: E402
from mloam_tpu_torch.ops import segsum, voxel  # noqa: E402
from mloam_tpu_torch.sim import world as W  # noqa: E402
from mloam_tpu_torch.utils import evaluation, timing  # noqa: E402
from mloam_tpu_torch.utils import checkpoint as CK  # noqa: E402
from mloam_tpu_torch.utils import dataio, viz  # noqa: E402
from mloam_tpu_torch.utils import pgo_ladder as LADDER  # noqa: E402
from mloam_tpu_torch.utils.publisher import Publisher, publish_odometry_output  # noqa: E402
from mloam_tpu_torch.utils.realtime import RealtimeGate, gated  # noqa: E402

DEV = torch.device("cuda")
SMS = torch.cuda.get_device_properties(0).multi_processor_count
# the earlier paths' depths, cut as far as their gates allow so that the
# script keeps to its time with the slam, corridor and robust paths (main and
# rig 40, calibration 90, map 40, map rig 20, tuned 40, tuned rig 20 sweeps
# before)
N_FRAMES = 24
SYNC_TIMING_SWEEPS = 2      # the main path's last sweeps, stage timers waiting
ATE_GATE_M = 0.05
KNN_RTOL = 1e-5
CALIB_FRAMES = 58          # the lifecycle freezes at 54 (cut from 64)
CALIB_ROT_GATE_RAD = 5e-3
CALIB_POS_GATE_M = 0.02
PRESET_FRAMES = 8
BATCH_HERCULES_FRAMES = 10  # the four-lidar rig, unrolled and batched
BATCH_POSE_GATE_M = 1e-5    # tests/test_odometry_e2e.py:131
MAP_FRAMES = 24
MAP_RIG_FRAMES = 14
TUNED_FRAMES = 24
TUNED_RIG_FRAMES = 14
# the loop courses' gates (courses: run_synthetic.LOOP_COURSES)
SLAM_MAP_ATE_GATE_M = 0.25
SLAM_KF_ATE_RATIO = 1.10
SLAM_MIN_LOOP_SPAN = 8
DRIFT_WARM = 40          # bench.py's warm-up before sweep times count
DRIFT_FRAMES = 100       # the drift course cut from its 130 sweeps
DRIFT_PROBE_FROM = 80    # sweeps probed for host waits (their times are kept apart)
PGO_POSES = 600
PGO_GATE_M = 1e-3
# ring graphs timed dense against PCG for the ``auto`` rule
PGO_LADDER = (256, 512, 1024, 2048, 4096)
# the corridor course (tests/test_degeneracy_e2e.py:55-104) and its gates
CORRIDOR_FRAMES = 90
CORRIDOR_COMP_START = 15
CORRIDOR_ENGAGED_SHARE = 0.9
# the armed run's sweeps from here on run under the sync probe (the z -> x
# handover, disengaged sweeps and the re-engaged x freeze)
CORRIDOR_PROBE_FROM = 30
# the armed run's |ez| envelope of the JAX package on this very course (the
# port's rendering of it, run by the JAX package on the CPU:
# tests/torch_corridor_witness.py free jax port 1000; its ex_on / ex_off
# there is 0.40, under the half gated for both), and the largest excess of
# the port's |ez| over the JAX package's on a shared rendering in 16 pairs,
# both packages on the CPU (PERF.md, Findings): the armed |ez| must stay
# within it. The absolute 0.8 m envelopes of tests/test_degeneracy_e2e.py
# hold for the JAX package itself on only part of its noise draws
# (|ex| 7 of 16, |ez| 7 of 16), so they are recorded
JAX_CORRIDOR_EZ_ON_M = 0.7555999755859375
CORRIDOR_EZ_MARGIN_M = 0.26
# the robust-loss course (tests/test_robust_e2e.py:25-92): three movers
ROBUST_FRAMES = 28          # cut from 50 / 24 for the whole script's time,
ROBUST_CLEAN_FRAMES = 12    # every gate kept
ROBUST_MOVERS = ([[5.0, 2.0, 0.6], [-3.0, 6.0, 0.6], [7.0, -4.0, 0.5]],
                 [[0.0, 2.5]] * 3,
                 [[-1.2, -0.5], [0.8, -1.4], [-0.6, 1.3]])
# calls of each captured voxel filter and of the PGO solve in the repeat check
REPEAT_CALLS = 20
REPEAT_FRAMES = 16          # the map path run twice (cut from 24)
# the dual rig's prior extrinsic covariance on the map rig path ([rho; phi]
# diagonal: 1 cm and 3 mrad standard deviations)
# the deployment layer (ingest_path, resume_path, experiments_path)
INGEST_FRAMES = 12          # packets -> FullPipeline (tests/test_ingest_e2e.py:36-66)
INGEST_BIN_FRAMES = 8       # .bin -> shard -> OdometryPipeline (:69-105)
INGEST_BIN_ATE_GATE_M = 0.06
INGEST_PCD_FILES = 4
INGEST_CAP = 40_000         # the shard's points per sweep (:88)
GATED_FRAMES = 40           # a live 10 Hz stream through the realtime gate
GATED_MAX_LAG_S = 0.2
RESUME_FRAMES = 9           # tests/test_checkpoint.py:18-45
RESUME_SLAM_FRAMES = 12     # tests/test_checkpoint.py:58-100
EXP_FRAMES = 12             # experiments single, and mc's four cells
EXP_INJECT_FRAMES = 8       # experiments inject_ext on the dual rig
MAP_RIG_EXT_COV = (1e-4, 1e-4, 1e-4, 1e-5, 1e-5, 1e-5)
# the distributed slice (parallel_path): the JAX scaling program's graph,
# the deployment shape of its distributed BA (scaling_model.py:294-296),
# the reference BAL file's shape
DD_POSES = 1024
DD_GATE_M = 1e-2            # experiments.scaling_test: deviation from dense
DD_ERR_MARGIN_M = 5e-3      # ... and no worse than dense + 5 mm
MESH_SHARDS = 8
MESH_PGO_CALLS = 3
BA_POINTS, BA_MAP, BA_ITERS, BA_ASSOC_CHUNK = 1024, 4096, 3, 32
BA_LAYOUT_GATE_M = 1e-4     # tests/test_dd_pgo.py:130-186
SURROUND_GATE_M = 1e-4
BAL_SHAPE = (49, 7776, 31843)
BAL_ITERS = 25
BAL_TRIVIAL_RATIO = 60.0    # tests/test_realdata.py:75-84: 60x in 10 iterations
BAL_HUBER_RATIO = 0.1       # :86-89: under 0.1x in 5 iterations
BAL_SHARDED_RTOL = 1e-6
DD_LARGE_POSES, DD_LARGE_ITERS = 4096, 3
NCCL_TIMEOUT_S = 60
# the JAX package's scaling report (results/scaling/summary.json, "model"):
# partition (interiors a shard, intra separators a host, global separators,
# owned separators a shard), input bytes a shard, collective bytes a GN
# iteration within a node and across nodes; counts of the program, not rates
SCALING_RECORD = {
    "intra_8gpu_ba": ((121, 0, 81, 11), 17328336, 973252, 0),      # ici_8chip_ba
    "inter_2node_ba": ((123, 49, 39, 9), 17328232, 1119360, 319204),  # dcn_2host_ba
    "intra_8gpu_pgo": ((121, 0, 81, 11), 26832, 973252, 0),        # ici_8chip_pgo
    "inter_2node_pgo": ((123, 49, 39, 9), 26728, 1119360, 319204),   # dcn_2host_pgo
}
# what the JAX package's `experiments calib` program recorded for the same
# lifecycle (results/calib/summary.json): its world is drawn by another
# generator, so the sweeps of the transitions are set beside, not compared
JAX_CALIB_RECORD = {"init_done": 30, "frozen": 54,
                    "final_rot_err_rad": 0.00142999819945544,
                    "final_pos_err_m": 0.004379465244710445}


def _rig(*tangents):
    """Extrinsics [L] (base <- lidar): lidar 0 at the base, lidar l at
    exp(tangents[l-1]) ([rho, phi])."""
    xi = torch.tensor([[0.0] * 6] + [list(t) for t in tangents])
    return se3.exp(xi)


# the JAX e2e test's dual rig (30 deg of yaw, 38 cm off)
RIG_X = Pose(torch.tensor([[1.0, 0, 0, 0], [0.9659258, 0.0, 0.0, 0.258819]]),
             torch.tensor([[0.0, 0, 0], [0.3, -0.2, 0.1]]))
# the extrinsic of the JAX package's calibration program, and its Hercules
# rig's three
CALIB_X = _rig([0.25, -0.1, 0.05, 0.05, -0.03, 0.5])
HERCULES_X = _rig([0.25, -0.1, 0.05, 0.05, -0.03, 0.5],
                  [-0.2, 0.15, -0.05, -0.04, 0.06, -0.4],
                  [0.1, 0.3, 0.02, 0.03, -0.05, 1.0])

# H100 SXM data-sheet peaks the bounds are stated against
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
KNN_FLOPS_PER_PAIR = 8      # 3 sub, 3 mul, 2 add
LABEL_OPS_PER_CELL_ROUND = 6  # 3 segmented mins, a compare and a min each


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps=20, warm=3):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps=20):
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed, so the launches run back to back and the host's cost
    of issuing them is not in the time."""
    fn()  # first use: build, load and set kernel attributes outside the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# --------------------------------------------------------------------------
# env + build
# --------------------------------------------------------------------------

def phase_env():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    emit({"env": {
        "nvidia_smi": smi,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvcc": nvcc.strip().splitlines()[-2:],
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
    }})
    return smi


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")
_KERNEL_NAME = re.compile(r"(knn_kernel|label_kernel)(?:ILi(\d+)EE)?")


def parse_ptxas(log):
    """{kernel: {registers, smem_bytes, stack_bytes, spill_stores, spill_loads}}
    from ``ptxas -v`` output."""
    out, cur = {}, None
    for line in log.splitlines():
        if m := _PTXAS_ENTRY.search(line):
            k = _KERNEL_NAME.search(m.group(1))
            cur = (f"{k.group(1)}<{k.group(2)}>" if k and k.group(2) else
                   k.group(1) if k else m.group(1))
            out[cur] = {}
        elif cur and (m := _PTXAS_SPILL.search(line)):
            out[cur].update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        elif cur and (m := _PTXAS_REGS.search(line)):
            sm = _PTXAS_SMEM.search(line)
            out[cur].update(registers=int(m.group(1)),
                            smem_bytes=int(sm.group(1)) if sm else 0)
    return out


def phase_build():
    """Build the kernels' libraries and, in parallel, a cubin of each source
    under ``ptxas -v`` for the report (the library build may find its
    libraries already built and print nothing)."""
    t0 = time.perf_counter()
    report_dir = _build.BUILD_DIR / "ptxas"
    report_dir.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    procs = [(src.stem, subprocess.Popen(
        [_build.find_nvcc(), *flags, "-cubin", "-Xptxas", "-v",
         "-o", str(report_dir / f"{src.stem}.cubin"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in _build.sources()]
    libs = _build.build_all()
    for stem in libs:
        _build.load(stem)
    report = {}
    for stem, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            fail(f"ptxas report of {stem}.cu failed:\n{log}")
        report[stem] = parse_ptxas(log)
    emit({"build": {"seconds": round(time.perf_counter() - t0, 3),
                    "libraries": sorted(p.name for p in libs.values()),
                    "ptxas": report}})
    knn_fns = report.get("knn", {})
    if len(knn_fns) != hopper_knn.MAX_K:
        fail(f"ptxas report lists {len(knn_fns)} k-NN instantiations, expected "
             f"{hopper_knn.MAX_K}")
    spilled = [n for n, v in knn_fns.items()
               if v.get("spill_stores", 1) or v.get("spill_loads", 1)]
    if spilled:
        fail(f"k-NN instantiations spill to local memory: {spilled}")
    return report


# --------------------------------------------------------------------------
# K1: label propagation
# --------------------------------------------------------------------------

def random_label_case(r, c, seed):
    """Random connectivity, as the JAX package's own kernel test draws it."""
    g = torch.Generator().manual_seed(seed)
    clusterable = torch.rand((r, c), generator=g) < 0.8
    conn_h = (torch.rand((r, c), generator=g) < 0.7) & clusterable
    conn_h[:, 1:] &= clusterable[:, :-1]
    conn_h[:, 0] &= clusterable[:, -1]
    conn_v = (torch.rand((r, c), generator=g) < 0.6) & clusterable
    conn_v[1:] &= clusterable[:-1]
    conn_v[0] = False
    labels = torch.arange(r * c, dtype=torch.int32).reshape(r, c)
    labels = torch.where(clusterable, labels, r * c)
    return labels.to(DEV), conn_h.to(DEV), conn_v.to(DEV)


def rendered_label_case(img, model, cfg):
    _, clusterable, conn_h, conn_v = S.connectivity(img, model, cfg.segmenter)
    r, c = clusterable.shape
    labels = torch.arange(r * c, dtype=torch.int32, device=DEV).reshape(r, c)
    return torch.where(clusterable, labels, r * c), conn_h, conn_v


def check_labels(name, case, rounds_list=(3, 8)):
    out = []
    for rounds in rounds_list:
        got = hopper_labels.propagate_labels(*case, rounds=rounds)
        torch.cuda.synchronize()
        want = hopper_labels.propagate_labels_plain(*case, rounds=rounds)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        changed = int((got != case[0]).sum())
        if err != 0:
            fail(f"labels kernel differs from its plain version on {name} "
                 f"rounds={rounds}: max abs diff {err}")
        out.append({"case": name, "shape": list(case[0].shape),
                    "rounds": rounds, "max_abs_err": err,
                    "cells_relabelled": changed})
    return out


def label_bound_ms(shape, rounds):
    """The least time for an image [R, C] or a batch [B, R, C]: the labels
    and both connection bytes read once, the labels written once."""
    cells = math.prod(shape)
    t_bytes = cells * (4 + 1 + 1 + 4) / PEAK_BYTES_S
    t_ops = cells * rounds * LABEL_OPS_PER_CELL_ROUND / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------
# K2: k-NN
# --------------------------------------------------------------------------

def check_knn(name, q, r, m, k, ties=False):
    """Hold the kernel against ``knn_plain``. With ``ties`` (inputs whose
    distances are exact in float32 and tie often) every slot's distance and
    index must be equal: both keep the lowest index among equal distances."""
    d, i = hopper_knn.knn(q, r, m, k)
    torch.cuda.synchronize()
    dp, ip = knn_ops.knn_plain(q, r, m, k)
    if ties and not (torch.equal(d, dp) and torch.equal(i, ip)):
        fail(f"knn {name}: {int((i != ip).sum())} of {i.numel()} indices and "
             f"{int((d != dp).sum())} distances differ from the plain version "
             "on exact ties")
    if d.shape != (q.shape[0], k) or i.shape != d.shape or i.dtype != torch.int64:
        fail(f"knn {name}: wrong output shape/dtype")
    if int(i.min()) < 0 or int(i.max()) >= r.shape[0]:
        fail(f"knn {name}: index out of [0, Nr)")
    real = dp < 1e29
    if not torch.equal(real, d < 1e29):
        fail(f"knn {name}: masked/padded slots differ from the plain version")
    if not bool((d[~real] == 1e30).all()):
        fail(f"knn {name}: empty slots must hold d2 = 1e30")
    tol = KNN_RTOL * dp.abs().clamp(min=1e-6)
    err = (d - dp).abs()
    if bool((real & (err > tol)).any()):
        fail(f"knn {name}: distances differ, max abs err "
             f"{float(err[real].max())}")
    # indices must agree wherever the neighbouring distances (in the sorted
    # list) are further apart than the tolerance: ties may order either way
    gap_prev = torch.full_like(dp, float("inf"))
    gap_next = torch.full_like(dp, float("inf"))
    if k > 1:
        gap_prev[:, 1:] = dp[:, 1:] - dp[:, :-1]
        gap_next[:, :-1] = dp[:, 1:] - dp[:, :-1]
    distinct = real & (gap_prev > 2 * tol) & (gap_next > 2 * tol)
    # the index a slot returns must be a reference at the distance it returns
    back = ((q[:, None, :] - r[i]) ** 2).sum(-1)
    if bool((real & ((back - d).abs() > tol)).any()):
        fail(f"knn {name}: returned indices do not lie at the returned distances")
    if bool((real & ~m[i]).any()):
        fail(f"knn {name}: a masked reference was returned")
    # and must be the plain version's index at distinct distances; the k-th
    # slot may also tie with the unseen (k+1)-th, so it is only counted
    mismatch = distinct & (i != ip)
    if bool(mismatch[:, :k - 1].any()):
        fail(f"knn {name}: {int(mismatch[:, :k - 1].sum())} indices differ "
             "at distinct distances")
    max_err = float(err[real].max()) if bool(real.any()) else 0.0
    # where a slot's index differs, whether the two references' exact d²
    # lie within 1 ulp of float32 (a near-tie the two roundings may order
    # either way) or further apart (a fault)
    differs = real & (i != ip)
    q64, r64 = q.double()[:, None, :], r.double()
    gap = (((q64 - r64[i]) ** 2).sum(-1) - ((q64 - r64[ip]) ** 2).sum(-1)).abs()
    ulp = (torch.nextafter(dp, torch.full_like(dp, float("inf"))) - dp).double()
    return {"case": name, "nq": q.shape[0], "nr": r.shape[0], "k": k,
            "valid_refs": int(m.sum()), "max_abs_err": max_err,
            "lanes_per_query": hopper_knn.lanes_per_query(q.shape[0], SMS),
            "all_slots_equal": bool(torch.equal(i, ip)),
            "slots_differing": int(differs.sum()),
            "slots_differing_beyond_1ulp": int((differs & (gap > ulp)).sum()),
            "indices_compared": int(distinct.sum()),
            "kth_slot_index_differs": int(mismatch.sum())}


def check_addcmul_fuses():
    """``knn_plain`` holds the kernel's rounding only if ``torch.addcmul`` is
    one fused multiply-add on the card, which PyTorch does not promise:
    a + b·b − round(a + b·b)'s rounding error must survive, as an fma keeps
    it and a separately rounded product loses it."""
    g = torch.Generator().manual_seed(5)
    b = (1 + torch.rand(4096, generator=g)).to(DEV)
    fused = torch.addcmul(-(b * b), b, b)
    exact = (b.double() ** 2 - (b * b).double()).float()
    if not torch.equal(fused, exact) or not bool((fused != 0).any()):
        fail("torch.addcmul is not one fused multiply-add on this card: knn_plain "
             "would round distances unlike the kernel (ops/knn.pairwise_sqdist)")


def knn_bound_ms(nq, nr, n_valid, k):
    t_ops = nq * n_valid * KNN_FLOPS_PER_PAIR / PEAK_F32_FLOPS
    t_bytes = (nq * 12 + nr * 12 + nr + nq * k * 12) / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def library_knn(q, r, m, k):
    d = torch.cdist(q, r)
    d = torch.where(m[None, :], d, float("inf"))
    return torch.topk(d, min(k, r.shape[0]), dim=1, largest=False)


def knn_edge_cases():
    g = torch.Generator().manual_seed(7)
    def pts(n, scale=20.0):
        return ((torch.rand((n, 3), generator=g) - 0.5) * scale).to(DEV)
    cases = []
    q, r = pts(300), pts(1500)
    m = torch.ones(1500, dtype=torch.bool, device=DEV)
    for k in (1, 5, 8):
        cases.append((f"dense_k{k}", q, r, m, k))
    m2 = (torch.rand(1500, generator=g) < 0.02).to(DEV)
    cases.append(("almost_all_masked_k5", q, r, m2, 5))
    cases.append(("all_masked_k3", q, r, torch.zeros_like(m), 3))
    r3 = pts(1031)   # not a multiple of the 1024-point tile
    cases.append(("ragged_tile_k8", q, r3, torch.ones(1031, dtype=torch.bool, device=DEV), 8))
    r4 = pts(3)
    cases.append(("nr_lt_k", pts(70), r4, torch.ones(3, dtype=torch.bool, device=DEV), 5))
    far = pts(2000, 0.5) + torch.tensor([80.0, -60.0, 2.0], device=DEV)
    cases.append(("lidar_range_offsets_k5", far[:500], far, torch.ones(2000, dtype=torch.bool, device=DEV), 5))
    r5 = pts(5000)
    cases.append(("nq_1_k8", pts(1), r5, torch.ones(5000, dtype=torch.bool, device=DEV), 8))
    # 3001 queries at 8 lanes each: the last warp is a quarter full
    cases.append(("nq_3001_k5", pts(3001), r5, (torch.rand(5000, generator=g) < 0.6).to(DEV), 5))
    return cases


def knn_tie_cases():
    """Integer-grid references in shuffled order and half-integer queries:
    every squared distance is a multiple of 1/4, exact in float32, and most
    k-lists hold ties. 1331 references: not a multiple of the 1024-point
    tile. 500 queries run at 32 lanes each, 6144 at 8."""
    g = torch.Generator().manual_seed(11)
    ax = torch.arange(11, dtype=torch.float32)
    grid = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    grid = grid[torch.randperm(grid.shape[0], generator=g)].to(DEV)
    nr = grid.shape[0]
    q = (torch.randint(0, 10, (500, 3), generator=g).float() + 0.5).to(DEV)
    q_many = (torch.randint(0, 10, (6144, 3), generator=g).float() + 0.5).to(DEV)
    ones = torch.ones(nr, dtype=torch.bool, device=DEV)
    part = (torch.rand(nr, generator=g) < 0.7).to(DEV)
    cases = [(f"ties_grid_k{k}", q, grid, ones, k) for k in (1, 5, 8)]
    cases.append(("ties_grid_70pct_valid_k8", q, grid, part, 8))
    cases.append(("ties_grid_6144q_k5", q_many, grid, part, 5))
    # twins: each query on the diagonal x = y has two references at swapped
    # x / y offsets, at one exact distance; the kernel's fused multiply-adds
    # (fma(dz, dz, fma(dx, dx, dy*dy))) round the two apart for about one
    # query in ten, where a separately rounded sum would tie them
    s = torch.rand(512, generator=g) * 40 - 20
    qz = torch.rand(512, generator=g) * 2
    u, v = torch.rand(512, generator=g) * 2 + 0.1, torch.rand(512, generator=g) * 2 + 0.1
    w = torch.rand(512, generator=g) * 0.5
    twins = torch.cat([torch.stack([s + v, s + u, qz + w], -1),
                       torch.stack([s + u, s + v, qz + w], -1)]).to(DEV)
    cases.append(("fma_rounded_twins_k5", torch.stack([s, s, qz], -1).to(DEV), twins,
                  torch.ones(1024, dtype=torch.bool, device=DEV), 5))
    return cases


def mapper_scale_case():
    """6144 queries against a 65536-point map, ~30 % valid, k = 5: the size
    the mapper's slice will hand the kernel (not on the main path yet)."""
    g = torch.Generator().manual_seed(13)
    r = (torch.rand((65536, 3), generator=g) - 0.5) * torch.tensor([120.0, 120.0, 8.0])
    m = torch.rand(65536, generator=g) < 0.3
    q = r[torch.randperm(65536, generator=g)[:6144]] + 0.05 * torch.randn((6144, 3), generator=g)
    return "mapper_6144x65536_k5", q.to(DEV), r.to(DEV), m.to(DEV), 5


# --------------------------------------------------------------------------
# capture the main path's kernel inputs
# --------------------------------------------------------------------------

def capture_main_path_inputs(cfg, extrinsics=None):
    """Run the pipeline until the window is warm and record, on the first
    steady sweep, the tensors the path hands to each kernel: the tracker's
    two k-NN calls, the window's two, and one label call per lidar (one for
    a uniform rig's batch)."""
    n = cfg.odometry.window_size + 2
    L = cfg.rig.n_lidars
    seqs, _ = run_synthetic.render_rig(cfg, n, seed=1, extrinsics=extrinsics,
                                       device=DEV)
    pipe = OdometryPipeline(cfg, device=DEV)
    if extrinsics is not None:
        pipe.set_extrinsics(extrinsics)
    knn_calls, label_calls = [], []
    real_knn, real_labels = hopper_knn.knn, hopper_labels.propagate_labels

    def rec_knn(q, r, m, k):
        knn_calls.append((q.clone(), r.clone(), m.clone(), k))
        return real_knn(q, r, m, k)

    def rec_labels(labels, ch, cv, rounds=3):
        label_calls.append((labels.clone(), ch.clone(), cv.clone(), rounds))
        return real_labels(labels, ch, cv, rounds)

    for i in range(n):
        frames = [RangeImage(*(f[i] for f in imgs)) for imgs in seqs]
        if i == n - 1:
            hopper_knn.knn, hopper_labels.propagate_labels = rec_knn, rec_labels
        try:
            pipe.process(frames)
        finally:
            hopper_knn.knn, hopper_labels.propagate_labels = real_knn, real_labels
    torch.cuda.synchronize()
    want_labels = 1 if uniform_rig(cfg) else L
    if len(knn_calls) != 4 or len(label_calls) != want_labels:
        fail(f"steady sweep of {L} lidar(s) made {len(knn_calls)} k-NN and "
             f"{len(label_calls)} label calls; expected 4 and {want_labels}")
    last_img = RangeImage(*(f[n - 1] for f in seqs[0]))
    return knn_calls, label_calls[0], last_img


def knn_by_lanes(name, q, r, m, k):
    """Time the kernel (``graph_ms``) at every lanes-per-query choice
    ``lanes_per_query`` can make, through its C entry (not counted: these are
    not the main path's launches), and require the same answer from each: the
    lanes' lists merge exactly."""
    fn = hopper_knn._kernel_fn()
    r, m = hopper_knn.aligned16(r), hopper_knn.aligned16(m)
    want = hopper_knn.knn(q, r, m, k)
    out = {}
    for lanes in (8, 16, 32):
        d = torch.empty_like(want[0])
        i = torch.empty_like(want[1])

        def call():
            _build.check(fn(q.data_ptr(), r.data_ptr(), m.data_ptr(), d.data_ptr(),
                            i.data_ptr(), q.shape[0], r.shape[0], k, lanes,
                            torch.cuda.current_stream().cuda_stream), "knn")
        out[lanes] = graph_ms(call)
        if not (torch.equal(d, want[0]) and torch.equal(i, want[1])):
            fail(f"knn {name}: {lanes} lanes per query give another answer")
    return out


def knn_timing(name, q, r, m, k, chk):
    n0 = hopper_knn.launches
    hopper_knn.knn(q, r, m, k)
    per_call = hopper_knn.launches - n0
    if per_call != 1:
        fail(f"knn {name}: one call made {per_call} kernel launches; the design is one")
    ms = time_ms(lambda: hopper_knn.knn(q, r, m, k))
    g_ms = graph_ms(lambda: hopper_knn.knn(q, r, m, k))
    bound, by = knn_bound_ms(q.shape[0], r.shape[0], chk["valid_refs"], k)
    all_valid = torch.ones_like(m)
    return {"name": name, "nq": q.shape[0], "nr": r.shape[0], "k": k,
            "valid_refs": chk["valid_refs"],
            "lanes_per_query": chk["lanes_per_query"],
            "launches_per_call": per_call,
            "max_abs_err": chk["max_abs_err"], "ms": ms, "graph_ms": g_ms,
            "plain_ms": time_ms(lambda: knn_ops.knn_plain(q, r, m, k), reps=5),
            "library_ms": time_ms(lambda: library_knn(q, r, m, k), reps=5),
            "bound_ms": bound, "bound_by": by, "bound_share": bound / ms,
            "graph_bound_share": bound / g_ms,
            # what skipping masked references and splitting a query buy
            "graph_ms_all_refs_valid": graph_ms(lambda: hopper_knn.knn(q, r, all_valid, k)),
            "graph_ms_by_lanes": knn_by_lanes(name, q, r, m, k)}


def label_timing(name, case, rounds):
    lab, ch, cv = case
    n0 = hopper_labels.launches
    hopper_labels.propagate_labels(lab, ch, cv, rounds)
    per_call = hopper_labels.launches - n0   # counted by the C entry
    if per_call != 1:
        fail(f"labels {name}: one call of {rounds} rounds made {per_call} kernel "
             "launches; the design is one")
    ms = time_ms(lambda: hopper_labels.propagate_labels(lab, ch, cv, rounds))
    g_ms = graph_ms(lambda: hopper_labels.propagate_labels(lab, ch, cv, rounds))
    bound, by = label_bound_ms(lab.shape, rounds)
    # the slope over rounds is the cost of one round; what is left at 0, the
    # launch and the image's one read and write
    by_rounds = {n: graph_ms(lambda: hopper_labels.propagate_labels(lab, ch, cv, n))
                 for n in (1, 2, 8)}
    return {"name": name, "shape": list(lab.shape), "rounds": rounds,
            "smem_bytes_per_block": hopper_labels.smem_bytes(*lab.shape[-2:]),
            "launches_per_call": per_call, "ms": ms, "graph_ms": g_ms,
            "plain_ms": time_ms(lambda: hopper_labels.propagate_labels_plain(lab, ch, cv, rounds), reps=5),
            "bound_ms": bound, "bound_by": by, "bound_share": bound / ms,
            "graph_bound_share": bound / g_ms,
            "graph_ms_by_rounds": {**by_rounds, rounds: g_ms}}


def phase_kernels(cfg, rig_cfg):
    model = cfg.rig.models[0]
    knn_calls, label_call, img = capture_main_path_inputs(cfg)
    rig_knn_calls, _, _ = capture_main_path_inputs(rig_cfg, RIG_X)

    # ---- K1 correctness
    smem_fn = _build.load("labels").mloam_labels_smem_bytes
    smem_fn.argtypes = [ctypes.c_int, ctypes.c_int]
    smem_fn.restype = ctypes.c_longlong
    label_checks = []
    for (r, c) in ((16, 1800), (32, 2160), (64, 1800), (5, 37), (1, 1800), (13, 1800)):
        if smem_fn(r, c) != hopper_labels.smem_bytes(r, c):
            fail(f"labels: the wrapper's shared-memory size for {r}x{c} "
                 f"({hopper_labels.smem_bytes(r, c)}) is not the kernel's ({smem_fn(r, c)})")
        label_checks += check_labels(f"random_{r}x{c}", random_label_case(r, c, r + c))
    label_checks += check_labels("rendered_frame", rendered_label_case(img, model, cfg))
    label_checks += check_labels("main_path", label_call[:3], (label_call[3],))
    # ---- K1 timing: the main-path call, and the other sensors' shapes
    lab, ch, cv, rounds = label_call
    k1 = label_timing("main_path", (lab, ch, cv), rounds)
    k1_other = [label_timing(f"random_{r}x{c}", random_label_case(r, c, r + c), rounds)
                for (r, c) in ((32, 2160), (64, 1800))]

    # ---- K2 correctness: knn_plain's fused sums, edge cases, exact ties,
    # the main path's calls
    check_addcmul_fuses()
    knn_checks = [check_knn(*c) for c in knn_edge_cases()]
    knn_checks += [check_knn(*c, ties=True) for c in knn_tie_cases()]
    names = ("tracker_edge", "tracker_plane", "window_edge", "window_plane")
    shapes = []
    for name, (q, r, m, k) in zip(names, knn_calls):
        chk = check_knn(f"main_path_{name}", q, r, m, k)
        knn_checks.append(chk)
        shapes.append(knn_timing(name, q, r, m, k, chk))
    # the dual rig: the tracker's calls have the single rig's shapes, the
    # window's are new (two lidars' queries against a two-lidar map)
    rig_shapes = []
    for name, (q, r, m, k) in zip(names, rig_knn_calls):
        chk = check_knn(f"rig_path_{name}", q, r, m, k)
        knn_checks.append(chk)
        if name.startswith("window"):
            rig_shapes.append(knn_timing(f"rig_{name}", q, r, m, k, chk))
    mapper = mapper_scale_case()
    chk = check_knn(*mapper)
    knn_checks.append(chk)
    mapper_timing = knn_timing(*mapper, chk)
    emit({"kernel_checks": {"labels": label_checks, "knn": knn_checks}})

    big = max(shapes, key=lambda s: s["nq"] * s["nr"])
    return [
        {"name": "propagate_labels", "route": "cuda",
         "source": "mloam_tpu_torch/csrc/labels.cu",
         "replaces": "mloam_tpu/ops/pallas_labels.py:58",
         "shape": k1["shape"], "rounds": rounds,
         "kernel_launches_per_call": k1["launches_per_call"],
         "max_abs_err": max(c["max_abs_err"] for c in label_checks),
         "ms": k1["ms"], "graph_ms": k1["graph_ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "bound_share": k1["bound_share"], "graph_bound_share": k1["graph_bound_share"],
         "library_ms": None,
         "graph_ms_by_rounds": k1["graph_ms_by_rounds"], "other_shapes": k1_other},
        {"name": "knn", "route": "cuda",
         "source": "mloam_tpu_torch/csrc/knn.cu",
         "replaces": "mloam_tpu/ops/pallas_knn.py:55",
         "shape": {k: big[k] for k in ("name", "nq", "nr", "k", "valid_refs",
                                       "lanes_per_query")},
         "max_abs_err": max(s["max_abs_err"] for s in shapes),
         "ms": big["ms"], "graph_ms": big["graph_ms"], "plain_ms": big["plain_ms"],
         "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
         "bound_share": big["bound_share"], "graph_bound_share": big["graph_bound_share"],
         "library_ms": big["library_ms"],
         "per_sweep_ms": sum(s["ms"] for s in shapes),
         "per_sweep_graph_ms": sum(s["graph_ms"] for s in shapes),
         "per_sweep_bound_ms": sum(s["bound_ms"] for s in shapes),
         "main_path_shapes": shapes + rig_shapes, "mapper_scale": mapper_timing},
    ]


# --------------------------------------------------------------------------
# main path
# --------------------------------------------------------------------------

def knn_per_sweep(i, mode_before, n_lidars, window_size, skip_steady=False):
    """K2 launches of sweep ``i``: none at sweep 0; from sweep 1 the
    tracker's two matchers, once per lidar in a sweep that starts in mode 2;
    from the ``window_size``-th sweep the window solve's two. With
    ``skip_steady`` a steady sweep (mode 0, window full) runs no tracker."""
    if i == 0:
        return 0
    window = 2 if i >= window_size else 0
    if skip_steady and mode_before == 0 and i >= window_size:
        return window
    return (2 * n_lidars if mode_before == 2 else 2) + window


def expected_knn(modes, n_lidars, window_size, first_mode, skip_steady=False):
    """K2 launches over a run whose sweeps ended in ``modes``."""
    befores = [first_mode] + list(modes[:-1])
    return sum(knn_per_sweep(i, b, n_lidars, window_size, skip_steady)
               for i, b in enumerate(befores))


def uniform_rig(cfg):
    """A rig whose steady sweeps run one batched frontend: L > 1 lidars of
    one sensor model."""
    models = cfg.rig.models
    return len(models) > 1 and all(m == models[0] for m in models)


def labels_per_sweep(i, mode_before, cfg):
    """K1 launches of sweep ``i`` that started in ``mode_before``: one per
    lidar, but one for a uniform rig's batch on a steady sweep (mode 0,
    window full)."""
    steady = mode_before == 0 and i >= cfg.odometry.window_size
    return 1 if steady and uniform_rig(cfg) else cfg.rig.n_lidars


def expected_labels(modes, cfg, first_mode):
    """K1 launches over a run whose sweeps ended in ``modes``."""
    befores = [first_mode] + list(modes[:-1])
    return sum(labels_per_sweep(i, b, cfg) for i, b in enumerate(befores))


def zero_counters():
    hopper_labels.launches = 0
    hopper_knn.launches = 0


def check_counters(path, n_labels, n_knn, want_labels, want_knn):
    if n_labels != want_labels or n_knn != want_knn:
        fail(f"{path}: launch counters labels {n_labels} (expected {want_labels}), "
             f"knn {n_knn} (expected {want_knn}) — the run did not go "
             "through the kernels as expected")


def check_trajectory(path, res, n_frames, gate=True):
    est_t, est_q = res["est_t"], res["est_q"]
    if est_t.shape != (n_frames, 3) or est_q.shape != (n_frames, 4):
        fail(f"{path}: trajectory has the wrong shape")
    if not (np.isfinite(est_t).all() and np.isfinite(est_q).all()):
        fail(f"{path}: trajectory holds non-finite poses")
    if gate and not res["ate_m"] < ATE_GATE_M:
        fail(f"{path}: ATE {res['ate_m']:.4f} m is not under the {ATE_GATE_M} m gate")
    return float(np.linalg.norm(np.diff(res["gt_t"], axis=0), axis=1).sum())


def width(cfg):
    return {"range_images": [[m.n_rings, m.n_cols] for m in cfg.rig.models],
            "cap_frame_corner": cfg.odometry.cap_frame_corner,
            "cap_frame_surf": cfg.odometry.cap_frame_surf,
            "cap_less_flat": cfg.features.cap_less_flat,
            "window_size": cfg.odometry.window_size,
            "opt_window_size": cfg.odometry.opt_window_size}


class FrozenSum:
    """``on_sweep`` callback: the directions the window's remap froze (and,
    on mapped sweeps, the mapper's), kept on the device and summed after the
    run, so that the sweeps wait for nothing more."""

    def __init__(self):
        self.win, self.map = [], []

    def __call__(self, i, out, pipe):
        full = getattr(out, "full", out)
        odom = getattr(full, "odom", full)
        if odom.win_frozen is not None:
            self.win.append(odom.win_frozen.sum())
        if getattr(full, "mapped", False) and full.map_frozen is not None:
            self.map.append(torch.as_tensor(full.map_frozen).sum())

    def totals(self):
        return tuple(float(torch.stack(x).sum()) if x else 0.0 for x in (self.win, self.map))


class TimerWaits:
    """``on_sweep`` callback beside ``FrozenSum``: the device waits the
    timers issued in each sweep (``timing._sync``, the synchronising branch,
    wrapped to count its calls inside the ``with`` block), and ``sync_timing``
    switched on for the last ``SYNC_TIMING_SWEEPS`` sweeps of the run."""

    def __init__(self, n_frames):
        self.n_frames, self.per_sweep, self.calls = n_frames, [], 0
        self.real = timing._sync

    def __enter__(self):
        def counted():
            self.calls += 1
            self.real()

        timing._sync = counted
        return self

    def __exit__(self, *exc):
        timing._sync = self.real

    def __call__(self, i, out, pipe):
        self.per_sweep.append(self.calls - sum(self.per_sweep))
        if i == self.n_frames - SYNC_TIMING_SWEEPS - 1:
            pipe.sync_timing = True


def phase_main_path(cfg):
    zero_counters()
    frozen = FrozenSum()
    waits = TimerWaits(N_FRAMES)

    def on_sweep(i, out, pipe):
        frozen(i, out, pipe)
        waits(i, out, pipe)

    with waits:
        res = run_synthetic.run(n_frames=N_FRAMES, seed=0, verbose=False,
                                device=DEV, cfg=cfg, on_sweep=on_sweep)
    n_labels, n_knn = hopper_labels.launches, hopper_knn.launches
    win_frozen, _ = frozen.totals()
    # the per-sweep timer (odom_process) waits at each end of every sweep;
    # the three stage timers only with sync_timing on, at entry and exit
    stage_waits = [w - 2 for w in waits.per_sweep]
    want_waits = [0] * (N_FRAMES - SYNC_TIMING_SWEEPS) + [6] * SYNC_TIMING_SWEEPS
    ws = cfg.odometry.window_size
    # one call per sweep, one launch per call
    check_counters("main path", n_labels, n_knn, N_FRAMES,
                   expected_knn(res["modes"], 1, ws, 0))
    path_m = check_trajectory("main path", res, N_FRAMES)
    emit({"main_path": {
        "frames": N_FRAMES, "ate_m": res["ate_m"], "path_m": path_m,
        "steady_ms_median": res["steady_ms_median"],
        "steady_fps": res["fps"],
        "win_frozen_sum": win_frozen,
        "stage_timer_waits_per_sweep": stage_waits,
        "sync_timing_from_sweep": N_FRAMES - SYNC_TIMING_SWEEPS,
        "launches": {"propagate_labels": n_labels, "knn": n_knn},
        "width": width(cfg),
    }})
    if stage_waits != want_waits:
        fail(f"main path: the stage timers waited for the device {stage_waits} times a "
             f"sweep, expected {want_waits} (none by default, one at each stage entry "
             "and exit with sync_timing)")
    # the disarmed default must not freeze on an observed scene
    # (tests/test_degeneracy_e2e.py:144-160)
    if win_frozen != 0:
        fail(f"main path: the window's remap froze {win_frozen} directions")
    return {"propagate_labels": n_labels, "knn": n_knn}


def phase_rig_path(cfg, rig_window_shapes):
    """The dual rig with its extrinsics installed (mode 0): its steady
    sweeps run the batched frontend."""
    L = cfg.rig.n_lidars
    zero_counters()
    res = run_synthetic.run(n_frames=N_FRAMES, seed=0, verbose=False, device=DEV,
                            cfg=cfg, extrinsics=RIG_X)
    n_labels, n_knn = hopper_labels.launches, hopper_knn.launches
    if set(res["modes"]) != {0}:
        fail(f"rig path: left mode 0: {res['modes']}")
    check_counters("rig path", n_labels, n_knn, expected_labels(res["modes"], cfg, 0),
                   expected_knn(res["modes"], L, cfg.odometry.window_size, 0))
    path_m = check_trajectory("rig path", res, N_FRAMES)
    emit({"rig_path": {
        "frames": N_FRAMES, "lidars": L, "ate_m": res["ate_m"], "path_m": path_m,
        "steady_ms_median": res["steady_ms_median"], "steady_fps": res["fps"],
        "launches": {"propagate_labels": n_labels, "knn": n_knn},
        "window_knn_shapes": [{k: s[k] for k in ("name", "nq", "nr", "k", "valid_refs")}
                              for s in rig_window_shapes],
        "width": width(cfg),
    }})
    return {"propagate_labels": n_labels, "knn": n_knn}, res


def phase_calib_path(cfg):
    """The dual rig from fully unknown extrinsics through 2 -> 1 -> 0; the
    counters are read after every sweep and checked against the mode the
    sweep started in. The k-NN inputs of the first warm sweep in mode 2 and
    of the first sweep in mode 1 are kept, to be held against the plain
    version after the run."""
    L = cfg.rig.n_lidars
    ws = cfg.odometry.window_size
    per_mode = {m: {"sweeps": 0, "propagate_labels": 0, "knn": 0, "ms": []}
                for m in (2, 1, 0)}
    seen = {"before": cfg.rig.extrinsic_mode, "labels": 0, "knn": 0}
    captured, recording = {}, []
    real_knn = hopper_knn.knn

    def rec_knn(q, r, m, k):
        if recording:
            recording[0].append((q.clone(), r.clone(), m.clone(), k))
        return real_knn(q, r, m, k)

    def on_sweep(i, out, pipe):
        before = seen["before"]
        d_l = hopper_labels.launches - seen["labels"]
        d_k = hopper_knn.launches - seen["knn"]
        want_l, want_k = labels_per_sweep(i, before, cfg), knn_per_sweep(i, before, L, ws)
        if d_l != want_l or d_k != want_k:
            fail(f"calibration path, sweep {i} (started in mode {before}): "
                 f"labels {d_l} (expected {want_l}), knn {d_k} (expected {want_k})")
        rec = per_mode[before]
        rec["sweeps"] += 1
        rec["propagate_labels"] += d_l
        rec["knn"] += d_k
        if recording:
            captured[before] = recording.pop()
        seen.update(before=out.ext_mode, labels=hopper_labels.launches,
                    knn=hopper_knn.launches, pipe=pipe)
        if i + 1 >= ws and out.ext_mode in (2, 1) and out.ext_mode not in captured:
            recording.append([])

    if cfg.rig.extrinsic_mode != 2:
        fail("calibration path: the rig does not start in mode 2")
    zero_counters()
    hopper_knn.knn = rec_knn
    try:
        res = run_synthetic.run(n_frames=CALIB_FRAMES, seed=0, verbose=False,
                                device=DEV, cfg=cfg, extrinsics=CALIB_X,
                                install_extrinsics=False, wobble=0.25,
                                on_sweep=on_sweep)
    finally:
        hopper_knn.knn = real_knn
    n_labels, n_knn = hopper_labels.launches, hopper_knn.launches
    modes = res["modes"]
    check_counters("calibration path", n_labels, n_knn, expected_labels(modes, cfg, 2),
                   expected_knn(modes, L, ws, 2))
    check_trajectory("calibration path", res, CALIB_FRAMES, gate=False)
    for before, dt in zip([2] + modes[:-1], res["sweep_ms"]):
        per_mode[before]["ms"].append(dt)
    init = next((i for i, m in enumerate(modes) if m < 2), None)
    frozen = next((i for i, m in enumerate(modes) if m == 0), None)
    errs = [e[0] for e in res["ext_err"]]   # lidar 1's (rad, m) per sweep
    rot_err, pos_err = errs[-1]
    ext_cov = seen["pipe"].ext_cov
    emit({"calib_path": {
        "frames": CALIB_FRAMES, "lidars": L, "wobble": 0.25,
        "transitions": {"init_done": init, "frozen": frozen},
        "jax_record": JAX_CALIB_RECORD,
        "final_rot_err_rad": rot_err, "final_pos_err_m": pos_err,
        "ext_cov_trace": [float(np.trace(c)) for c in ext_cov]
        if ext_cov is not None else None,
        "ate_m": res["ate_m"],
        "modes": "".join(str(m) for m in modes),
        "rot_err_trace_rad": [e[0] for e in errs],
        "pos_err_trace_m": [e[1] for e in errs],
        "per_mode": {str(m): {**{k: v for k, v in r.items() if k != "ms"},
                              "ms_median": float(np.median(r["ms"])) if r["ms"] else None}
                     for m, r in per_mode.items()},
        "launches": {"propagate_labels": n_labels, "knn": n_knn},
    }})
    if init is None or frozen is None:
        fail(f"calibration path: the lifecycle did not complete in {CALIB_FRAMES} "
             f"sweeps (modes {''.join(str(m) for m in modes)})")
    if not (rot_err < CALIB_ROT_GATE_RAD and pos_err < CALIB_POS_GATE_M):
        fail(f"calibration path: final extrinsic error {rot_err:.5f} rad / "
             f"{pos_err:.4f} m is not under {CALIB_ROT_GATE_RAD} rad / "
             f"{CALIB_POS_GATE_M} m")
    if set(captured) != {2, 1}:
        fail(f"calibration path: no warm sweep captured in mode(s) "
             f"{sorted({2, 1} - set(captured))}")
    return {"propagate_labels": n_labels, "knn": n_knn}, captured


def calib_knn_checks(captured, L):
    """Hold the calibration path's k-NN calls against the plain version and
    time its window calls: in mode 2 every lidar's tracker and a window
    matched against the reference lidar alone, in mode 1 the reference
    tracker and a window with the extrinsic blocks."""
    names = {2: [f"tracker_l{l}_{c}" for l in range(L) for c in ("edge", "plane")],
             1: ["tracker_edge", "tracker_plane"]}
    checks, shapes = [], []
    for mode, calls in sorted(captured.items(), reverse=True):
        want = names[mode] + ["window_edge", "window_plane"]
        if len(calls) != len(want):
            fail(f"calibration path, mode {mode}: a warm sweep made {len(calls)} "
                 f"k-NN calls; expected {len(want)}")
        for name, (q, r, m, k) in zip(want, calls):
            chk = check_knn(f"calib_mode{mode}_{name}", q, r, m, k)
            checks.append(chk)
            if name.startswith("window"):
                shapes.append(knn_timing(f"calib_mode{mode}_{name}", q, r, m, k, chk))
    return checks, shapes


def phase_presets():
    """A few sweeps of three shipped presets at their own sensor shapes. The
    first label-propagation call at each shape (a uniform rig's batch too) is
    kept, to be held against the plain version after the run, and the calls
    are counted by shape."""
    captured, calls = {}, collections.Counter()
    real_labels = hopper_labels.propagate_labels

    def rec_labels(labels, ch, cv, rounds=3):
        shape = tuple(labels.shape)
        calls[shape] += 1
        if shape not in captured:
            captured[shape] = (labels.clone(), ch.clone(), cv.clone(), rounds)
        return real_labels(labels, ch, cv, rounds)

    runs, counts, by_shape, results = {}, {}, {}, {}
    for name, cfg, ext in (("oxford", platforms.oxford(), RIG_X),
                           ("kitti", platforms.kitti(), None),
                           ("vehicle_hercules", platforms.vehicle_hercules(), HERCULES_X)):
        L = cfg.rig.n_lidars
        zero_counters()
        calls.clear()
        hopper_labels.propagate_labels = rec_labels
        try:
            res = run_synthetic.run(n_frames=PRESET_FRAMES, seed=2, verbose=False,
                                    device=DEV, cfg=cfg, extrinsics=ext)
        finally:
            hopper_labels.propagate_labels = real_labels
        n_labels, n_knn = hopper_labels.launches, hopper_knn.launches
        mode = cfg.rig.extrinsic_mode if L > 1 else 0
        check_counters(name, n_labels, n_knn, expected_labels(res["modes"], cfg, mode),
                       expected_knn(res["modes"], L, cfg.odometry.window_size, mode))
        if sum(calls.values()) != n_labels:
            fail(f"{name}: {sum(calls.values())} label calls for {n_labels} launches")
        check_trajectory(name, res, PRESET_FRAMES, gate=False)
        counts[name] = {"propagate_labels": n_labels, "knn": n_knn}
        for shape, n in calls.items():
            by_shape[shape] = by_shape.get(shape, 0) + n
        results[name] = res
        runs[name] = {"frames": PRESET_FRAMES, "lidars": L,
                      "modes": "".join(str(m) for m in res["modes"]),
                      "ate_m": res["ate_m"],
                      "steady_ms_median": res["steady_ms_median"],
                      "launches": counts[name], "width": width(cfg)}
    emit({"presets": runs})
    return counts, captured, by_shape, results


# --------------------------------------------------------------------------
# the batched frontend of a uniform rig, against the unrolled frontends
# --------------------------------------------------------------------------

def run_unrolled(**kw):
    """``run_synthetic.run`` with the pipeline held, from its first sweep
    on (before any steady one), to one frontend per lidar, what a rig of
    mixed sensor models runs: the reference the batched frontend is held
    to."""
    def unroll(i, out, pipe):
        pipe._uniform_rig = False
    return run_synthetic.run(on_sweep=unroll, **kw)


def _leaves(tree, path=""):
    """(name, tensor) of every tensor of a nested named tuple."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
        return
    names = getattr(tree, "_fields", range(len(tree)))
    for name, x in zip(names, tree):
        yield from _leaves(x, f"{path}.{name}" if path else str(name))


def frontend_difference(cfg, extrinsics, seed):
    """The batched frontend against the unrolled one on the first sweep of
    the rig's sequence: the largest absolute difference over every output
    tensor, the number that differ and the first that differs."""
    seqs, _ = run_synthetic.render_rig(cfg, 1, seed=seed, extrinsics=extrinsics, device=DEV)
    frames = [RangeImage(*(f[0] for f in imgs)) for imgs in seqs]
    pipe = OdometryPipeline(cfg, device=DEV)
    unrolled = pipe._frontends(frames)
    batched = pipe._frontends(frames, batched=True)
    worst, n_diff, first, n = 0.0, 0, None, 0
    for kind, u_l, b_l in zip(("features", "corner", "surf", "outlier"), unrolled, batched):
        for l, (u, b) in enumerate(zip(u_l, b_l)):
            for (name, x), (_, y) in zip(_leaves(u), _leaves(b)):
                n += 1
                if x.shape != y.shape or x.dtype != y.dtype:
                    fail(f"batch_fe_path: lidar {l} {kind}.{name}: shape or type differs")
                if not torch.equal(x, y):
                    n_diff += 1
                    first = first or f"lidar {l} {kind}.{name}"
                    worst = max(worst, float((x.double() - y.double()).abs().max()))
    return {"tensors": n, "tensors_differing": n_diff, "max_abs_diff": worst,
            "first_differing": first}


def batched_label_timing(name, case, rounds):
    """``label_timing`` of a batch, beside its B images as B single calls
    (``graph_ms``: the launches back to back)."""
    lab, ch, cv = case
    out = label_timing(name, case, rounds)

    def singles():
        for i in range(lab.shape[0]):
            hopper_labels.propagate_labels(lab[i], ch[i], cv[i], rounds)
    out["graph_ms_single_calls"] = graph_ms(singles)
    out["ms_single_calls"] = time_ms(singles)
    return out


def phase_batch_fe_path(rig_cfg, rig_res, oxford_res):
    """The steady step's batched frontend against the unrolled one: the dual
    rig (the rig path's run) and Oxford (the preset run) against unrolled
    runs of their own; the four-lidar Hercules rig (mode 0, its extrinsics
    installed) batched and unrolled. Poses within 1e-5 m of the unrolled,
    which launches K1 once per lidar every sweep; k-NN launches alike. Each
    rig's frontend is also compared tensor by tensor on one sweep. The
    batched label calls' inputs (from the Hercules run and the frontend
    comparisons) are kept and held against the plain version at every
    slot."""
    captured = {}
    real_labels = hopper_labels.propagate_labels

    def rec_labels(labels, ch, cv, rounds=3):
        if labels.ndim == 3 and tuple(labels.shape) not in captured:
            captured[tuple(labels.shape)] = (labels.clone(), ch.clone(), cv.clone(), rounds)
        return real_labels(labels, ch, cv, rounds)

    runs, counts, steady_calls = {}, {"propagate_labels": 0, "knn": 0}, {}
    for name, cfg, ext, n, seed, batched in (
            ("dual", rig_cfg, RIG_X, N_FRAMES, 0, rig_res),
            ("hercules", platforms.vehicle_hercules(extrinsic_mode=0), HERCULES_X,
             BATCH_HERCULES_FRAMES, 0, None),
            ("oxford", platforms.oxford(), RIG_X, PRESET_FRAMES, 2, oxford_res)):
        L, ws = cfg.rig.n_lidars, cfg.odometry.window_size
        if not uniform_rig(cfg):
            fail(f"batch_fe_path, {name}: the rig is not uniform")
        kw = dict(n_frames=n, seed=seed, verbose=False, device=DEV, cfg=cfg, extrinsics=ext)
        launches = {}
        if batched is None:
            zero_counters()
            hopper_labels.propagate_labels = rec_labels
            try:
                batched = run_synthetic.run(**kw)
            finally:
                hopper_labels.propagate_labels = real_labels
            check_counters(f"batch_fe_path, {name}", hopper_labels.launches,
                           hopper_knn.launches, expected_labels(batched["modes"], cfg, 0),
                           expected_knn(batched["modes"], L, ws, 0))
            launches["batched"] = {"propagate_labels": hopper_labels.launches,
                                   "knn": hopper_knn.launches}
        zero_counters()
        ref = run_unrolled(**kw)
        n_labels, n_knn = hopper_labels.launches, hopper_knn.launches
        for res in (batched, ref):
            if set(res["modes"]) != {0}:
                fail(f"batch_fe_path, {name}: left mode 0: {res['modes']}")
        # one launch per lidar on every sweep
        check_counters(f"batch_fe_path, {name} unrolled", n_labels, n_knn, L * n,
                       expected_knn(ref["modes"], L, ws, 0))
        launches["unrolled"] = {"propagate_labels": n_labels, "knn": n_knn}
        for x in launches.values():
            counts["propagate_labels"] += x["propagate_labels"]
            counts["knn"] += x["knn"]
        steady_calls[(L,) + (cfg.rig.models[0].n_rings, cfg.rig.models[0].n_cols)] = n - ws
        check_trajectory(f"batch_fe_path, {name}", batched, n, gate=name == "dual")
        dt = float(np.abs(batched["est_t"] - ref["est_t"]).max())
        dq = float(np.abs(batched["est_q"] - ref["est_q"]).max())
        hopper_labels.propagate_labels = rec_labels
        try:
            frontend = frontend_difference(cfg, ext, seed)
        finally:
            hopper_labels.propagate_labels = real_labels
        runs[name] = {
            "frames": n, "lidars": L, "steady_sweeps": n - ws,
            "ate_m": batched["ate_m"], "ate_m_unrolled": ref["ate_m"],
            "max_abs_pose_t_diff_m": dt, "max_abs_pose_q_diff": dq,
            "steady_ms_median": batched["steady_ms_median"],
            "steady_ms_median_unrolled": ref["steady_ms_median"],
            "launches": launches, "frontend": frontend, "width": width(cfg)}
        if not dt <= BATCH_POSE_GATE_M:
            fail(f"batch_fe_path, {name}: poses {dt} m from the unrolled run "
                 f"(gate {BATCH_POSE_GATE_M} m)")
    emit({"batch_fe_path": runs})

    # K1 over each captured batch, and a random one, against the plain
    # version at every slot; timed beside B single calls
    cases = {f"batch_fe_{'x'.join(map(str, k))}": v for k, v in sorted(captured.items())}
    if set(captured) != set(steady_calls):
        fail(f"batch_fe_path: batched label calls at {sorted(captured)}, expected "
             f"{sorted(steady_calls)}")
    rand = [random_label_case(16, 1800, 100 + i) for i in range(3)]
    cases["random_3x16x1800"] = tuple(torch.stack(x) for x in zip(*rand)) + (3,)
    checks, timings = [], []
    for name, (lab, ch, cv, rounds) in cases.items():
        checks += check_labels(name, (lab, ch, cv), (rounds,))
        t = batched_label_timing(name, (lab, ch, cv), rounds)
        t["launches"] = steady_calls.get(tuple(lab.shape), 0)
        timings.append(t)
    emit({"kernel_checks": {"labels_batched": checks}})
    return counts, {"max_abs_err": max(c["max_abs_err"] for c in checks), "shapes": timings}


# --------------------------------------------------------------------------
# the mapping paths
# --------------------------------------------------------------------------

def _median(xs):
    return float(np.median(xs)) if len(xs) else None


def phase_map_path(name, cfg, n_frames, extrinsics=None):
    """``FullPipeline`` through ``run_synthetic.run(mapping=True)``. After
    every sweep the launch counters and the staleness reads are checked: the
    odometry's K1 and K2 launches, plus 2 k-NN launches per outer iteration
    on every mapped sweep once the map holds a keyframe (the first mapped
    sweep passes through), and one staleness read per mapped sweep. The
    mapper's two k-NN calls of the first outer iteration of the first mapped
    sweep that matched against a rebuilt surround map, and of the last (the
    fullest map), are kept, to be held against the plain version after the
    run."""
    L = cfg.rig.n_lidars
    ws = cfg.odometry.window_size
    mc = cfg.mapping
    map_sizes = (mc.cap_map_corner, mc.cap_map_surf)
    seen = {"labels": 0, "knn": 0, "reads": 0, "mapped": 0, "rebuilds": 0}
    captured, last, pending, surround = [], [], [], []
    real_knn = hopper_knn.knn

    def rec_knn(q, r, m, k):
        if r.shape[0] in map_sizes and len(pending) < 2:
            pending.append((q.clone(), r.clone(), m.clone(), k))
        return real_knn(q, r, m, k)

    def on_sweep(i, out, pipe):
        d_l = hopper_labels.launches - seen["labels"]
        d_k = hopper_knn.launches - seen["knn"]
        d_r = MP.stale_reads - seen["reads"]
        want_l, want_k = labels_per_sweep(i, 0, cfg), knn_per_sweep(i, 0, L, ws)
        if out.mapped:
            want_k += 2 * mc.outer_iters if seen["mapped"] > 0 else 0
            seen["mapped"] += 1
        if d_l != want_l or d_k != want_k or d_r != int(out.mapped):
            fail(f"{name}, sweep {i}: labels {d_l} (expected {want_l}), knn {d_k} "
                 f"(expected {want_k}), staleness reads {d_r} "
                 f"(expected {int(out.mapped)})")
        rebuilt = len(timing._registry.get("map_step_rebuild", [])) > seen["rebuilds"]
        seen["rebuilds"] = len(timing._registry.get("map_step_rebuild", []))
        if out.mapped:
            c = pipe.mapper_state.cache
            surround.append({"sweep": i, "rebuilt": rebuilt,
                             "corner": int(c.c_mask.sum()), "surf": int(c.s_mask.sum())})
        if len(pending) == 2 and out.mapped and rebuilt and seen["mapped"] > 1:
            if not captured:
                captured.extend(pending)
            last[:] = pending
        pending.clear()
        seen.update(labels=hopper_labels.launches, knn=hopper_knn.launches,
                    reads=MP.stale_reads, pipe=pipe)

    zero_counters()
    reads0 = MP.stale_reads
    seen["reads"] = reads0
    hopper_knn.knn = rec_knn
    try:
        res = run_synthetic.run(n_frames=n_frames, seed=0, verbose=False, device=DEV,
                                cfg=cfg, extrinsics=extrinsics, mapping=True,
                                on_sweep=on_sweep)
    finally:
        hopper_knn.knn = real_knn
    n_labels, n_knn = hopper_labels.launches, hopper_knn.launches
    n_reads = MP.stale_reads - reads0
    mapped = res["mapped"]
    n_mapped = sum(mapped)
    check_counters(name, n_labels, n_knn, expected_labels(res["modes"], cfg, 0),
                   expected_knn(res["modes"], L, ws, 0)
                   + 2 * mc.outer_iters * max(n_mapped - 1, 0))
    if n_reads != n_mapped:
        fail(f"{name}: {n_reads} staleness reads for {n_mapped} mapped sweeps")
    path_m = check_trajectory(name, res, n_frames)
    if not np.isfinite(res["map_est_t"]).all():
        fail(f"{name}: map-frame trajectory holds non-finite poses")
    if not res["map_ate_m"] < ATE_GATE_M:
        fail(f"{name}: map ATE {res['map_ate_m']:.4f} m is not under the {ATE_GATE_M} m gate")
    db = seen["pipe"].mapper_state.db
    valid = db.valid.cpu().numpy()
    n_kf = int(valid.sum())
    if n_kf < 2:
        fail(f"{name}: only {n_kf} keyframe(s) inserted")
    eig_min = float(np.linalg.eigvalsh(db.cov.cpu().numpy()[valid]).min())
    if eig_min <= -1e-6:
        fail(f"{name}: a keyframe covariance is not PSD (eigenvalue {eig_min})")
    out_mask = db.outlier.mask.cpu().numpy()[valid]
    out_xyz = db.outlier.xyz.cpu().numpy()[valid][out_mask]
    if not out_mask.any() or not np.isfinite(out_xyz).all():
        fail(f"{name}: the keyframes' outlier channel is empty or not finite")
    if len(captured) != 2 or len(last) != 2:
        fail(f"{name}: no mapped sweep matched against a rebuilt surround map")
    sync_points = map_step_sync_points(seen["pipe"], cfg)
    probe_ms = map_step_probe_ms(seen["pipe"], cfg)
    sweep_ms = np.asarray(res["sweep_ms"])
    mapped_a = np.asarray(mapped)
    steady = np.arange(n_frames) > ws
    steps = {k: np.asarray(timing._registry.get(f"map_step_{k}", [])) * 1e3
             for k in ("rebuild", "reuse")}
    emit({name: {
        "frames": n_frames, "lidars": L, "map_ate_m": res["map_ate_m"],
        "odom_ate_m": res["ate_m"], "path_m": path_m,
        "mapped_sweeps": n_mapped, "keyframes": n_kf,
        "keyframe_cov_eig_min": eig_min,
        "outlier_points_in_keyframes": int(out_mask.sum()),
        "mapped_sweep_ms_median": _median(sweep_ms[mapped_a & steady]),
        "passthrough_sweep_ms_median": _median(sweep_ms[~mapped_a & steady]),
        "map_step_ms_median": {k: _median(v) for k, v in steps.items()},
        "map_steps": {k: len(v) for k, v in steps.items()},
        "map_step_ms_from_final_state": probe_ms,
        "stale_reads": n_reads,
        "map_step_sync_points": sync_points,
        "surround_valid_points": surround,
        "ext_cov_prior_diag": cfg.mapping.ext_cov_prior_diag,
        "launches": {"propagate_labels": n_labels, "knn": n_knn},
        "width": width(cfg),
    }})
    return {"propagate_labels": n_labels, "knn": n_knn}, captured + last


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    return x


def _probe_state(pipe, kind):
    """A copy of the pipeline's mapper state whose next step (at the
    pipeline's current pose) reuses or rebuilds the surround map."""
    st = _clone(pipe.mapper_state)
    if kind == "rebuild":
        return st._replace(cache=st.cache._replace(valid=torch.zeros_like(st.cache.valid)))
    pred = se3.compose(st.pose_map_odom, pipe.odom.world_pose)
    return st._replace(cache=st.cache._replace(center=pred.t.clone(),
                                               head=st.db.head.clone()))


def map_step_probe_ms(pipe, cfg, reps=3):
    """Median ms of the mapper step from the final state, reusing and
    rebuilding the surround map (each on a fresh copy; device synchronised
    around each step): a path whose every mapped sweep inserts a keyframe
    never reuses its map."""
    corner, surf = pipe.last_merged
    out = {}
    for kind in ("reuse", "rebuild"):
        ts = []
        for _ in range(reps):
            st = _probe_state(pipe, kind)
            torch.cuda.synchronize()
            t = time.perf_counter()
            MP.mapper_step(st, pipe.odom.world_pose, corner, surf, cfg)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        out[kind] = float(np.median(ts))
    return out


def map_step_sync_points(pipe, cfg):
    """One more mapper step, on a copy of the final state with the last
    mapped sweep's clouds, under the sync probe (``SyncProbe``), once
    reusing the cached surround map and once rebuilding it: the step may
    wait only at its one staleness read and at ``eigh`` (which synchronises
    to check its solver status)."""
    corner, surf = pipe.last_merged
    pose = pipe.odom.world_pose
    probe = SyncProbe()
    for kind in ("reuse", "rebuild"):
        st = _probe_state(pipe, kind)
        torch.cuda.synchronize()
        _, mout = probe.run(kind, lambda: MP.mapper_step(st, pose, corner, surf, cfg))
        if mout.stale != (kind == "rebuild"):
            fail(f"sync probe: the {kind} step took the other branch")
    return probe.check("the mapper step")


def map_knn_checks(prefix, captured):
    """Hold the mapper's captured k-NN calls (edge, then plane; the first
    rebuilt map's, then the last's) against the plain version and time
    them."""
    checks, shapes = [], []
    kinds = ("map_edge", "map_plane", "map_edge_last", "map_plane_last")
    for kind, (q, r, m, k) in zip(kinds, captured):
        name = f"{prefix}{kind}"
        chk = check_knn(name, q, r, m, k)
        if not chk["all_slots_equal"]:
            fail(f"knn {name}: indices differ from the plain version at "
                 f"{chk['slots_differing']} slots, {chk['slots_differing_beyond_1ulp']} "
                 "of them between references further apart than 1 ulp")
        checks.append(chk)
        shapes.append(knn_timing(name, q, r, m, k, chk))
    return checks, shapes


# --------------------------------------------------------------------------
# the tuned operating point
# --------------------------------------------------------------------------

class SweepCounter:
    """Launch counters checked after every sweep: ``want(i, out, pipe)``
    gives the (K1, K2) launches sweep ``i`` must make."""

    def __init__(self, name, want):
        self.name, self.want = name, want
        self.seen = {"labels": 0, "knn": 0}

    def __call__(self, i, out, pipe):
        d_l = hopper_labels.launches - self.seen["labels"]
        d_k = hopper_knn.launches - self.seen["knn"]
        w_l, w_k = self.want(i, out, pipe)
        if (d_l, d_k) != (w_l, w_k):
            fail(f"{self.name}, sweep {i}: labels {d_l} (expected {w_l}), knn {d_k} "
                 f"(expected {w_k})")
        self.seen.update(labels=hopper_labels.launches, knn=hopper_knn.launches)


def phase_tuned_path(name, cfg, n_frames, extrinsics=None):
    """``realtime_tuned`` through ``run_synthetic.run``; counters after every
    sweep. The first steady sweep's label-propagation input is kept, to be
    held against the plain version at the path's rounds and at 8."""
    L = cfg.rig.n_lidars
    ws = cfg.odometry.window_size
    captured = []
    real_labels = hopper_labels.propagate_labels

    def rec_labels(labels, ch, cv, rounds=3):
        if not captured:
            captured.append((labels.clone(), ch.clone(), cv.clone(), rounds))
        return real_labels(labels, ch, cv, rounds)

    counter = SweepCounter(name, lambda i, out, pipe: (labels_per_sweep(i, 0, cfg),
                                                       knn_per_sweep(i, 0, L, ws)))

    def on_sweep(i, out, pipe):
        counter(i, out, pipe)
        hopper_labels.propagate_labels = rec_labels if i + 1 == ws + 1 else real_labels

    zero_counters()
    try:
        res = run_synthetic.run(n_frames=n_frames, seed=0, verbose=False, device=DEV,
                                cfg=cfg, extrinsics=extrinsics, on_sweep=on_sweep)
    finally:
        hopper_labels.propagate_labels = real_labels
    n_labels, n_knn = hopper_labels.launches, hopper_knn.launches
    check_counters(name, n_labels, n_knn, expected_labels(res["modes"], cfg, 0),
                   expected_knn(res["modes"], L, ws, 0))
    path_m = check_trajectory(name, res, n_frames)
    oc = cfg.odometry
    emit({name: {
        "frames": n_frames, "lidars": L, "ate_m": res["ate_m"], "path_m": path_m,
        "steady_ms_median": res["steady_ms_median"], "steady_fps": res["fps"],
        "operating_point": {"window_gn_iters": oc.gn_iters, "gf_ratio": oc.gf_ratio,
                            "gf_method": oc.gf_method, "gf_compact": oc.gf_compact,
                            "tracker_gn_iters": cfg.tracker.gn_iters,
                            "label_iters": cfg.segmenter.label_iters,
                            "label_rounds": captured[0][3] if captured else None,
                            "localmap_precaps": [oc.localmap_precap_corner,
                                                 oc.localmap_precap_surf]},
        "launches": {"propagate_labels": n_labels, "knn": n_knn},
        "width": width(cfg),
    }})
    if not captured:
        fail(f"{name}: no label-propagation call captured")
    return {"propagate_labels": n_labels, "knn": n_knn}, captured[0], res


# --------------------------------------------------------------------------
# the slam paths
# --------------------------------------------------------------------------

class SyncProbe:
    """CUDA's sync debug mode over the calls it runs: every place the host
    waited for the device, by the innermost line of the package's own code,
    counted per kind of call. A wait inside ``SlamPipeline._accept_loop`` (a
    verified loop: the correction read and the optimization) is kept under
    that name. A wait at any other line of the package than the mapper's
    staleness read and ``eigh`` fails the run; one that surfaces outside
    the package's frames (a warning raised in a C++ call that let go of the
    interpreter is reported at the next Python line that runs) is listed
    as such. The pipelined flags' event waits are not device
    synchronisations and are counted by the pipeline itself
    (``pipeline.waits``)."""

    ALLOWED = ("eigh", "eigvalsh", "stale = bool(")

    def __init__(self):
        self.lines = {}
        self.bad = []

    def run(self, kind, fn):
        stacks = []

        def record(message, category, filename, lineno, file=None, line=None):
            if "synchroniz" in str(message).lower():
                stacks.append(traceback.extract_stack()[:-1])

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts = self.lines.setdefault(kind, collections.Counter())
        for stack in stacks:
            # the frames under this probe's own call of ``fn``
            mine = [k for k, f in enumerate(stack)
                    if pathlib.Path(f.filename).name == pathlib.Path(__file__).name]
            stack = stack[mine[-1] + 1:] if mine else stack
            own = [f for f in stack if f"{os.sep}mloam_tpu_torch{os.sep}" in f.filename]
            accept = any(f.name == "_accept_loop" for f in stack)
            f = own[-1] if own else (stack[-1] if stack else None)
            if f is None:
                counts["outside the package: after the probed call"] += 1
                continue
            where = ("accept_loop: " if accept else "") + ("" if own else "outside the package: ")
            key = f"{where}{pathlib.Path(f.filename).name}:{f.lineno}: {f.line}"
            counts[key] += 1
            if own and not accept and not any(a in key for a in self.ALLOWED):
                self.bad.append(key)
        return out

    def check(self, name):
        if self.bad:
            fail(f"{name}: the host waited for the device outside the staleness "
                 f"read, eigh and a verified loop: {sorted(set(self.bad))}")
        return {k: dict(v) for k, v in self.lines.items()}


def phase_slam_path(name, course_name, base_cfg, probe_from=0, gate_loops=True, frames=None):
    """``SlamPipeline`` through ``run_synthetic.run(slam=True)`` on the loop
    course ``course_name`` built on ``base_cfg``. After every
    sweep: K1 once per lidar (``labels_per_sweep``); K2 the odometry's, the mapper's (2 per outer
    iteration on mapped sweeps once the map holds a keyframe) and 12 per
    detection submitted in the sweep (two fine registrations of three outer
    iterations, an edge and a plane call each). The 12 k-NN inputs of the
    first detection are kept, and every call of the correlation
    registration is counted. Sweeps from ``probe_from`` on run under the
    sync probe."""
    cfg, n_frames, seed, course = run_synthetic.loop_course(course_name, base_cfg)
    n_frames = frames or n_frames
    L = cfg.rig.n_lidars
    ws = cfg.odometry.window_size
    mc = cfg.mapping
    per_detect = 12 if cfg.loop.use_global_registration else 6
    seen = {"mapped": 0, "detections": 0}
    det_calls, in_detection = [], []
    corr_calls = [0]
    real = {"knn": hopper_knn.knn, "try": PGraph.try_close_loop,
            "corr": GREG.register_correlation}

    def rec_knn(q, r, m, k):
        if in_detection and len(det_calls) < per_detect:
            det_calls.append((q.clone(), r.clone(), m.clone(), k))
        return real["knn"](q, r, m, k)

    def rec_try(*a, **kw):
        first = not det_calls
        if first:
            in_detection.append(True)
        try:
            return real["try"](*a, **kw)
        finally:
            in_detection.clear()

    def rec_corr(*a, **kw):
        corr_calls[0] += 1
        return real["corr"](*a, **kw)

    def want(i, out, pipe):
        k = knn_per_sweep(i, 0, L, ws)
        if out.full.mapped:
            k += 2 * mc.outer_iters if seen["mapped"] > 0 else 0
            seen["mapped"] += 1
        new = pipe.n_detections - seen["detections"]
        seen["detections"] = pipe.n_detections
        return L, k + per_detect * new

    counter = SweepCounter(name, want)
    probe = SyncProbe()
    pipes = []
    frozen = FrozenSum()

    def on_sweep(i, out, pipe):
        counter(i, out, pipe)
        frozen(i, out, pipe)
        pipes[:] = [pipe]
        if i + 1 >= probe_from and "probed" not in pipe.__dict__:
            real_process = type(pipe).process

            def probed(frames, _pipe=pipe):
                kind = ("detection_drained" if _pipe._pending_verify is not None
                        else "kf_flag_drained" if _pipe._pending_kf is not None else "other")
                return probe.run(kind, lambda: real_process(_pipe, frames))
            pipe.process = probed
            pipe.__dict__["probed"] = True

    zero_counters()
    waits0 = collections.Counter(PIPE.waits)
    reads0 = MP.stale_reads
    hopper_knn.knn, PGraph.try_close_loop, GREG.register_correlation = rec_knn, rec_try, rec_corr
    try:
        res = run_synthetic.run(n_frames=n_frames, seed=seed, verbose=False, device=DEV,
                                cfg=cfg, slam=True, on_sweep=on_sweep, **course)
    finally:
        hopper_knn.knn, PGraph.try_close_loop, GREG.register_correlation = (
            real["knn"], real["try"], real["corr"])
    pipe = pipes[0]
    n_labels, n_knn = hopper_labels.launches, hopper_knn.launches
    n_mapped = sum(res["mapped"])
    # the end-of-run flush may submit one more detection after the last sweep
    check_counters(name, n_labels, n_knn, expected_labels(res["modes"], cfg, 0),
                   expected_knn(res["modes"], L, ws, 0)
                   + 2 * mc.outer_iters * max(n_mapped - 1, 0)
                   + per_detect * pipe.n_detections)
    sync = probe.check(name)
    waits = {k: PIPE.waits[k] - waits0.get(k, 0) for k in PIPE.waits}
    ls = pipe.loop_state
    lv = ls.loop_valid.cpu().numpy()
    li, lj = ls.loop_i.cpu().numpy()[lv], ls.loop_j.cpu().numpy()[lv]
    # each loop edge against the truth of its two keyframes' sweeps
    edge_err = []
    kf_idx = res["kf_gt_idx"]
    for e, (a, b) in zip(np.flatnonzero(lv), zip(li, lj)):
        gq, gt_ = torch.from_numpy(res["gt_q"]), torch.from_numpy(res["gt_t"])
        z_gt = se3.relative(Pose(gq[kf_idx[a]], gt_[kf_idx[a]]), Pose(gq[kf_idx[b]], gt_[kf_idx[b]]))
        err = se3.boxminus(Pose(ls.loop_zq[e].cpu(), ls.loop_zt[e].cpu()), z_gt)
        edge_err.append({"edge": [int(a), int(b)], "trans_err_m": float(err[:3].norm()),
                         "rot_err_rad": float(err[3:].norm()),
                         "truth_dist_m": float(z_gt.t.norm()),
                         "query_points": [int(ls.surf.mask[b].sum()),
                                          int(ls.corner.mask[b].sum())]})
    check_trajectory(name, res, n_frames, gate=False)
    finite = (np.isfinite(res["map_est_t"]).all() and np.isfinite(res["kf_corr_t"]).all()
              and np.isfinite(res["kf_corr_q"]).all() and np.isfinite(res["kf_odom_t"]).all())
    if not finite:
        fail(f"{name}: non-finite map or keyframe poses")
    n_kf = len(res["kf_gt_idx"])
    if n_kf < 2:
        fail(f"{name}: only {n_kf} keyframe(s) entered the loop graph")
    if int(lv.sum()) != res["n_loops"]:
        fail(f"{name}: {int(lv.sum())} loop edges recorded for {res['n_loops']} loops")
    if res["n_detections"] and corr_calls[0] == 0 and cfg.loop.use_global_registration:
        fail(f"{name}: the correlation registration never ran")
    if waits.get("loop_correction_read", 0) != res["n_loops"] and cfg.loop.temporal_consistency_n == 1:
        fail(f"{name}: {waits.get('loop_correction_read', 0)} correction reads for "
             f"{res['n_loops']} loops")
    by_kind = res["sweep_ms_by_kind"]
    steady = [(i, k, t) for i, (k, t) in enumerate(zip(res["sweep_kinds"], res["sweep_ms"]))]
    unprobed = [x for x in steady if DRIFT_WARM <= x[0] < probe_from] if probe_from else []

    def pct(xs, q):
        return float(np.percentile(xs, q)) if len(xs) else None

    kf_unprobed = [t for _, k, t in unprobed if k == "keyframe"]
    win_frozen, map_frozen = frozen.totals()
    out = {
        "frames": n_frames, "lidars": L, "world_seed": seed, "course": course,
        "loop_capacity": cfg.loop.capacity,
        "map_ate_m": res["map_ate_m"], "odom_ate_m": res["ate_m"],
        "keyframes": n_kf, "n_loops": res["n_loops"], "n_detections": res["n_detections"],
        "loop_edges": [[int(a), int(b)] for a, b in zip(li, lj)],
        "loop_edge_err_vs_truth": edge_err,
        "kf_ate_odom_m": res["kf_ate_odom_m"], "kf_ate_corr_m": res["kf_ate_corr_m"],
        "register_correlation_calls": corr_calls[0],
        "win_frozen_sum": win_frozen, "map_frozen_sum": map_frozen,
        "sweep_ms_median_by_kind": {k: _median(v) for k, v in by_kind.items()},
        "sweeps_by_kind": {k: len(v) for k, v in by_kind.items()},
        "host_waits_by_kind": waits,
        "sync_probe_from_sweep": probe_from,
        "sync_points_by_sweep_kind": sync,
        "stale_reads": MP.stale_reads - reads0,
        "launches": {"propagate_labels": n_labels, "knn": n_knn},
        "width": width(cfg),
    }
    if probe_from:
        out.update(unprobed_sweeps=[DRIFT_WARM, probe_from],
                   kf_sweep_ms_p50=pct(kf_unprobed, 50), kf_sweep_ms_p95=pct(kf_unprobed, 95),
                   kf_sweeps_unprobed=len(kf_unprobed),
                   all_sweep_ms_p50_unprobed=pct([t for *_, t in unprobed], 50))
    emit({name: out})
    if gate_loops and (win_frozen != 0 or map_frozen != 0):
        # the disarmed default stays silent on the turning floor course, window
        # and mapper (tests/test_degeneracy_e2e.py:162-194)
        fail(f"{name}: the remap froze {win_frozen} window and {map_frozen} "
             "mapper directions on an observed course")
    if gate_loops:
        if res["n_loops"] < 1:
            fail(f"{name}: no loop closed")
        if (lj - li).min() < SLAM_MIN_LOOP_SPAN:
            fail(f"{name}: a loop edge spans fewer than {SLAM_MIN_LOOP_SPAN} keyframes: "
                 f"{list(zip(li.tolist(), lj.tolist()))}")
        if not res["kf_ate_corr_m"] <= SLAM_KF_ATE_RATIO * res["kf_ate_odom_m"]:
            fail(f"{name}: the optimization degraded the keyframes: "
                 f"{res['kf_ate_odom_m']:.4f} -> {res['kf_ate_corr_m']:.4f} m")
        if not res["map_ate_m"] < SLAM_MAP_ATE_GATE_M:
            fail(f"{name}: map ATE {res['map_ate_m']:.4f} m is not under {SLAM_MAP_ATE_GATE_M} m")
    if res["n_detections"] and len(det_calls) != per_detect:
        fail(f"{name}: the first detection made {len(det_calls)} k-NN calls, expected {per_detect}")
    return {"propagate_labels": n_labels, "knn": n_knn}, det_calls


def loop_knn_checks(captured):
    """Hold the first detection's 12 k-NN calls against the plain version at
    every slot; time the first registration's edge and plane calls."""
    checks, shapes = [], []
    for n, (q, r, m, k) in enumerate(captured):
        reg = "pose_seed" if n < 6 else "fft_seed"
        name = f"loop_reg_{reg}_outer{(n % 6) // 2}_{'plane' if n % 2 == 0 else 'edge'}"
        chk = check_knn(name, q, r, m, k)
        if not chk["all_slots_equal"]:
            fail(f"knn {name}: indices differ from the plain version at "
                 f"{chk['slots_differing']} slots, {chk['slots_differing_beyond_1ulp']} "
                 "of them between references further apart than 1 ulp")
        checks.append(chk)
        if n < 2:
            shapes.append(knn_timing(f"loop_reg_{'plane' if n % 2 == 0 else 'edge'}",
                                     q, r, m, k, chk))
    return checks, shapes


# --------------------------------------------------------------------------
# the degenerate corridor and the robust losses
# --------------------------------------------------------------------------

def drive_sequence(name, cfg, imgs, n, capture_at=None, probe_from=None):
    """``OdometryPipeline.process`` over ``n`` rendered sweeps of one lidar,
    the device synchronised around each (its ms kept), the launch counters
    checked after every sweep. Poses, frozen counts and the remap gate's
    spectra stay on the device until the run ends. With ``capture_at`` the
    k-NN and label-propagation inputs of that sweep are kept. With
    ``probe_from`` the sweeps from there on run under a ``SyncProbe`` (any
    host wait but ``eigh`` fails the run) and the steady median is taken
    over the sweeps before it."""
    ws = cfg.odometry.window_size
    skip = cfg.tracker.skip_steady
    counter = SweepCounter(name, lambda i, out, pipe: (1, knn_per_sweep(i, 0, 1, ws, skip)))
    knn_calls, label_calls = [], []
    real_knn, real_labels = hopper_knn.knn, hopper_labels.propagate_labels

    def rec_knn(q, r, m, k):
        knn_calls.append((q.clone(), r.clone(), m.clone(), k))
        return real_knn(q, r, m, k)

    def rec_labels(labels, ch, cv, rounds=3):
        label_calls.append((labels.clone(), ch.clone(), cv.clone(), rounds))
        return real_labels(labels, ch, cv, rounds)

    pipe = OdometryPipeline(cfg, device=DEV)
    probe = SyncProbe() if probe_from is not None else None
    est, frozen, e0, wdir, ms = [], [], [], [], []
    zero_counters()
    for i in range(n):
        frame = RangeImage(*(f[i] for f in imgs))
        if i == capture_at:
            hopper_knn.knn, hopper_labels.propagate_labels = rec_knn, rec_labels
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            if probe is not None and i >= probe_from:
                out = probe.run("sweep", lambda: pipe.process([frame]))
            else:
                out = pipe.process([frame])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        finally:
            hopper_knn.knn, hopper_labels.propagate_labels = real_knn, real_labels
        counter(i, out, pipe)
        est.append(out.pose.t)
        zero6 = torch.zeros(6, device=DEV)
        frozen.append(out.win_frozen.sum() if out.win_frozen is not None
                      else torch.zeros((), device=DEV))
        e0.append(out.win_eig_shared[0] if out.win_eig_shared is not None
                  else torch.zeros((), device=DEV))
        wdir.append(out.win_weak_dir if out.win_weak_dir is not None else zero6)
    launches = {"propagate_labels": hopper_labels.launches, "knn": hopper_knn.launches}
    check_counters(name, launches["propagate_labels"], launches["knn"], n,
                   sum(knn_per_sweep(i, 0, 1, ws, skip) for i in range(n)))
    sync = probe.check(name) if probe is not None else None
    return {"est_t": torch.stack(est).cpu().numpy(),
            "frozen": torch.stack(frozen).cpu().numpy().tolist(),
            "e0": torch.stack(e0).cpu().numpy().tolist(),
            "weak_axis": torch.stack(wdir).abs().argmax(-1).cpu().numpy().tolist(),
            "ms": ms, "steady_ms_median": _median(ms[ws + 1:probe_from]),
            "sync_points": sync,
            "launches": launches, "knn_calls": knn_calls, "label_calls": label_calls}


def corridor_config():
    """``indoor_degenerate(synthetic(1))`` at a 20 m range, the tracker
    skipped on the steady path (tests/test_degeneracy_e2e.py:55-77)."""
    cfg = platforms.synthetic(n_lidars=1)
    model = cfg.rig.models[0]._replace(max_range=20.0)
    cfg = dataclasses.replace(cfg, rig=dataclasses.replace(cfg.rig, models=(model,)),
                              tracker=dataclasses.replace(cfg.tracker, skip_steady=True))
    return platforms.indoor_degenerate(cfg)


def phase_corridor_path():
    """The tunnel course at full width, the remap armed (175) and disarmed
    (0), with the gates of tests/test_degeneracy_e2e.py:112-141: engaged on
    >= 90 % of the in-tunnel sweeps, the armed along-x error under half the
    disarmed one, |ey| under 0.8 m armed and 0.3 m disarmed, |ez| under
    1.0 m disarmed, all finite; the armed |ez| within
    ``CORRIDOR_EZ_MARGIN_M`` of the JAX package's on the same rendering.
    Whether the armed |ex| and |ez| pass 0.8 m is recorded. The armed run's sweeps from
    ``CORRIDOR_PROBE_FROM`` on run under the sync probe: a host wait other
    than ``eigh`` fails. The first steady sweep's k-NN and label inputs of
    the armed run are kept."""
    base = corridor_config()
    n = CORRIDOR_FRAMES
    mount = Pose(torch.tensor([1.0, 0.0, 0.0, 0.0], device=DEV),
                 torch.tensor([0.0, 0.0, 1.2], device=DEV))
    imgs, gt = W.render_sequence(
        W.make_corridor_world(wall_height=3.0, ceiling=True, device=DEV),
        W.make_straight_trajectory(speed=2.0, wobble=0.02, device=DEV),
        base.rig.models[0], n, extrinsic=mount, device=DEV, noise_std=0.01,
        noise_seed=1000, companions=torch.tensor([[5.0, 0.8, 0.12]]),
        companion_frames=(CORRIDOR_COMP_START, n), companion_period=(3, 10))
    sensor = se3.compose(gt, Pose(mount.q.expand(n, 4), mount.t.expand(n, 3)))
    g0 = se3.inverse(Pose(sensor.q[:1].expand(n, 4), sensor.t[:1].expand(n, 3)))
    gt_rel = se3.compose(g0, sensor).t.cpu().numpy()
    runs, counts, captured = {}, {}, None
    ws = base.odometry.window_size
    for label, thr in (("on", base.odometry.eig_threshold), ("off", 0.0)):
        cfg = dataclasses.replace(base, odometry=dataclasses.replace(
            base.odometry, eig_threshold=thr))
        r = drive_sequence(f"corridor_path_{label}", cfg, imgs, n,
                           capture_at=ws if label == "on" else None,
                           probe_from=CORRIDOR_PROBE_FROM if label == "on" else None)
        if label == "on":
            captured = (r["knn_calls"], r["label_calls"])
        r["err"] = r["est_t"] - gt_rel
        runs[label] = r
        counts[f"corridor_path_{label}"] = r["launches"]
    err_on, err_off = runs["on"]["err"], runs["off"]["err"]
    in_tunnel = runs["on"]["frozen"][CORRIDOR_COMP_START:]
    engaged = sum(1 for f in in_tunnel if f > 0)
    ex_on, ex_off = float(np.abs(err_on[:, 0]).max()), float(np.abs(err_off[:, 0]).max())
    env = {k: float(np.abs(e[:, c]).max()) for k, e, c in (
        ("ey_on", err_on, 1), ("ez_on", err_on, 2), ("ey_off", err_off, 1),
        ("ez_off", err_off, 2))}
    emit({"corridor_path": {
        "frames": n, "companion_from": CORRIDOR_COMP_START, "eig_threshold": base.odometry.eig_threshold,
        "engaged_in_tunnel": [engaged, len(in_tunnel)], "ex_on_m": ex_on, "ex_off_m": ex_off,
        "recorded_envelopes": {"ex_on_under_0.8": ex_on < 0.8, "ez_on_under_0.8": env["ez_on"] < 0.8},
        "jax_ez_on_same_rendering_m": JAX_CORRIDOR_EZ_ON_M,
        "ez_on_gate_m": JAX_CORRIDOR_EZ_ON_M + CORRIDOR_EZ_MARGIN_M,
        "sync_probe_from_sweep": CORRIDOR_PROBE_FROM,
        "sync_points_on": runs["on"]["sync_points"],
        **{f"{k}_m": v for k, v in env.items()},
        "steady_ms_median": {k: r["steady_ms_median"] for k, r in runs.items()},
        "frozen_per_sweep": {k: r["frozen"] for k, r in runs.items()},
        "weak_axis_per_sweep_on": runs["on"]["weak_axis"],
        "e0_per_sweep": {k: r["e0"] for k, r in runs.items()},
        "launches": counts, "width": width(base),
    }})
    if not (np.isfinite(err_on).all() and np.isfinite(err_off).all()):
        fail("corridor path: non-finite poses")
    if engaged < CORRIDOR_ENGAGED_SHARE * len(in_tunnel):
        fail(f"corridor path: the remap engaged on {engaged} of {len(in_tunnel)} "
             "in-tunnel sweeps")
    if not ex_on < 0.5 * ex_off:
        fail(f"corridor path: along-x error {ex_on:.3f} m armed against {ex_off:.3f} m "
             "disarmed (gate: under half)")
    if not (env["ey_on"] < 0.8 and env["ey_off"] < 0.3 and env["ez_off"] < 1.0):
        fail(f"corridor path: y / z errors out of bounds: {env}")
    if not env["ez_on"] < JAX_CORRIDOR_EZ_ON_M + CORRIDOR_EZ_MARGIN_M:
        fail(f"corridor path: armed |ez| {env['ez_on']:.3f} m against the JAX package's "
             f"{JAX_CORRIDOR_EZ_ON_M:.3f} m on this rendering (gate: within "
             f"{CORRIDOR_EZ_MARGIN_M} m)")
    return counts, captured


def corridor_kernel_checks(captured):
    """K1 and K2 on the corridor's first steady sweep: the label call (long
    walls connected across whole rows) and the window's two k-NN calls
    (regular geometry, 1 cm noise, near-ties), every slot against the plain
    versions, timed."""
    knn_calls, label_calls = captured
    if len(knn_calls) != 2 or len(label_calls) != 1:
        fail(f"corridor path: the first steady sweep made {len(knn_calls)} k-NN and "
             f"{len(label_calls)} label calls; expected 2 (no tracker) and 1")
    checks, shapes = [], []
    for name, (q, r, m, k) in zip(("corridor_window_edge", "corridor_window_plane"), knn_calls):
        chk = check_knn(name, q, r, m, k)
        if not chk["all_slots_equal"]:
            fail(f"knn {name}: indices differ from the plain version at "
                 f"{chk['slots_differing']} slots")
        checks.append(chk)
        shapes.append(knn_timing(name, q, r, m, k, chk))
    lab, ch, cv, rounds = label_calls[0]
    label_checks = check_labels("corridor_path", (lab, ch, cv), (rounds, 8))
    return checks, shapes, label_checks, label_timing("corridor_path", (lab, ch, cv), rounds)


def phase_robust_path():
    """tests/test_robust_e2e.py:25-92 on the port's world of seed 0 and
    trajectory of seed 1 (wobble 0.05), range noise 0.02 m: with three
    movers (``ROBUST_FRAMES`` sweeps) huber, gm and gnc_gm (c 0.12); without
    (``ROBUST_CLEAN_FRAMES``) huber and gnc_gm."""
    base = platforms.synthetic(n_lidars=1)
    model = base.rig.models[0]
    w = W.make_world(torch.Generator().manual_seed(0), device=DEV)
    traj = W.make_trajectory(torch.Generator().manual_seed(1), wobble=0.05, device=DEV)
    movers = tuple(torch.tensor(x) for x in ROBUST_MOVERS)
    ate, ms, counts = {}, {}, {}
    for scene, n, modes in (("movers", ROBUST_FRAMES, ("huber", "gm", "gnc_gm")),
                            ("clean", ROBUST_CLEAN_FRAMES, ("huber", "gnc_gm"))):
        imgs, gt = W.render_sequence(w, traj, model, n, device=DEV, noise_std=0.02,
                                     noise_seed=1000,
                                     movers=movers if scene == "movers" else None)
        gt_t = gt.t.cpu().numpy()
        for mode in modes:
            cfg = C.with_loss_mode(base, mode, gm_c=None if mode == "huber" else 0.12)
            name = f"robust_path_{scene}_{mode}"
            r = drive_sequence(name, cfg, imgs, n)
            if not np.isfinite(r["est_t"]).all():
                fail(f"{name}: non-finite poses")
            ate[f"{scene}_{mode}"] = evaluation.ate_rmse(r["est_t"], gt_t)
            ms[f"{scene}_{mode}"] = r["steady_ms_median"]
            counts[name] = r["launches"]
    emit({"robust_path": {"frames": {"movers": ROBUST_FRAMES, "clean": ROBUST_CLEAN_FRAMES},
                          "gm_c": 0.12, "ate_m": ate, "steady_ms_median": ms,
                          "launches": counts, "width": width(base)}})
    h, g, gnc = ate["movers_huber"], ate["movers_gm"], ate["movers_gnc_gm"]
    if not (g < 0.95 * h and h < 0.10 and gnc < h):
        fail(f"robust path, movers: ATE huber {h:.4f}, gm {g:.4f}, gnc_gm {gnc:.4f} m "
             "(gates: gm < 0.95 huber, huber < 0.10, gnc_gm < huber)")
    h, gnc = ate["clean_huber"], ate["clean_gnc_gm"]
    if not gnc < 1.15 * h + 0.002:
        fail(f"robust path, clean: ATE gnc_gm {gnc:.4f} m against huber {h:.4f} m "
             "(gate: < 1.15 huber + 2 mm)")
    return counts


# --------------------------------------------------------------------------
# repeatability, and the cost of the order-independent sums
# --------------------------------------------------------------------------

def _outputs_equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if a is None:
        return b is None
    return all(_outputs_equal(x, y) for x, y in zip(a, b))


def phase_repeat_check(cfg):
    """The map path's first ``REPEAT_FRAMES`` sweeps twice in one process
    from the same images: every odometry and map pose equal to the bit. The
    first run keeps the first input of each voxel filter (the frontend's centroid filter, the mapper's
    weighted one), each filter is called ``REPEAT_CALLS`` times on it and
    must give the same bits every time; and the inputs of the segment sums of
    its last sweep, each timed against ``index_add_`` on the same input (the
    cost per sweep of the repeatable sums)."""
    seqs, _ = run_synthetic.render_rig(cfg, REPEAT_FRAMES, seed=0, device=DEV)
    imgs = seqs[0]
    real = {"vd": voxel.voxel_downsample, "vc": voxel.voxel_downsample_with_cov,
            "sum": voxel.index_sum}
    captured = {"vd": [], "vc": [], "sum": []}
    last_sweep = []

    def wrap(key):
        def rec(*a, **kw):
            if key != "sum" and not captured[key] or key == "sum" and last_sweep:
                captured[key].append((_clone(a), _clone(kw)))
            return real[key](*a, **kw)
        return rec

    runs, last_mapped = [], None
    for run in range(2):
        pipe = FullPipeline(cfg, device=DEV)
        poses = []
        if run == 0:
            voxel.voxel_downsample, voxel.voxel_downsample_with_cov, voxel.index_sum = (
                wrap("vd"), wrap("vc"), wrap("sum"))
        try:
            for i in range(REPEAT_FRAMES):
                if run == 0 and i == REPEAT_FRAMES - 1:
                    last_sweep.append(True)
                out = pipe.process([RangeImage(*(f[i] for f in imgs))])
                poses.append((out.odom.pose.q, out.odom.pose.t, out.map_pose.q,
                              out.map_pose.t))
        finally:
            voxel.voxel_downsample, voxel.voxel_downsample_with_cov, voxel.index_sum = (
                real["vd"], real["vc"], real["sum"])
        if run == 0:
            last_mapped = bool(out.mapped)
        runs.append(poses)
    differing = [i for i, (a, b) in enumerate(zip(*runs)) if not _outputs_equal(a, b)]
    if not (captured["vd"] and captured["vc"] and captured["sum"]):
        fail("repeat check: a voxel filter or segment sum was not captured: "
             f"{ {k: len(v) for k, v in captured.items()} }")
    filters = {}
    for key, name in (("vd", "voxel_downsample"), ("vc", "voxel_downsample_with_cov")):
        a, kw = captured[key][0]
        want = real[key](*a, **kw)
        same = sum(_outputs_equal(real[key](*a, **kw), want) for _ in range(REPEAT_CALLS))
        filters[name] = {"calls": REPEAT_CALLS, "bit_equal": same, "points": int(a[0].shape[0])}
    sums = []
    for (values, index, n_out), _ in captured["sum"]:
        def old(values=values, index=index, n_out=n_out):
            return torch.zeros((n_out,) + values.shape[1:], device=DEV).index_add_(0, index, values)

        def new(values=values, index=index, n_out=n_out):
            return segsum.index_sum(values, index, n_out)
        sums.append({"rows": int(values.shape[0]), "columns": int(values[0].numel()),
                     "ms": time_ms(new), "index_add_ms": time_ms(old),
                     "graph_ms": graph_ms(new), "index_add_graph_ms": graph_ms(old)})
    per_sweep = {k: sum(s[k] for s in sums) for k in ("ms", "index_add_ms", "graph_ms",
                                                       "index_add_graph_ms")}
    emit({"repeat_check": {"frames": REPEAT_FRAMES, "sweeps_differing": differing,
                           "filters": filters, "last_sweep_mapped": last_mapped,
                           "segment_sums_last_sweep": sums,
                           "segment_sums_per_sweep": {**per_sweep, "calls": len(sums)}}})
    if differing:
        fail(f"repeat check: poses differ between two runs of one process at sweeps {differing}")
    bad = {k: v for k, v in filters.items() if v["bit_equal"] != REPEAT_CALLS}
    if bad:
        fail(f"repeat check: a voxel filter gave other bits on the same input: {bad}")


# --------------------------------------------------------------------------
# K3: the pose graph's band Cholesky
# --------------------------------------------------------------------------

def band_system(poses, edges):
    """(band, g, perm, dense H, order) of ``pgo_step``'s damped system at
    ``poses``, the band in the reverse Cuthill-McKee order, damped as the
    step damps it."""
    n = poses.q.shape[0]
    order = PG.edge_band_order(edges, n)
    pairs, sums, g, _ = PG._pair_sums(poses, edges)
    band = PG._band_from_pairs(pairs, sums, n, order)
    H = PG._dense_from_pairs(pairs, sums, n)
    for diag, at in ((band[:, 0], order.inv[0] * 6 + torch.arange(6, device=DEV)),
                     (H.diagonal(), torch.arange(6, device=DEV))):
        diag[at] += 1e3
        diag += 1e-3 * (diag + 1e-3)
        diag += 1e-8
    return band, g, order.perm, H, order


def band_bound_ms(n_rows, b):
    """The least time for a band factorisation and both substitutions:
    N (b^2 + 3 b) flop of the factorisation, 4 N b of the solves, at 67
    TFLOP/s, against the band read and written once and g, x read and
    written once at 3.35 TB/s."""
    flop = n_rows * (b * b + 3 * b) + 4 * n_rows * b
    nbytes = 2 * n_rows * (b + 1) * 4 + 3 * n_rows * 4
    t_ops, t_bytes = flop / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flop


def check_band_case(name, poses, edges):
    """K3 against its plain version (the same function through cuSOLVER's
    dense Cholesky, on the card) and against float64, two calls to the bit,
    and its times beside the bound and the dense ``cholesky_ex`` of the
    same H (``library_ms``, the path it replaces)."""
    band0, g, perm, H, order = band_system(poses, edges)
    n_rows, b = band0.shape[0], band0.shape[1] - 1
    before = BC.launches
    f1, f2 = band0.clone(), band0.clone()
    x1, i1 = BC.band_solve(f1, g, perm)
    x2, i2 = BC.band_solve(f2, g, perm)
    torch.cuda.synchronize()
    fp = band0.clone()
    xp, ip = BC.band_solve_plain(fp, g, perm)
    f64 = band0.double()
    x64, _ = BC.band_solve_plain(f64, g.double(), perm)

    def rel(a, ref):
        return float((a.double() - ref).abs().max() / ref.abs().max())

    bits = bool(torch.equal(x1, x2) and torch.equal(f1, f2) and torch.equal(i1, i2))
    out = {"name": name, "poses": int(poses.q.shape[0]), "rows": n_rows,
           "half_bandwidth": order.half_bandwidth, "b": b,
           "info": int(i1), "plain_info": int(ip),
           "x_max_abs_err": float((x1 - xp).abs().max()),
           "x_rel_err_vs_plain": rel(x1, xp.double()),
           "factor_max_abs_err": float((f1 - fp).abs().max()),
           "factor_rel_err_vs_plain": rel(f1, fp.double()),
           "x_rel_err_vs_f64": rel(x1, x64), "plain_x_rel_err_vs_f64": rel(xp, x64),
           "factor_rel_err_vs_f64": rel(f1, f64), "plain_factor_rel_err_vs_f64": rel(fp, f64),
           "two_calls_bit_equal": bits}
    del fp, f64
    ms = time_ms(lambda: BC.band_solve(band0.clone(), g, perm))
    g_ms = graph_ms(lambda: BC.band_solve(band0.clone(), g, perm))
    copy_ms = graph_ms(lambda: band0.clone())
    plain_ms = time_ms(lambda: BC.band_solve_plain(band0.clone(), g, perm), reps=5, warm=1)

    def library():
        L, _ = torch.linalg.cholesky_ex(H)
        return torch.cholesky_solve(g[:, None], L)

    library_ms = time_ms(library, reps=5, warm=1)
    bound, by, flop = band_bound_ms(n_rows, b)
    out.update(ms=ms, graph_ms=g_ms, clone_graph_ms=copy_ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound, bound_by=by, flop=flop,
               bound_share=bound / g_ms, launches=BC.launches - before)
    if int(i1) or int(ip):
        fail(f"band_chol {name}: a positive definite band gave info {int(i1)} / {int(ip)}")
    if not bits:
        fail(f"band_chol {name}: two calls gave other bits")
    # no further from float64 than cuSOLVER's float32 factorisation in the same order
    for key in ("x", "factor"):
        mine, plain = out[f"{key}_rel_err_vs_f64"], out[f"plain_{key}_rel_err_vs_f64"]
        if not mine <= max(4 * plain, 1e-6):
            fail(f"band_chol {name}: {key} {mine} from float64, the plain version {plain}")
    return out


def pgo_counts(since=None):
    """The direct pose-graph solves so far (on the band and dense, K3's
    launches, the last half-bandwidth); less ``since``'s counts if given."""
    now = {"band_steps": PG.band_steps, "dense_steps": PG.dense_steps,
           "band_launches": BC.launches}
    if since is not None:
        now = {k: v - since[k] for k, v in now.items()}
    return {**now, "last_half_bandwidth": PG.last_half_bandwidth}


def phase_band_chol(report):
    """K3 at the benchmark cell's shape (the 4541-pose KITTI 00 drive layout,
    half-bandwidth 17) and at the 600-pose ring; a band that is not positive
    definite gives info != 0 and ``pgo_step`` a NaN step; the launches
    counted; the kernel's registers and spills (``ptxas -v``) recorded."""
    fns = report.get("band_chol", {})
    if not fns:
        fail("band_chol: the ptxas report has no kernel")
    cases = [check_band_case("kitti00_drive",
                             *LADDER.drive_graph(4541, 640, 128, DEV, offset_max=8)),
             check_band_case("ring_600", *LADDER.ring_graph(PGO_POSES, DEV))]
    # not positive definite: a negative pivot at row 100, and NaN weights
    band, g, perm, _, _ = band_system(*LADDER.ring_graph(PGO_POSES, DEV))
    band[100, 0] = -1.0
    before = BC.launches
    x, info = BC.band_solve(band, g, perm)
    poses, edges = LADDER.ring_graph(PGO_POSES, DEV)
    w = edges.weight.clone()
    w[7] = float("nan")
    nan_step, _ = PG.pgo_step(poses, edges._replace(weight=w))
    launched = BC.launches - before
    non_pd = {"info": int(info), "nan_weight_step_all_nan": bool(torch.isnan(nan_step.t).all()),
              "launches": launched}
    emit({"kernel_checks": {"band_chol": cases, "band_chol_not_pd": non_pd,
                            "band_chol_ptxas": list(fns.values())}})
    if int(info) != 101:
        fail(f"band_chol: a negative pivot at row 100 gave info {int(info)}")
    if not non_pd["nan_weight_step_all_nan"] or launched != 2:
        fail(f"band_chol: a NaN weight did not give a NaN step through the kernel: {non_pd}")
    return cases


# --------------------------------------------------------------------------
# pose-graph checks
# --------------------------------------------------------------------------

def _timed_pgo(init, edges, solver):
    out, ms, _ = LADDER.timed_solve(init, edges, solver, 3)
    return out, ms


def phase_pgo_check():
    """The 600-pose ring by ``solver="auto"``, by conjugate gradients and by
    the dense Cholesky, on the card (cg and dense must agree to 1 mm); the
    auto solve repeated ``REPEAT_CALLS`` times must give the same bits; then
    the ladder: rings of ``PGO_LADDER`` poses (drifting as far in total as
    the 600-pose ring), dense and PCG timed in this one call, for the pose
    count where ``auto`` switches (``sharded_pgo.AUTO_DENSE_MAX_POSES``)."""
    init, edges = LADDER.ring_graph(PGO_POSES, DEV)
    out, times = {}, {}
    for solver in ("auto", "cg", "dense"):
        out[solver], times[solver] = _timed_pgo(init, edges, solver)
    dt, dq = LADDER.pose_diff(out["cg"], out["dense"])
    same = sum(_outputs_equal(tuple(PG.optimize_pose_graph(init, edges, iters=3)),
                              tuple(out["auto"])) for _ in range(REPEAT_CALLS))

    def cost(p):
        r, _ = PG._linearize_sparse(p, edges)
        return float(0.5 * (r * r).sum())

    auto = "cg" if PGO_POSES > PG.AUTO_DENSE_MAX_POSES else "dense"
    emit({"pgo_check": {"poses": PGO_POSES, "edges": int(edges.i.shape[0]), "iters": 3,
                        "cg_iters": PGO_POSES + PGO_POSES // 4, "auto_takes": auto,
                        "ms": {"auto": times["auto"], "cg": times["cg"], "dense": times["dense"]},
                        "max_abs_diff_t_m": dt, "max_abs_diff_q": dq,
                        "auto_solves_bit_equal": [same, REPEAT_CALLS],
                        "cost": {"init": cost(init), "cg": cost(out["cg"]),
                                 "dense": cost(out["dense"])}}})
    if not (np.isfinite(dt) and dt < PGO_GATE_M and dq < PGO_GATE_M):
        fail(f"pgo check: cg and dense differ by {dt} m / {dq} (gate {PGO_GATE_M})")
    if same != REPEAT_CALLS:
        fail(f"pgo check: {REPEAT_CALLS - same} of {REPEAT_CALLS} repeated solves gave other bits")

    ladder = []
    for n in PGO_LADDER:
        # once each (up to 1024 poses they ran in turns, dense, cg, cg,
        # dense, until the script's time was cut)
        r = LADDER.rung(n, 3, ("dense", "cg"), drift_total=PGO_POSES)
        if not r["finite"] or None in r["dense_ms"]:
            fail(f"pgo ladder, {n} poses: {r}")
        ladder.append(r)
    emit({"pgo_ladder": {"auto_dense_max_poses": PG.AUTO_DENSE_MAX_POSES, "rings": ladder}})
    return ladder


# --------------------------------------------------------------------------
# the distributed solvers, on stacked meshes and one NCCL rank
# --------------------------------------------------------------------------

def _sync_s(fn):
    """(result, seconds) of ``fn`` with the device synchronised around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _pose_err(p, gt):
    return float(torch.linalg.norm(p.t - gt.t, dim=1).mean())


def _max_dev(a, b):
    return max(float((a.t - b.t).abs().max()), float((a.q - b.q).abs().max()))


def _surround_db(cfg, seed=11):
    """The mapper's keyframe ring (``max_keyframes`` slots, its per-keyframe
    caps), filled: keyframes on a 30 m circle, surface clouds N(0, 10 m)
    in each body frame, pose covariances diag(1e-4 m², 1e-5 rad²)."""
    mc = cfg.mapping
    k = mc.max_keyframes
    db = KF.empty_db(k, cfg.odometry.cap_frame_corner, cfg.odometry.cap_frame_surf, device=DEV)
    g = torch.Generator(device=DEV).manual_seed(seed)
    ang = torch.arange(k, device=DEV) * (2 * math.pi / k)
    xi = torch.zeros((k, 6), device=DEV)
    xi[:, 0], xi[:, 1], xi[:, 5] = 30 * torch.cos(ang), 30 * torch.sin(ang), ang
    poses = se3.exp(xi)
    db.poses.q.copy_(poses.q)
    db.poses.t.copy_(xi[:, :3])
    db.cov.copy_(torch.diag(torch.tensor([1e-4] * 3 + [1e-5] * 3, device=DEV)).expand(k, 6, 6))
    db.surf.xyz.copy_(10.0 * torch.randn(db.surf.xyz.shape, generator=g, device=DEV))
    db.surf.mask.fill_(True)
    db.valid.fill_(True)
    return db._replace(head=torch.tensor(k, dtype=torch.int32, device=DEV))


def _surround_reference(db, center, radius, ext_cov, cov_meas):
    """The one-device surround map, built apart from ``sharded_map``: every
    valid keyframe within ``radius`` of ``center`` (distances in float64 on
    the host), its surface points projected by its pose and their
    covariances pushed forward. Returns (xyz, cov, mask, keyframes)."""
    d = torch.linalg.norm(db.poses.t.cpu().double() - center.cpu().double(), dim=1)
    sel = torch.nonzero((d < radius) & db.valid.cpu())[:, 0].to(DEV)
    pose = Pose(db.poses.q[sel], db.poses.t[sel])
    xyz = db.surf.xyz[sel]
    cov = uncertainty.point_cov_pushforward(xyz, pose, db.cov[sel] + ext_cov, cov_meas)
    return se3.transform_points(pose, xyz), cov, db.surf.mask[sel], int(sel.numel())


def _point_set(xyz, cov, mask):
    """Masked points in lexicographic order, with their covariances."""
    x, c = xyz[mask].cpu().double().numpy(), cov[mask].cpu().double().numpy()
    order = np.lexsort(x.T)
    return x[order], c[order]


def check_scaling_report(model, legacy):
    """Print the scaling report's four rows and the PCG's legacy model, and
    hold them: partition, input bytes and collective bytes by fabric equal to
    the JAX record's (``SCALING_RECORD``), nothing across nodes on one node,
    every efficiency finite and in (0, 1]."""
    keys = ("efficiency_per_iter_measured", "efficiency_full_solve_measured")
    rows = {}
    for name, (part, input_bytes, intra, inter) in SCALING_RECORD.items():
        r = model[name]
        p = r["partition"]
        got = ((p["interior_per_shard"], p["intra_sep_per_host"], p["global_sep"],
                p["owned_sep_per_shard"]), r["input_bytes_per_device"],
               r["collectives_per_gn"]["intra"]["bytes"], r["collectives_per_gn"]["inter"]["bytes"])
        if got != (part, input_bytes, intra, inter):
            fail(f"scaling report {name}: {got} against the JAX record's "
                 f"{(part, input_bytes, intra, inter)}")
        effs = [r[k] for k in keys]
        if not all(math.isfinite(e) and 0.0 < e <= 1.0 for e in effs):
            fail(f"scaling report {name}: efficiencies {effs}")
        rows[name] = {k: r[k] for k in keys + (
            "measured_shard_ms_per_gn", "measured_sep_solve_ms_per_gn",
            "t_comm_intra_ms_per_gn", "t_comm_inter_ms_per_gn", "setup_bytes_assumed")}
        rows[name]["collectives_per_gn"] = r["collectives_per_gn"]
    for name in ("intra_8gpu", "inter_2node"):
        effs = [legacy[name][k] for k in keys]
        if not all(math.isfinite(e) and 0.0 < e <= 1.0 for e in effs):
            fail(f"scaling report, legacy PCG model {name}: efficiencies {effs}")
    emit({"scaling_report": {"model": model, "model_cg_legacy": legacy}})
    rows["fabric"] = model["intra_8gpu_ba"]["fabric"]
    return rows


def phase_parallel_path(tmp, ladder):
    """The distributed slice at full size, every gate of the JAX package's
    own checks (counters: no kernel of this path is launched):

    - the ``scaling`` program's measurement at 1024 poses: the DD solve (8
      GN iterations) on stacked 8 (1-D), 2x4 and 2x8 meshes within 1e-2 m
      of 8 dense steps and no worse than them + 5 mm; the edge-sharded PCG
      on 8 shards under half the initial error; the collectives per GN
      iteration; the card's ms of one shard's work and of the separator
      solve, bare and with the BA map; the scaling report's four rows (one
      node of 8 GPUs and two nodes of 8, with the BA map and without) and
      the PCG's legacy model, printed on a line of their own and held to the
      JAX record's partition, input bytes and collective bytes by fabric,
      exactly, with every efficiency finite and in (0, 1]. Then ``dof4`` on
      the 2x4 layout, gated alike;
    - the edge-sharded ``optimize_pose_graph(mesh=)`` on the 600-pose ring,
      dense and PCG, on 8 shards: within 1 mm of the one-device solve,
      ``MESH_PGO_CALLS`` calls equal to the bit (and whether they equal the
      one-device solve of the padded edges to the bit, recorded);
    - the distributed BA at the deployment shape, 1024 poses x 1024 scan
      points x 4096 candidate planes: 1-D and 2x4 layouts agree to 1e-4 m
      and the pose error falls; ms per GN iteration;
    - the sharded surround map of a filled 512-slot ring on 8 shards: the
      point set (1e-4 m) and covariances of the one-device truth, built
      apart (radius test, projection and pushforward of each keyframe);
    - the real-data programs (``models/realdata``) over a directory of
      files written from seeds in the reference's formats: ``bal_program``
      at the reference file's shape (25 LM iterations trivial, then huber,
      under the ratios of ``tests/test_realdata.py``; the 8-shard assembly
      against the dense one), ``curve_program`` and ``nonconvex_program``
      (the bounds of ``tests/test_realdata.py:31-60``);
    - the process form: one NCCL rank (``file://`` rendezvous, a timeout on
      the join and on every collective) gives the stacked 1-shard mesh's
      poses to the bit, DD and dense mesh PGO;
    - recorded only: the DD solve at 4096 poses (8 shards, 3 GN iterations)
      beside 3 dense ``pgo_step``s on the same survey graph, per GN step;
      and the ladder's dense and PCG times at 4096 (per solve of 3 GN steps,
      on the ring graph) of this run.
    """
    zero_counters()
    out = {}
    t_phase = time.perf_counter()

    # the scaling program: DD on three layouts, PCG on 8 shards
    scal = EXP.measure_scaling(DD_POSES, device=DEV)["summary"]
    emit({"scaling": {k: v for k, v in scal.items() if k not in ("model", "model_cg_legacy")}})
    out["scaling"] = {k: scal[k] for k in ("poses", "edges", "measured", "card_ms")}
    out["scaling_report"] = check_scaling_report(scal["model"], scal["model_cg_legacy"])
    poses0, edges, gt = SM.make_survey_graph(DD_POSES, noise=0.02, device=DEV)
    mesh24 = MESH.make_multihost_mesh(2, 4, device=DEV)
    ref4 = poses0
    for _ in range(8):
        ref4, _ = PG.pgo_step(ref4, edges, dof4=True)
    (o4, _), dt = _sync_s(lambda: DD.optimize_pose_graph_dd(poses0, edges, mesh24, iters=8,
                                                            dof4=True))
    dev4 = float((o4.t - ref4.t).abs().max())
    out["dof4_2x4"] = {"wall_s": dt, "err_m": _pose_err(o4, gt),
                       "dense_err_m": _pose_err(ref4, gt), "max_dev_from_dense_m": dev4}
    if not (dev4 < DD_GATE_M and _pose_err(o4, gt) < _pose_err(ref4, gt) + DD_ERR_MARGIN_M):
        fail(f"parallel_path: dof4 on 2x4: {out['dof4_2x4']}")

    # the edge-sharded PGO on the 600-pose ring
    init, ring = LADDER.ring_graph(PGO_POSES, DEV)
    mesh8 = MESH.make_mesh(MESH_SHARDS, device=DEV)
    out["mesh_pgo"] = {}
    for solver in ("dense", "cg"):
        one, t_one = _sync_s(lambda: PG.optimize_pose_graph(init, ring, iters=3, solver=solver))
        padded = PG.optimize_pose_graph(init, PG.pad_edges(ring, MESH_SHARDS), iters=3,
                                        solver=solver)
        mesh8.reset_counts()
        calls = [_sync_s(lambda: PG.optimize_pose_graph(init, ring, iters=3, mesh=mesh8,
                                                        solver=solver))
                 for _ in range(MESH_PGO_CALLS)]
        first = calls[0][0]
        same = sum(_outputs_equal(tuple(c[0]), tuple(first)) for c in calls)
        dt, dq = LADDER.pose_diff(first, one)
        out["mesh_pgo"][solver] = {
            "poses": PGO_POSES, "shards": MESH_SHARDS, "iters": 3,
            "one_device_s": t_one, "mesh_s": [c[1] for c in calls],
            "max_abs_diff_t_m": dt, "max_abs_diff_q": dq,
            "calls_bit_equal": [same, MESH_PGO_CALLS],
            "bit_equal_to_one_device_padded": _outputs_equal(tuple(first), tuple(padded)),
            "collectives_per_call": {k: {"calls": v["calls"] / MESH_PGO_CALLS,
                                         "bytes": v["bytes"] / MESH_PGO_CALLS}
                                     for k, v in mesh8.collectives.items()}}
        if not (np.isfinite(dt) and dt < PGO_GATE_M and dq < PGO_GATE_M):
            fail(f"parallel_path: mesh PGO {solver} against one device: {dt} m / {dq}")
        if same != MESH_PGO_CALLS:
            fail(f"parallel_path: mesh PGO {solver}: {MESH_PGO_CALLS - same} calls gave other bits")

    # the distributed BA at the deployment shape
    ms = SM.survey_ba_map(gt, BA_POINTS, BA_MAP)
    out["ba"] = {"poses": DD_POSES, "points": BA_POINTS, "map": BA_MAP, "iters": BA_ITERS,
                 "map_bytes": sum(x.numel() * x.element_size() for x in ms),
                 "err0_m": _pose_err(poses0, gt)}
    ba_out = {}
    for name, mesh in (("1d", mesh8), ("2x4", mesh24)):
        DD.optimize_pose_graph_dd(poses0, edges, mesh, iters=1, map_shard=ms,
                                  assoc_chunk=BA_ASSOC_CHUNK)
        (p, cost), dt = _sync_s(lambda: DD.optimize_pose_graph_dd(
            poses0, edges, mesh, iters=BA_ITERS, map_shard=ms, assoc_chunk=BA_ASSOC_CHUNK))
        ba_out[name] = p
        out["ba"][name] = {"ms_per_gn": 1e3 * dt / BA_ITERS, "err_m": _pose_err(p, gt),
                           "cost": float(cost)}
    out["ba"]["layouts_max_diff_m"] = _max_dev(ba_out["1d"], ba_out["2x4"])
    if not (out["ba"]["layouts_max_diff_m"] < BA_LAYOUT_GATE_M
            and out["ba"]["1d"]["err_m"] < 0.1 * out["ba"]["err0_m"]):
        fail(f"parallel_path: distributed BA: {out['ba']}")
    del ms, ba_out

    # the sharded surround map of the mapper's ring
    cfg = platforms.synthetic(n_lidars=1)
    db = _surround_db(cfg)
    center = db.poses.t[0].clone()
    radius = cfg.mapping.surround_radius
    k = cfg.mapping.max_keyframes
    ext = torch.zeros((6, 6), device=DEV)
    cov_meas = 1e-4 * torch.eye(3, device=DEV)
    (xs, cs, msk), dt_sh = _sync_s(lambda: SMAP.sharded_surround_map(
        SMAP.shard_db(db, mesh8), center, radius, k // MESH_SHARDS, ext, cov_meas, mesh8))
    (x1, c1, m1, n_kf), dt_one = _sync_s(lambda: _surround_reference(db, center, radius, ext,
                                                                     cov_meas))
    (ps, pc), (p1, q1) = _point_set(xs, cs, msk), _point_set(x1, c1, m1)
    same_n = ps.shape == p1.shape
    dx = float(np.abs(ps - p1).max()) if same_n else float("inf")
    dc = float(np.abs(pc - q1).max() / np.abs(q1).max()) if same_n else float("inf")
    out["surround_map"] = {"keyframes": k, "shards": MESH_SHARDS, "points": int(msk.sum()),
                           "keyframes_in_radius": n_kf, "one_device_points": int(m1.sum()),
                           "max_abs_diff_m": dx, "cov_max_rel_diff": dc,
                           "sharded_s": dt_sh, "one_device_s": dt_one}
    if not (same_n and m1.sum() > 0 and dx < SURROUND_GATE_M and dc < 1e-5):
        fail(f"parallel_path: sharded surround map: {out['surround_map']}")
    del db, xs, cs, msk, x1, c1, m1

    # the real-data programs, on files written from the seeds in the
    # reference's formats: BAL at the reference file's shape, the curve and
    # the quintic
    data = os.path.join(tmp, "realdata")
    os.makedirs(data)
    (cams, pts, ci, pi, obs), _ = RD.synthetic_bal(0, *BAL_SHAPE)
    BAL.write_bal(os.path.join(data, RD.BAL_FILE), cams, pts, ci, pi, obs)
    RD.write_xy(os.path.join(data, RD.CURVE_FILE), *RD.synthetic_curve(0))
    RD.write_xy(os.path.join(data, RD.NONCONVEX_FILE), *RD.synthetic_quintic(0))
    hist = {}
    bal, t_bal = _sync_s(lambda: RD.bal_program(data, mesh8, DEV, histories=hist))
    ht, hh = hist["trivial"], hist["huber"]
    out["bal"] = {**bal, "program_s": t_bal, "trivial_cost": [ht[0], ht[10], ht[-1]],
                  "huber_cost": [hh[0], hh[5], hh[-1]]}
    rel = bal["sharded_assembly_rel_err"]
    if not ((bal["cams"], bal["pts"], bal["obs"]) == BAL_SHAPE and bal["lm_iters"] == BAL_ITERS
            and ht[10] < ht[0] / BAL_TRIVIAL_RATIO and hh[5] < BAL_HUBER_RATIO * hh[0]
            and np.isfinite(ht[-1]) and max(rel) <= BAL_SHARDED_RTOL):
        fail(f"parallel_path: BAL: {out['bal']}")

    # robust fitting: the curve and the quintic programs
    t0 = time.perf_counter()
    curve = RD.curve_program(data, DEV)
    quintic = RD.nonconvex_program(data, DEV)
    out["fit_robust"] = {"curve": curve, "nonconvex": quintic,
                         "wall_s": time.perf_counter() - t0}
    fits = curve["fits"]
    ph, pgm, pg = (np.asarray([fits[k]["m"], fits[k]["c"]]) for k in ("huber", "gm", "gnc_gm"))
    qerr = [quintic["fits"][k]["max_coeff_err"] for k in ("huber", "gnc_gm")]
    if not (curve["n"] == 201 and quintic["n"] == 401
            and abs(ph[0] - 0.3) < 0.02 and abs(ph[1] - 0.1) < 0.05 and abs(pg[0] - 0.3) < 0.02
            and np.abs(pg - pgm).max() < 0.02 and max(qerr) < 0.3):
        fail(f"parallel_path: fit_robust: {out['fit_robust']}")

    # the process form: one NCCL rank against the stacked 1-shard mesh
    import torch.distributed as dist

    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'nccl_store')}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=NCCL_TIMEOUT_S))
    try:
        pm = MESH.make_process_mesh((1,), (MESH.FACTOR_AXIS,), device=DEV,
                                    timeout_s=NCCL_TIMEOUT_S)
        sm = MESH.make_mesh(1, device=DEV)
        res = {}
        for name, mesh in (("process", pm), ("stacked", sm)):
            res[name] = (DD.optimize_pose_graph_dd(poses0, edges, mesh, iters=3)[0],
                         PG.optimize_pose_graph(init, ring, iters=3, mesh=mesh, solver="dense"))
        equal = [_outputs_equal(tuple(a), tuple(b)) for a, b in zip(res["process"],
                                                                    res["stacked"])]
        out["nccl_one_rank"] = {"dd_equal": equal[0], "mesh_pgo_equal": equal[1],
                                "collectives": pm.collectives,
                                "seconds": time.perf_counter() - t0,
                                "note": "one rank: the machine has one GPU"}
    finally:
        dist.destroy_process_group()
    if not all(equal):
        fail(f"parallel_path: NCCL one rank against the stacked mesh: {out['nccl_one_rank']}")

    # recorded: the DD solve at 4096 poses beside this run's dense / PCG ladder
    p4, e4, g4 = SM.make_survey_graph(DD_LARGE_POSES, noise=0.02, device=DEV)
    DD.optimize_pose_graph_dd(p4, e4, mesh8, iters=1)
    (o, _), dt = _sync_s(lambda: DD.optimize_pose_graph_dd(p4, e4, mesh8,
                                                           iters=DD_LARGE_ITERS))
    PG.pgo_step(p4, e4)

    def dense_steps():
        p = p4
        for _ in range(DD_LARGE_ITERS):
            p, _ = PG.pgo_step(p, e4)
        return p

    od, dt_dense = _sync_s(dense_steps)
    rung = next((r for r in ladder if r["poses"] == DD_LARGE_POSES), None)
    out["dd_4096"] = {"shards": MESH_SHARDS, "gn_iters": DD_LARGE_ITERS,
                      "ms_per_gn": 1e3 * dt / DD_LARGE_ITERS, "err0_m": _pose_err(p4, g4),
                      "err_m": _pose_err(o, g4),
                      "dense_same_graph_ms_per_gn": 1e3 * dt_dense / DD_LARGE_ITERS,
                      "dense_same_graph_err_m": _pose_err(od, g4),
                      "max_dev_from_dense_m": float((o.t - od.t).abs().max()),
                      "ladder_4096_ring_ms_per_solve_of_3_gn": (
                          {"dense": rung["dense_ms"], "cg": rung["cg_ms"]} if rung else None)}
    if not (torch.isfinite(o.t).all() and torch.isfinite(od.t).all()):
        fail("parallel_path: the DD or the dense solve at 4096 poses is not finite")

    launches = {"propagate_labels": hopper_labels.launches, "knn": hopper_knn.launches}
    check_counters("parallel_path", launches["propagate_labels"], launches["knn"], 0, 0)
    out["seconds"] = round(time.perf_counter() - t_phase, 1)
    emit({"parallel_path": out})
    return launches


# --------------------------------------------------------------------------
# the deployment layer: ingest, resume, experiment programs
# --------------------------------------------------------------------------

class FullSweepCheck:
    """While active, every ``FullPipeline.process`` call (a ``SlamPipeline``'s
    too) has its launch counters checked: K1 once per lidar, once for a
    uniform rig's batch on a steady sweep; K2 none on a
    first-sweep branch (a fresh or a restored pipeline), else the odometry's
    (``knn_per_sweep``), plus 2 per outer iteration on a mapped sweep whose
    mapper already held a map. The checks are made on the counts the call
    itself added, so a ``SlamPipeline``'s detections, made after it, are
    left to the caller."""

    def __init__(self, name):
        self.name, self.sweeps, self.labels, self.knn = name, 0, 0, 0
        self.real = FullPipeline.process

    def __enter__(self):
        real, check = self.real, self

        def process(pipe, imgs):
            cfg = pipe.cfg
            i, first = pipe.odom.frame_idx, pipe.odom.prev_feats[0] is None
            mode = pipe.odom.ext_mode
            had_map = pipe.mapper_state.step > 0
            l0, k0 = hopper_labels.launches, hopper_knn.launches
            out = real(pipe, imgs)
            want_k = 0 if first else knn_per_sweep(i, mode, cfg.rig.n_lidars,
                                                   cfg.odometry.window_size)
            want_l = cfg.rig.n_lidars if first else labels_per_sweep(i, mode, cfg)
            if out.mapped and had_map:
                want_k += 2 * cfg.mapping.outer_iters
            d_l, d_k = hopper_labels.launches - l0, hopper_knn.launches - k0
            if (d_l, d_k) != (want_l, want_k):
                fail(f"{check.name}, sweep {i}: labels {d_l} (expected "
                     f"{want_l}), knn {d_k} (expected {want_k})")
            check.sweeps += 1
            check.labels += want_l
            check.knn += want_k
            return out

        FullPipeline.process = process
        return self

    def __exit__(self, *exc):
        FullPipeline.process = self.real


def _sweep_points(img):
    """The valid returns of a rendered sweep as [N, 4] float32 xyzi."""
    ok = img.valid.reshape(-1)
    return torch.cat([img.xyz.reshape(-1, 3)[ok], img.intensity.reshape(-1, 1)[ok]],
                     dim=1).cpu().numpy().astype(np.float32)


def _write_pcd_binary(path, pts):
    hdr = ("VERSION .7\nFIELDS x y z intensity\nSIZE 4 4 4 4\nTYPE F F F F\n"
           f"COUNT 1 1 1 1\nWIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
           f"POINTS {len(pts)}\nDATA binary\n")
    with open(path, "wb") as f:
        f.write(hdr.encode())
        f.write(np.ascontiguousarray(pts, np.float32).tobytes())


def live_stream(frames, period_s):
    """(stamp, frame) pairs of a sensor delivering one sweep every
    ``period_s`` from now on: a pair is handed out no earlier than its
    arrival."""
    start = time.monotonic()
    for i, f in enumerate(frames):
        wait = start + i * period_s - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        yield i * period_s, (i, f)


def phase_ingest_path(cfg, tmp):
    """Files and packets into the pipelines. Rendered sweeps are written as
    KITTI .bin files (four also as binary PCD); the C++ loader must read them
    back exactly and its packed ring must grid each to exactly the wire
    arrays of ``project`` + ``pack_frame`` (``dataio.grid_pack_plain``, f64);
    the device's f32 ``project`` is compared and its count differences
    recorded. Then the two routes of the JAX package's
    ``tests/test_ingest_e2e.py``: VLP-16 packets -> ``vlp16_decode`` ->
    ``FullPipeline`` (each decoded frame equal to the direct packing, ATE
    < 5 cm) and ``.bin`` -> ``convert_kitti_sequence`` -> ``project`` ->
    ``OdometryPipeline`` (ATE < 6 cm, each output published); K1 held
    against its plain version on a decoded frame; and a live 10 Hz stream
    of 40 sweeps through ``RealtimeGate`` into ``FullPipeline``, recorded."""
    model = cfg.rig.models[0]
    ws = cfg.odometry.window_size
    n_render = max(INGEST_FRAMES, INGEST_BIN_FRAMES)
    imgs, gt = run_synthetic.render(cfg, n_render, seed=0, device=DEV)
    frames = [RangeImage(*(f[i] for f in imgs)) for i in range(n_render)]
    gt_t = gt.t.cpu().numpy()
    d = os.path.join(tmp, "velodyne")
    os.makedirs(d)
    bins, pcds, pts_all = [], [], []
    for i, f in enumerate(frames):
        pts = _sweep_points(f)
        pts_all.append(pts)
        bins.append(os.path.join(d, f"{i:06d}.bin"))
        pts.tofile(bins[-1])
        if i < INGEST_PCD_FILES:
            pcds.append(os.path.join(tmp, f"{i:06d}.pcd"))
            _write_pcd_binary(pcds[-1], pts)
    t = time.perf_counter()
    dataio.library()
    build_s = time.perf_counter() - t
    for p, pts in zip(bins, pts_all):
        if not np.array_equal(dataio.read_kitti_bin(p), pts):
            fail(f"ingest_path: {p} did not read back exactly")
    for p, pts in zip(pcds, pts_all):
        if not (np.array_equal(dataio.read_pcd(p), pts)
                and np.array_equal(dataio.read_pcd_plain(p), pts)):
            fail(f"ingest_path: {p} did not read back exactly")
    reader = dataio.PrefetchReader(bins)
    streamed = list(reader)
    reader.close()
    if len(streamed) != len(bins) or not all(np.array_equal(a, b)
                                             for a, b in zip(streamed, pts_all)):
        fail("ingest_path: the prefetch ring did not stream the files back exactly")
    t = time.perf_counter()
    reader = dataio.PackedPrefetchReader(bins, model)
    packed = list(reader)
    reader.close()
    packed_s = time.perf_counter() - t
    f32_diff = []
    for (rq, iq), pts, f in zip(packed, pts_all, frames):
        prq, piq = dataio.grid_pack_plain(pts, model)
        if not (np.array_equal(rq, prq) and np.array_equal(iq, piq)):
            fail("ingest_path: the packed ring differs from project + pack_frame")
        dev = RI.project(torch.from_numpy(pts[:, :3]).to(DEV),
                         torch.ones(len(pts), dtype=torch.bool, device=DEV), model,
                         intensity=torch.from_numpy(pts[:, 3]).to(DEV))
        drq = RI.pack_frame(dev).rng_q
        diff = np.abs(drq.astype(np.int64) - rq.astype(np.int64))
        f32_diff.append([int((diff > 0).sum()), int(diff.max())])
    if len(packed) != len(bins):
        fail(f"ingest_path: the packed ring yielded {len(packed)} of {len(bins)} sweeps")

    # route A: VLP-16 packets -> FullPipeline
    label_case = []
    real_labels = hopper_labels.propagate_labels

    def rec_labels(labels, ch, cv, rounds=3):
        if not label_case:
            label_case.append((labels.clone(), ch.clone(), cv.clone(), rounds))
        return real_labels(labels, ch, cv, rounds)

    zero_counters()
    pipe = FullPipeline(cfg, device=DEV)
    est, codec_ms, returns = [], [], 0
    with FullSweepCheck("ingest_path packets") as chk:
        for i in range(INGEST_FRAMES):
            pf = RI.pack_frame(frames[i])
            ring, col = np.nonzero(pf.rng_q)
            t = time.perf_counter()
            pkts = dataio.encode_vlp16_packets(ring, col, pf.rng_q[ring, col],
                                               pf.intensity_q[ring, col], model.n_cols)
            t_enc = time.perf_counter()
            rq, iq, n_ret = dataio.vlp16_decode(pkts, model)
            codec_ms.append([(t_enc - t) * 1e3, (time.perf_counter() - t_enc) * 1e3])
            if not (np.array_equal(rq, pf.rng_q) and np.array_equal(iq, pf.intensity_q)
                    and n_ret == int((rq > 0).sum())):
                fail(f"ingest_path: sweep {i} decoded from packets differs from its packing")
            returns += n_ret
            hopper_labels.propagate_labels = rec_labels if i == ws + 1 else real_labels
            try:
                out = pipe.process([RI.PackedFrame(rq, iq)])
            finally:
                hopper_labels.propagate_labels = real_labels
            est.append(out.map_pose.t)
    ate_packets = evaluation.ate_rmse(torch.stack(est).cpu().numpy(), gt_t[:INGEST_FRAMES])
    n_l, n_k = hopper_labels.launches, hopper_knn.launches
    check_counters("ingest_path packets", n_l, n_k, INGEST_FRAMES, chk.knn)
    if not ate_packets < ATE_GATE_M:
        fail(f"ingest_path: packet-ingest ATE {ate_packets:.4f} m is not under {ATE_GATE_M} m")

    # route B: .bin -> convert_kitti_sequence -> project -> OdometryPipeline
    shard = os.path.join(tmp, "seq.npz")
    n_conv = dataio.convert_kitti_sequence(d, shard, max_frames=INGEST_BIN_FRAMES,
                                           cap=INGEST_CAP)
    data = np.load(shard)
    pub, msgs = Publisher(), []
    pub.subscribe("/laser_odom", msgs.append, queue_size=INGEST_BIN_FRAMES)
    counter = SweepCounter("ingest_path bin", lambda i, out, p: (1, knn_per_sweep(i, 0, 1, ws)))
    odo = OdometryPipeline(cfg, device=DEV)
    est = []
    l0, k0 = hopper_labels.launches, hopper_knn.launches
    counter.seen.update(labels=l0, knn=k0)
    for i in range(n_conv):
        xyzi = torch.from_numpy(data["xyzi"][i]).to(DEV)
        img = RI.project(xyzi[:, :3], torch.from_numpy(data["mask"][i]).to(DEV), model,
                         intensity=xyzi[:, 3])
        out = odo.process([img])
        counter(i, out, odo)
        publish_odometry_output(pub, out, stamp=i * model.scan_period)
        est.append(out.pose.t)
    pub.spin_once()
    est = torch.stack(est).cpu().numpy()
    if len(msgs) != n_conv or not np.array_equal(np.stack([m.t for m in msgs]), est):
        fail("ingest_path: the published poses differ from the pipeline's")
    ate_bin = evaluation.ate_rmse(est, gt_t[:n_conv])
    if n_conv != INGEST_BIN_FRAMES or not ate_bin < INGEST_BIN_ATE_GATE_M:
        fail(f"ingest_path: kitti-shard ATE {ate_bin:.4f} m over {n_conv} sweeps "
             f"(gate {INGEST_BIN_ATE_GATE_M} m)")

    # a live 10 Hz stream through the realtime gate into FullPipeline
    stream_imgs, stream_gt = run_synthetic.render(cfg, GATED_FRAMES, seed=0, device=DEV)
    stream = [RangeImage(*(f[i] for f in stream_imgs)) for i in range(GATED_FRAMES)]
    gate = RealtimeGate(max_lag_s=GATED_MAX_LAG_S)
    pipe = FullPipeline(cfg, device=DEV)
    admitted, est, ms = [], [], []
    with FullSweepCheck("ingest_path gated") as chk_g:
        for _, (i, f) in gated(live_stream(stream, model.scan_period), gate):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = pipe.process([f])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            admitted.append(i)
            est.append(out.map_pose.t)
    st = gate.stats()
    if st["admitted"] + st["dropped"] != GATED_FRAMES or st["admitted"] < 2:
        fail(f"ingest_path: the gate admitted {st['admitted']} and dropped {st['dropped']} "
             f"of {GATED_FRAMES} sweeps")
    ate_gated = evaluation.ate_rmse(torch.stack(est).cpu().numpy(),
                                    stream_gt.t.cpu().numpy()[admitted])
    launches = {"propagate_labels": hopper_labels.launches, "knn": hopper_knn.launches}
    check_counters("ingest_path", launches["propagate_labels"], launches["knn"],
                   chk.labels + n_conv + chk_g.labels,
                   chk.knn + sum(knn_per_sweep(i, 0, 1, ws) for i in range(n_conv)) + chk_g.knn)
    # K1 on a decoded frame against its plain version (after the count: these
    # launches compare, they are not the path's)
    label_checks = check_labels("ingest_decoded_frame", label_case[0][:3], (label_case[0][3],))
    emit({"ingest_path": {
        "files": {"bin": len(bins), "pcd": len(pcds),
                  "points_per_sweep": [int(len(p)) for p in pts_all]},
        "dataset_library_build_s": build_s,
        "packed_reader_s": packed_s,
        "packed_reader_sweeps_per_s_host": len(packed) / packed_s,
        "device_project_f32_vs_f64_cells_differing_max_counts": f32_diff,
        "packets": {"frames": INGEST_FRAMES, "ate_m": ate_packets,
                    "returns_decoded": returns,
                    "encode_ms_median": _median([c[0] for c in codec_ms]),
                    "decode_ms_median": _median([c[1] for c in codec_ms])},
        "kitti_shard": {"frames": n_conv, "ate_m": ate_bin, "published": len(msgs)},
        "gated_stream": {"frames": GATED_FRAMES, "max_lag_s": GATED_MAX_LAG_S,
                         **st, "admitted_share": st["admitted"] / GATED_FRAMES,
                         "admitted_sweeps": admitted,
                         "ms_per_admitted_sweep_median": _median(ms),
                         "ms_per_admitted_sweep": ms, "ate_admitted_m": ate_gated},
        "label_check": label_checks,
        "launches": launches, "width": width(cfg),
    }})
    return launches, label_checks


def _file_mb(path):
    return os.path.getsize(path) / 1e6


def phase_resume_path(cfg, tmp):
    """Checkpoint and resume. ``FullPipeline``: 9 sweeps, saved, loaded into
    a fresh pipeline (frame index, window poses and the keyframe ring's
    valid mask equal to the bit); the next sweep takes the first-sweep
    branch (its pose the restored world pose, no solve) and the one after
    the steady step, both finite. ``SlamPipeline`` on the small loop course
    of the JAX package's ``tests/test_checkpoint.py:71-79``, saved with a
    keyframe in flight: the restored keyframe count equals the stored one,
    ``kf_counter`` is kept, the next sweep is finite. File sizes, save and
    load seconds recorded."""
    zero_counters()
    n = RESUME_FRAMES
    imgs, _ = run_synthetic.render(cfg, n + 2, seed=0, device=DEV)
    frames = [RangeImage(*(f[i] for f in imgs)) for i in range(n + 2)]
    pipe = FullPipeline(cfg, device=DEV)
    with FullSweepCheck("resume_path full") as chk:
        for f in frames[:n]:
            pipe.process([f])
        path = os.path.join(tmp, "full.npz")
        torch.cuda.synchronize()
        t = time.perf_counter()
        CK.save_pipeline(path, pipe)
        save_s = time.perf_counter() - t
        pipe2 = FullPipeline(cfg, device=DEV)
        t = time.perf_counter()
        CK.load_pipeline(path, pipe2)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        o, o2 = pipe.odom, pipe2.odom
        if not (o2.frame_idx == o.frame_idx == n
                and torch.equal(o2.window.poses.t, o.window.poses.t)
                and torch.equal(o2.window.poses.q, o.window.poses.q)
                and torch.equal(pipe2.mapper_state.db.valid, pipe.mapper_state.db.valid)
                and pipe2.mapper_state.step == pipe.mapper_state.step):
            fail("resume_path: the restored FullPipeline differs from the saved one")
        world = o2.world_pose.t.clone()
        first = pipe2.process([frames[n]])
        if first.odom.win_eig is not None or not torch.equal(first.odom.pose.t, world):
            fail("resume_path: the restored pipeline did not re-enter through the "
                 "first-sweep branch")
        nxt = pipe2.process([frames[n + 1]])
        if nxt.odom.win_eig is None:
            fail("resume_path: the sweep after the first-sweep branch was not a steady step")
        finite = all(bool(torch.isfinite(x).all()) for x in
                     (first.map_pose.t, nxt.map_pose.t, nxt.odom.pose.q))
        if not finite:
            fail("resume_path: the resumed pipeline gave non-finite poses")
    full_rec = {"frames_before_save": n, "file_mb": _file_mb(path), "save_s": save_s,
                "load_s": load_s, "keyframes": int(pipe.mapper_state.db.valid.sum()),
                "mapper_steps": pipe.mapper_state.step}

    # SlamPipeline with a keyframe in flight
    scfg = dataclasses.replace(
        cfg, mapping=dataclasses.replace(cfg.mapping, keyframe_dist=0.3, skip_frames=1),
        loop=dataclasses.replace(cfg.loop, skip_interval=1, capacity=32))
    sim, _ = run_synthetic.render_rig(scfg, RESUME_SLAM_FRAMES, seed=2, device=DEV,
                                      world={"extent": 25.0},
                                      loop={"radius": 5.0, "period_s": 8.0})
    sframes = [RangeImage(*(f[i] for f in sim[0])) for i in range(RESUME_SLAM_FRAMES)]
    per_detect = 12 if scfg.loop.use_global_registration else 6
    slam = PIPE.SlamPipeline(scfg, device=DEV)
    k0 = hopper_knn.launches
    with FullSweepCheck("resume_path slam") as chk_s:
        for f in sframes:
            slam.process([f])
        in_flight = slam._pending_kf is not None or slam._pending_verify is not None
        if not in_flight:
            fail("resume_path: no keyframe in flight at the save")
        spath = os.path.join(tmp, "slam.npz")
        torch.cuda.synchronize()
        t = time.perf_counter()
        CK.save_pipeline(spath, slam)
        ssave_s = time.perf_counter() - t
        slam2 = PIPE.SlamPipeline(scfg, device=DEV)
        t = time.perf_counter()
        CK.load_pipeline(spath, slam2)
        torch.cuda.synchronize()
        sload_s = time.perf_counter() - t
        stored = int(slam2.loop_state.count)
        if not (slam2.loop_kf_count == stored == slam.loop_kf_count
                and slam2.kf_counter == slam.kf_counter):
            fail(f"resume_path: restored loop keyframes {slam2.loop_kf_count}, stored "
                 f"{stored}, saved {slam.loop_kf_count}; kf_counter {slam2.kf_counter} "
                 f"against {slam.kf_counter}")
        sout = slam2.process([sframes[-1]])
        if not bool(torch.isfinite(sout.full.map_pose.t).all()):
            fail("resume_path: the resumed SlamPipeline gave a non-finite pose")
    detections = slam.n_detections + slam2.n_detections
    if hopper_knn.launches - k0 != chk_s.knn + per_detect * detections:
        fail(f"resume_path slam: knn {hopper_knn.launches - k0}, expected "
             f"{chk_s.knn + per_detect * detections}")
    launches = {"propagate_labels": hopper_labels.launches, "knn": hopper_knn.launches}
    check_counters("resume_path", launches["propagate_labels"], launches["knn"],
                   chk.labels + chk_s.labels, chk.knn + chk_s.knn + per_detect * detections)
    emit({"resume_path": {
        "full": full_rec,
        "slam": {"frames_before_save": RESUME_SLAM_FRAMES, "file_mb": _file_mb(spath),
                 "save_s": ssave_s, "load_s": sload_s, "loop_keyframes": stored,
                 "kf_counter": slam2.kf_counter, "detections": detections},
        "launches": launches, "width": width(cfg),
    }})
    return launches


def phase_experiments_path(tmp):
    """The experiment programs' measurements at full width, their launch
    counters checked on every sweep: ``single`` (16 sweeps, ATE < 5 cm; its
    keyframe map exported as PCD), ``mc`` (one trial of 16 sweeps in each of
    its four cells, each ATE < 5 cm) and ``inject_ext`` at levels gt and inj,
    ua off and on, one trial of 10 sweeps of the dual rig (at gt, ATE
    < 5 cm). Each is written (TUM, JSON, PCD and the plots' inputs; the PNGs
    are drawn elsewhere by ``experiments plot``: matplotlib is not needed
    here)."""
    zero_counters()
    out, written = {}, {}
    with FullSweepCheck("experiments_path") as chk:
        res = EXP.measure_single(EXP_FRAMES, device=DEV)
        written["single"] = EXP.write_single(res, tmp)
        xyz, mask = EXP.keyframe_map(res["pipe"].mapper_state.db)
        pcd = os.path.join(written["single"], "map.pcd")
        viz.export_map_pcd(pcd, xyz, mask)
        with open(pcd) as f:
            head = f.read(400)
        if f"POINTS {int(mask.sum())}\n" not in head or not mask.any():
            fail("experiments_path: the exported keyframe map is empty or miscounted")
        out["single"] = {k: res["summary"][k] for k in ("ate_m", "fps", "frames")}
        out["single"]["map_points"] = int(mask.sum())
        if not res["ate_m"] < ATE_GATE_M:
            fail(f"experiments_path: single ATE {res['ate_m']:.4f} m")
        mc = EXP.measure_mc(1, EXP_FRAMES, device=DEV)
        written["mc"] = EXP.write_mc(mc, tmp)
        out["mc"] = mc["summary"]
        for name, cell in mc["summary"]["cells"].items():
            if not cell["ate_max_m"] < ATE_GATE_M:
                fail(f"experiments_path: mc cell {name} ATE {cell['ate_max_m']:.4f} m")
        inj = EXP.measure_inject_ext(EXP_INJECT_FRAMES, 0, 1, ("gt", "inj"), device=DEV)
        written["inject_ext"] = EXP.write_inject_ext(inj, tmp)
        out["inject_ext"] = inj["summary"]
        gt_level = inj["summary"]["gt"]
        if not (gt_level["ate_m_off"] < ATE_GATE_M and gt_level["ate_m_ua"] < ATE_GATE_M):
            fail(f"experiments_path: inject_ext at gt ATE {gt_level['ate_m_off']:.4f} / "
                 f"{gt_level['ate_m_ua']:.4f} m")
    files = {k: sorted(os.listdir(v)) for k, v in written.items()}
    for k, v in written.items():
        with open(os.path.join(v, "summary.json")) as f:
            if not json.load(f):
                fail(f"experiments_path: {k} wrote an empty summary")
        if os.path.exists(os.path.join(v, "plots.npz")):
            with np.load(os.path.join(v, "plots.npz")) as z:
                if not all(np.isfinite(z[a]).all() for a in z.files):
                    fail(f"experiments_path: {k}'s plot inputs are not finite")
    launches = {"propagate_labels": hopper_labels.launches, "knn": hopper_knn.launches}
    check_counters("experiments_path", launches["propagate_labels"], launches["knn"],
                   chk.labels, chk.knn)
    emit({"experiments_path": {**out, "files": files, "sweeps": chk.sweeps,
                               "launches": launches}})
    return launches


class Laps:
    """Seconds between successive marks, by the name of the phase just done."""

    def __init__(self):
        self.t, self.s = time.perf_counter(), {}

    def __call__(self, name):
        now = time.perf_counter()
        self.s[name] = round(now - self.t, 1)
        self.t = now


def main():
    t0 = time.perf_counter()
    lap = Laps()
    smi = phase_env()
    report = phase_build()
    lap("build")
    k3 = phase_band_chol(report)
    lap("band_chol")
    cfg = platforms.synthetic(n_lidars=1)
    assert cfg.rig.models[0] == LidarModel(n_rings=16, n_cols=1800)
    rig_cfg = platforms.synthetic(n_lidars=2, extrinsic_mode=0)
    kernels = phase_kernels(cfg, rig_cfg)
    k1, k2 = kernels
    lap("kernels")
    by_path = {"main_path": phase_main_path(cfg)}
    rig_window = [s for s in k2["main_path_shapes"] if s["name"].startswith("rig_")]
    by_path["rig_path"], rig_res = phase_rig_path(rig_cfg, rig_window)
    lap("main_and_rig_paths")
    by_path["calib_path"], calib_captured = phase_calib_path(
        platforms.synthetic(n_lidars=2, extrinsic_mode=2))
    lap("calib_path")
    preset_counts, captured, by_shape, preset_res = phase_presets()
    by_path.update(preset_counts)
    lap("presets")
    by_path["batch_fe_path"], k1["batched"] = phase_batch_fe_path(
        rig_cfg, rig_res, preset_res["oxford"])
    k1["max_abs_err"] = max(k1["max_abs_err"], k1["batched"]["max_abs_err"])
    lap("batch_fe_path")
    by_path["map_path"], map_captured = phase_map_path("map_path", cfg, MAP_FRAMES)
    map_rig_cfg = dataclasses.replace(rig_cfg, mapping=dataclasses.replace(
        rig_cfg.mapping, ext_cov_prior_diag=MAP_RIG_EXT_COV))
    by_path["map_rig_path"], map_rig_captured = phase_map_path(
        "map_rig_path", map_rig_cfg, MAP_RIG_FRAMES, extrinsics=RIG_X)
    lap("map_paths")

    # K2 at the mapper's shapes, on the inputs the mapping paths gave it
    map_checks, map_shapes = map_knn_checks("", map_captured)
    rig_checks, rig_map_shapes = map_knn_checks("rig_", map_rig_captured)
    emit({"kernel_checks": {"knn_map": map_checks + rig_checks}})
    k2["main_path_shapes"] += map_shapes + rig_map_shapes
    k2["max_abs_err"] = max([k2["max_abs_err"]]
                            + [c["max_abs_err"] for c in map_checks + rig_checks])

    # K2 at the calibration path's shapes, on the inputs that path gave it
    calib_checks, calib_shapes = calib_knn_checks(calib_captured, rig_cfg.rig.n_lidars)
    emit({"kernel_checks": {"knn_calib": calib_checks}})
    k2["main_path_shapes"] += calib_shapes
    k2["max_abs_err"] = max([k2["max_abs_err"]] + [c["max_abs_err"] for c in calib_checks])

    # K1 at the presets' shapes, on the inputs those paths gave it
    preset_checks = []
    for shape, (lab, ch, cv, rounds) in sorted(captured.items()):
        preset_checks += check_labels(f"presets_{'x'.join(map(str, shape))}",
                                      (lab, ch, cv), (rounds,))
    emit({"kernel_checks": {"labels_presets": preset_checks}})
    k1["max_abs_err"] = max([k1["max_abs_err"]] + [c["max_abs_err"] for c in preset_checks])
    for other in k1["other_shapes"]:
        shape = tuple(other["shape"])
        other["launches"] = by_shape.get(shape, 0)
        if other["launches"] == 0:
            fail(f"labels: no path launched the kernel at {shape}")
    # the tuned operating point, the corridor and robust paths, the slam
    # paths, the repeat check and the pose-graph checks
    tuned_cfg = platforms.realtime_tuned(cfg)
    tuned_rig_cfg = platforms.realtime_tuned(rig_cfg)
    by_path["tuned_path"], tuned_labels, _ = phase_tuned_path(
        "tuned_path", tuned_cfg, TUNED_FRAMES)
    by_path["tuned_rig_path"], _, _ = phase_tuned_path(
        "tuned_rig_path", tuned_rig_cfg, TUNED_RIG_FRAMES, extrinsics=RIG_X)
    lab, ch, cv, rounds = tuned_labels
    tuned_label_checks = check_labels("tuned_path", (lab, ch, cv), (rounds, 8))
    emit({"kernel_checks": {"labels_tuned": tuned_label_checks}})
    k1["max_abs_err"] = max([k1["max_abs_err"]] + [c["max_abs_err"] for c in tuned_label_checks])
    k1["tuned_path"] = {f"rounds_{n}": label_timing(f"tuned_path_{n}_rounds", (lab, ch, cv), n)
                        for n in sorted({rounds, 8})}
    lap("kernel_checks_and_tuned_paths")

    # the degenerate corridor (remap armed and disarmed) and the robust losses
    corridor_counts, corridor_captured = phase_corridor_path()
    by_path.update(corridor_counts)
    c_knn, c_shapes, c_labels, c_label_timing = corridor_kernel_checks(corridor_captured)
    emit({"kernel_checks": {"knn_corridor": c_knn, "labels_corridor": c_labels}})
    k2["main_path_shapes"] += c_shapes
    k2["max_abs_err"] = max([k2["max_abs_err"]] + [c["max_abs_err"] for c in c_knn])
    k1["max_abs_err"] = max([k1["max_abs_err"]] + [c["max_abs_err"] for c in c_labels])
    k1["corridor_path"] = c_label_timing
    lap("corridor_path")
    by_path.update(phase_robust_path())
    lap("robust_path")

    before = pgo_counts()
    by_path["slam_path"], det_calls = phase_slam_path("slam_path", "floor", cfg)
    pgo_by_path = {"slam_path": pgo_counts(before)}
    loop_checks, loop_shapes = loop_knn_checks(det_calls)
    emit({"kernel_checks": {"knn_loop": loop_checks}})
    k2["main_path_shapes"] += loop_shapes
    k2["max_abs_err"] = max([k2["max_abs_err"]] + [c["max_abs_err"] for c in loop_checks])
    lap("slam_path")
    before = pgo_counts()
    by_path["slam_drift_path"], _ = phase_slam_path(
        "slam_drift_path", "drift", cfg, probe_from=DRIFT_PROBE_FROM, gate_loops=False,
        frames=DRIFT_FRAMES)
    pgo_by_path["slam_drift_path"] = pgo_counts(before)
    emit({"pgo_solves": pgo_by_path})
    lap("slam_drift_path")
    phase_repeat_check(cfg)
    lap("repeat_check")
    ladder = phase_pgo_check()
    lap("pgo_checks")

    # the deployment layer: files and packets in, checkpoint and resume, the
    # experiment programs
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        by_path["ingest_path"], ingest_labels = phase_ingest_path(cfg, tmp)
        emit({"kernel_checks": {"labels_ingest": ingest_labels}})
        k1["max_abs_err"] = max([k1["max_abs_err"]] + [c["max_abs_err"] for c in ingest_labels])
        lap("ingest_path")
        by_path["resume_path"] = phase_resume_path(cfg, tmp)
        lap("resume_path")
        by_path["experiments_path"] = phase_experiments_path(tmp)
        lap("experiments_path")
        by_path["parallel_path"] = phase_parallel_path(tmp, ladder)
        lap("parallel_path")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    for kern, key in ((k1, "propagate_labels"), (k2, "knn")):
        kern["launches_by_path"] = {p: c[key] for p, c in by_path.items()}
        kern["launches"] = sum(kern["launches_by_path"].values())
    emit({"kernels": kernels, "band_chol": {"cases": k3, "launches": BC.launches,
                                            "pgo_solves": pgo_counts()}})
    emit({"seconds": round(time.perf_counter() - t0, 1), "seconds_by_phase": lap.s,
          "package": mloam_tpu_torch.__version__})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
