"""mloam_tpu_torch — the PyTorch/CUDA port of mloam_tpu, for an NVIDIA Hopper
GPU.

Same layer map and the same module and function names as the JAX package
``mloam_tpu`` (which stays in the repository as the reference), PyTorch idiom
inside: plain functions on tensors, NamedTuple state containers, an explicit
``device`` on every constructor and entry point, eager execution.

  core/      geometry (SO(3)/SE(3)), covariance algebra, range-image and
             cloud schemas
  ops/       batched primitives: k-NN, voxel reductions (plain and
             uncertainty-weighted), masked top-k, and the two hand-written
             CUDA kernels (label propagation, fused k-NN)
  csrc/      CUDA C++ sources of those kernels, and the host C++ dataset
             reader (all built by ops/_build.py at first use)
  frontend/  segmentation, curvature feature extraction
  solver/    factor library, robust losses, Gauss-Newton, marginalization,
             degeneracy projector, good-feature selection
  odometry/  scan-to-scan tracker, sliding-window estimator, calibration
  mapping/   keyframe ring and uncertainty-aware scan-to-map refinement
  models/    odometry, mapping and SLAM pipelines, platform presets, the
             synthetic run program and the experiment programs
  sim/       synthetic world, trajectory and ray-cast renderer
  utils/     timing registry, trajectory evaluation, numpy state conversion,
             and the deployment layer: file and packet ingest, checkpoint and
             resume, the realtime gate, the publisher, plots

This package imports torch and numpy only; never jax, never mloam_tpu.

Entry points run on the GPU: they default to ``device="cuda"`` and raise when
no CUDA device is present. They run on the CPU only when the caller passes
``device="cpu"``.
"""

import torch as _torch

# f32 throughout. SLAM geometry subtracts large near-equal values (normal
# equations, Schur complements, plane/line fits); TF32's ~3 decimal digits
# are not enough for any of it. Matrix products are full f32 by default in
# PyTorch, but cuDNN convolutions run in TF32 unless told otherwise — both
# are set and stated here so that no sliding-window sum written as a
# convolution can move a threshold.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def resolve_device(device=None) -> "_torch.device":
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when the GPU is wanted and absent — no entry point carries
    on on the CPU because it found no GPU."""
    if device is None:
        device = "cuda"
    device = _torch.device(device)
    if device.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            "mloam_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run the plain versions on the CPU")
    return device
