"""Fused brute-force k-NN over 3-D points: the hand-written CUDA kernel
(``csrc/knn.cu``). Its plain PyTorch version is ``ops/knn.knn_plain``.

Replaces the TPU kernel ``mloam_tpu/ops/pallas_knn.py:_lane_bucket_kernel``
(entry ``knn_pallas``): for each query the k nearest unmasked reference
points, squared distance ascending plus index, without a ``[Nq, Nr]`` distance
matrix in device memory. Exact for every k <= 8; ties go to the lowest index.

Bound on the H100: operations on the CUDA cores (8 flop per query and valid
reference), not bytes. The first design (one query per thread) left the card
latency-bound: 3 to 96 blocks on 132 SMs, every thread walking all
references, masked ones included, through synchronously staged tiles. This
one gives each query S lanes of a warp (``lanes_per_query``), merges their sorted
lists by (d², index) with warp shuffles, walks only the valid references of
each tile (compacted in shared memory by ballot prefix sums) and stages the
next tile with ``cp.async`` while the current one is walked. One launch per
call. See the note in ``csrc/knn.cu``.

Return contract (that of ``mloam_tpu/ops/knn.py``): d² f32 [Nq, k] ascending,
idx int64 [Nq, k]; slots with no unmasked reference left (masked-out sets,
Nr < k) hold d² = 1e30 and index 0.
"""

from __future__ import annotations

import ctypes

import torch

from mloam_tpu_torch.ops import _build

launches = 0  # kernel launches made by knn()

MAX_K = 8
MIN_LANES = 8     # lanes per query at the least (the C entry refuses fewer)
WARPS_PER_SM = 4  # the grid should hold at least this many warps an SM
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load("knn").mloam_knn
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def lanes_per_query(nq: int, n_sms: int = 132) -> int:
    """Lanes of a warp that share one query, for ``nq`` queries on a card of
    ``n_sms`` SMs: the least power of two from ``MIN_LANES`` up to 32 that
    puts ``WARPS_PER_SM`` warps on every SM. Fewer lanes walk more
    references each and merge fewer lists; more put more warps in flight."""
    lanes = MIN_LANES
    while lanes < 32 and nq * lanes < 32 * WARPS_PER_SM * n_sms:
        lanes *= 2
    return lanes


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on a 16-byte boundary (the kernel's
    ``cp.async`` copies are 16 bytes wide): a copy where the view is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check_args(q, r, r_mask, k):
    if q.ndim != 2 or q.shape[1] != 3 or r.ndim != 2 or r.shape[1] != 3:
        raise TypeError("q and r must be [N, 3] point sets")
    if q.dtype != torch.float32 or r.dtype != torch.float32:
        raise TypeError("q and r must be float32")
    if r_mask.dtype != torch.bool or r_mask.shape != (r.shape[0],):
        raise TypeError("r_mask must be a bool [Nr] tensor")
    if r.device != q.device or r_mask.device != q.device:
        raise ValueError("q, r and r_mask must lie on one device")
    if not isinstance(k, int) or not 1 <= k <= MAX_K:
        raise ValueError(f"k must be an int in [1, {MAX_K}]")
    if r.shape[0] < 1 or q.shape[0] < 1:
        raise ValueError("q and r must hold at least one point")
    if max(q.shape[0], r.shape[0]) >= 2**31:
        raise ValueError("q and r must index within int32")


def knn(q: torch.Tensor, r: torch.Tensor, r_mask: torch.Tensor, k: int):
    """(d² [Nq, k] ascending, idx [Nq, k] int64 into r) on CUDA tensors."""
    global launches
    check_args(q, r, r_mask, k)
    if not q.is_cuda:
        raise ValueError("hopper_knn.knn takes CUDA tensors; ops.knn.knn_auto "
                         "routes CPU tensors to the plain version")
    fn = _kernel_fn()
    q = q.contiguous()
    r = aligned16(r)
    r_mask = aligned16(r_mask)
    nq, nr = q.shape[0], r.shape[0]
    lanes = lanes_per_query(
        nq, torch.cuda.get_device_properties(q.device).multi_processor_count)
    d = torch.empty((nq, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((nq, k), dtype=torch.int64, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), r.data_ptr(), r_mask.data_ptr(), d.data_ptr(),
                 idx.data_ptr(), nq, nr, k, lanes,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "knn")
    launches += 1
    return d, idx
