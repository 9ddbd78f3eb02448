"""Correspondence search without kd-trees: brute-force k-NN.

``knn_plain`` is the plain PyTorch version — chunked direct-difference
distances, ``torch.topk`` over packed (d², index) keys, and a running merge —
and the path CPU tensors take. ``knn_auto``, the entry point of the matchers, sends CUDA tensors to the
hand-written kernel (``ops/hopper_knn.py``), which never forms the distance
matrix in device memory.

The distance is taken directly as Σ (q_i − r_i)² rather than through the
``‖q‖² + ‖r‖² − 2 q·r`` matrix-product form of ``mloam_tpu/ops/knn.py``: that
form cancels when ‖q − r‖ << ‖q‖ (every LiDAR correspondence) and buys
nothing for 3-wide points.

All inputs are fixed-capacity padded tensors with boolean masks. Contract on
return: d² ascending, ties to the lowest index; slots with no unmasked
reference left hold d² = 1e30 and index 0. Indices are int64 so they index
tensors directly.
"""

from __future__ import annotations

import torch

from mloam_tpu_torch.ops import hopper_knn

_BIG = 1e30


def pairwise_sqdist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """[Nq,D]x[Nr,D] -> [Nq,Nr] squared distances, summed coordinate by
    coordinate (no [Nq, Nr, D] temporary) in the order and with the fused
    multiply-adds of the kernel's compiled code: d = fma(dz, dz, fma(dx, dx,
    dy·dy)) for D = 3, so that the two round near-equal distances alike and
    break the same ties.

    ``torch.addcmul`` lowers to one fused multiply-add in PyTorch's CUDA
    build; that is how it is compiled, not a documented contract
    (``chip_smoke.py`` checks it on the card), and on the CPU the product
    may be rounded apart. Where the roundings differ, two references whose
    d² lie within an ulp may come out in either order."""
    d = None
    for a in ([1, 0] + list(range(2, q.shape[1]))) if q.shape[1] > 1 else [0]:
        diff = q[:, a, None] - r[None, :, a]
        d = diff * diff if d is None else torch.addcmul(d, diff, diff)
    return d


def _keys(d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(d², index) packed into one int64 per pair so that integer order is
    (d² ascending, index ascending): the bits of a non-negative float32 order
    as its value, and no two pairs share an index, so no two keys tie."""
    return (d.view(torch.int32).to(torch.int64) << 32) | idx


def _unkeys(key: torch.Tensor):
    d = (key >> 32).to(torch.int32).view(torch.float32)
    return d, key & 0xFFFFFFFF


def knn_plain(q: torch.Tensor, r: torch.Tensor, r_mask: torch.Tensor, k: int,
              chunk: int = 4096):
    """k nearest reference points for each query, exact.

    Returns (dists [Nq,k] squared, idx [Nq,k] into r). Chunked over the
    reference axis: each step computes a [Nq, chunk] distance tile and merges
    its k least into the running best-k. Ties go to the lowest index, the
    rule the kernel keeps: selection and merge both order by the packed
    (d², index) key of ``_keys``, on which ``torch.topk`` cannot tie. Slots
    with no unmasked reference hold d² = 1e30 and index 0, as the kernel's do.
    """
    nr = r.shape[0]
    best = None
    for lo in range(0, nr, chunk):
        rc, mc = r[lo:lo + chunk], r_mask[lo:lo + chunk]
        d = torch.where(mc[None, :], pairwise_sqdist(q, rc), _BIG)
        key = _keys(d, torch.arange(lo, lo + rc.shape[0], device=q.device))
        if best is not None:
            key = torch.cat([best, key], 1)
        best = torch.topk(key, min(k, key.shape[1]), dim=1, largest=False).values
    best_d, best_i = _unkeys(best)
    best_i = torch.where(best_d >= _BIG, 0, best_i)
    if best_d.shape[1] < k:  # tiny reference sets: pad so k slots exist
        pad = k - best_d.shape[1]
        best_d = torch.cat([best_d, best_d.new_full((q.shape[0], pad), _BIG)], 1)
        best_i = torch.cat([best_i, best_i.new_zeros((q.shape[0], pad))], 1)
    return best_d, best_i


def knn(q: torch.Tensor, r: torch.Tensor, r_mask: torch.Tensor, k: int):
    """k-NN entry point: the hand-written kernel for CUDA tensors (it
    launches or raises), the plain version for CPU tensors."""
    if q.is_cuda:
        return hopper_knn.knn(q, r, r_mask, k)
    hopper_knn.check_args(q, r, r_mask, k)
    return knn_plain(q, r, r_mask, k)


# The matchers (solver/factors.py) call the entry point by the name it has in
# the JAX package, where it chooses between two implementations.
knn_auto = knn


def nearest(q, r, r_mask):
    d, i = knn(q, r, r_mask, 1)
    return d[:, 0], i[:, 0]
