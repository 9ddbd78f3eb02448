"""Correspondence search without kd-trees: brute-force k-NN.

``knn_plain`` is the plain PyTorch version — chunked direct-difference
distances plus ``torch.topk`` with a running merge — and the path CPU tensors
take. ``knn_auto``, the entry point of the matchers, sends CUDA tensors to the
hand-written kernel (``ops/hopper_knn.py``), which never forms the distance
matrix in device memory.

The distance is taken directly as Σ (q_i − r_i)² rather than through the
``‖q‖² + ‖r‖² − 2 q·r`` matrix-product form of ``mloam_tpu/ops/knn.py``: that
form cancels when ‖q − r‖ << ‖q‖ (every LiDAR correspondence) and buys
nothing for 3-wide points.

All inputs are fixed-capacity padded tensors with boolean masks. Contract on
return: d² ascending; slots with no unmasked reference left hold d² = 1e30
and an index inside [0, Nr). Indices are int64 so they index tensors directly.
"""

from __future__ import annotations

import torch

from mloam_tpu_torch.ops import hopper_knn

_BIG = 1e30


def pairwise_sqdist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """[Nq,D]x[Nr,D] -> [Nq,Nr] squared distances, summed coordinate by
    coordinate (no [Nq, Nr, D] temporary)."""
    d = None
    for a in range(q.shape[1]):
        diff = q[:, a, None] - r[None, :, a]
        d = diff * diff if d is None else d + diff * diff
    return d


def knn_plain(q: torch.Tensor, r: torch.Tensor, r_mask: torch.Tensor, k: int,
              chunk: int = 4096):
    """k nearest reference points for each query, exact.

    Returns (dists [Nq,k] squared, idx [Nq,k] into r). Chunked over the
    reference axis: each step computes a [Nq, chunk] distance tile and merges
    its top-k into the running best-k.
    """
    nr = r.shape[0]
    best_d = best_i = None
    for lo in range(0, nr, chunk):
        rc, mc = r[lo:lo + chunk], r_mask[lo:lo + chunk]
        d = pairwise_sqdist(q, rc)
        d = torch.where(mc[None, :], d, _BIG)
        kk = min(k, rc.shape[0])
        neg, idx = torch.topk(-d, kk, dim=1)
        cd, ci = -neg, idx + lo
        if best_d is not None:
            cd, ci = torch.cat([best_d, cd], 1), torch.cat([best_i, ci], 1)
        if cd.shape[1] > k or best_d is not None:
            neg, sel = torch.topk(-cd, min(k, cd.shape[1]), dim=1)
            cd, ci = -neg, torch.gather(ci, 1, sel)
        best_d, best_i = cd, ci
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
