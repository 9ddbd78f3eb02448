"""Float sums over index groups whose result does not depend on order.

``index_add_`` on a CUDA tensor adds floats with atomics in whatever order
the threads arrive; float addition is not associative, so the last bits of a
voxel centroid or a pose-graph Hessian entry change from run to run, and a
run of the pipeline with them. ``index_sum`` scales every value by a power
of two into a 64-bit fixed-point integer and adds those: integer addition is
associative, so each group's sum is a function of the multiset of its
members alone — the same bits on every run, on any device, in any member
order (the CPU tests hold that by permuting the members).

Each column (each element of a row of ``values``) has its own scale 2^k,
with 2^(61-k) above n·max|v| over that column: an upper bound on any
group's sum of magnitudes, so no group overflows int64, and each member is
truncated to a multiple of 2^-61 of that bound — far below float32's resolution of the
sums served here (the rounding of the final sum to float32 dominates). A
non-finite value makes its whole column NaN (a bound that is not finite has
no scale); the port's callers mask invalid rows to zero first.
"""

from __future__ import annotations

import math

import torch

# 2^k stays a normal float32 for k in [-126, 127]; k is clamped to 100 so a
# tiny bound (all values ~0) cannot leave that range
_MAX_SHIFT = 100


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2^k as float32, exact, from the exponent bits (k int32 in [-126, 127])."""
    return ((k + 127) << 23).to(torch.int32).view(torch.float32)


def index_sum(values: torch.Tensor, index: torch.Tensor, n_out: int) -> torch.Tensor:
    """``torch.zeros((n_out,) + values.shape[1:]).index_add_(0, index, values)``
    in float32, computed in fixed point so that it is independent of the
    order of the adds. ``index`` [N] int64 in [0, n_out)."""
    n = values.shape[0]
    flat = values.reshape(n, math.prod(values.shape[1:]))
    bound = (torch.amax(torch.abs(flat), dim=0) * float(n) if n else
             torch.zeros(flat.shape[1], dtype=values.dtype, device=values.device))
    _, e = torch.frexp(bound)                       # per column: bound < 2^e
    k = torch.clamp(61 - e.to(torch.int32), max=_MAX_SHIFT)
    # truncation toward zero: an error under one unit (2^-61 of the bound)
    ints = (flat * _pow2(k)).to(torch.int64)
    acc = torch.zeros((n_out, flat.shape[1]), dtype=torch.int64, device=values.device)
    acc.index_add_(0, index, ints)
    out = acc.to(values.dtype) * _pow2(-k)
    out = torch.where(torch.isfinite(bound), out, torch.nan)
    return out.reshape((n_out,) + values.shape[1:])
