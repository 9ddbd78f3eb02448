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

Leading batch axes sum each batch element on its own (the shards of a
stacked mesh). ``scale_exponent`` / ``to_fixed`` / ``add_fixed`` /
``from_fixed`` are the steps, for ``parallel/mesh.Mesh.index_sum``, which
takes the bound over every shard and reduces the integer sums across them.
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


def scale_exponent(bound: torch.Tensor) -> torch.Tensor:
    """Per column k, with 2^(61-k) above ``bound`` (int32, at most
    ``_MAX_SHIFT``): members scaled by 2^k sum below 2^61 in int64."""
    _, e = torch.frexp(bound)                       # bound < 2^e
    return torch.clamp(61 - e.to(torch.int32), max=_MAX_SHIFT)


def to_fixed(flat: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[..., N, C] floats -> int64 multiples of 2^-k (k [..., C]), truncated
    toward zero: an error under one unit (2^-61 of the bound)."""
    return (flat * _pow2(k)[..., None, :]).to(torch.int64)


def add_fixed(ints: torch.Tensor, index: torch.Tensor, n_out: int) -> torch.Tensor:
    """Integer group sums: ints [*B, N, C], index [*B, N] in [0, n_out) ->
    [*B, n_out, C]; each leading index (a shard) sums its own rows."""
    lead = index.shape[:-1]
    c = ints.shape[-1]
    nb = math.prod(lead)
    idx = index.reshape(nb, -1)
    if nb > 1:
        idx = idx + torch.arange(nb, device=index.device)[:, None] * n_out
    acc = torch.zeros((nb * n_out, c), dtype=torch.int64, device=ints.device)
    acc.index_add_(0, idx.reshape(-1), ints.reshape(-1, c))
    return acc.reshape(lead + (n_out, c))


def from_fixed(acc: torch.Tensor, k: torch.Tensor, bound: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    """Integer sums [..., n_out, C] back to floats; a column whose bound is
    not finite is NaN."""
    out = acc.to(dtype) * _pow2(-k)[..., None, :]
    return torch.where(torch.isfinite(bound)[..., None, :], out, torch.nan)


def index_sum(values: torch.Tensor, index: torch.Tensor, n_out: int) -> torch.Tensor:
    """``torch.zeros((n_out,) + values.shape[1:]).index_add_(0, index, values)``
    in float32, computed in fixed point so that it is independent of the
    order of the adds. ``index`` [N] int64 in [0, n_out).

    With leading batch axes, ``index`` [*B, N] and ``values`` [*B, N, ...]
    give [*B, n_out, ...]: each batch element (a shard of a stacked mesh) is
    summed on its own, with its own scale, as if alone."""
    lead = index.shape[:-1]
    n = index.shape[-1]
    flat = values.reshape(lead + (n, math.prod(values.shape[len(lead) + 1:])))
    bound = (torch.amax(torch.abs(flat), dim=-2) * float(n) if n else
             torch.zeros(lead + flat.shape[-1:], dtype=values.dtype, device=values.device))
    k = scale_exponent(bound)
    out = from_fixed(add_fixed(to_fixed(flat, k), index, n_out), k, bound, values.dtype)
    return out.reshape(lead + (n_out,) + values.shape[len(lead) + 1:])
