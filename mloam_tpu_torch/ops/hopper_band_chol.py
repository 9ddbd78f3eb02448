"""Solve of a symmetric positive definite band system: the hand-written CUDA
kernel (``csrc/band_chol.cu``, K3) and its plain PyTorch version.

Replaces no TPU kernel: the JAX package factors the pose graph's damped
normal equations densely (``jnp.linalg.cholesky``). The port's
``parallel/sharded_pgo.pgo_step`` orders the poses by reverse Cuthill-McKee,
which leaves the Hessian of a drive's graph a band a few poses wide, and
hands that band here: one launch factors it, runs both substitutions,
gathers g into the band's order and scatters the solution back.

The band (``band`` [N, b + 1], float32) holds the lower triangle of A in
the band's order: row r, column d is A[r, r - d] (d = 0 the diagonal,
entries left of column 0 are zero). ``perm`` [N / 6] int64 is the pose at
each position of that order; g and the solution are in pose order. The
factor overwrites the band in place (row r, column d: L[r, r - d]).

Bound on the H100: latency, then the one SM's shared memory, not the card's
operations or bytes (see the note in ``csrc/band_chol.cu``). One block
walks the diagonal in panels of ``PANEL`` columns with the active window in
shared memory; the window's size sets the widest band it takes,
``MAX_HALF_BANDWIDTH`` poses.
"""

from __future__ import annotations

import ctypes

import torch

from mloam_tpu_torch.ops import _build

launches = 0  # kernel launches made by band_solve()

PANEL = 32             # columns a panel, a warp's width (csrc/band_chol.cu kPanel)
THREADS = 256          # threads of the one block (kThreads)
RING = 256             # backward-substitution ring of right-hand sides (kRing)
SMEM_LIMIT = 232448    # shared memory one block may hold on the H100 (227 KB)
_fn = None


def scalar_bandwidth(half_bandwidth: int) -> int:
    """b: the lower bandwidth in scalars of a Hessian whose 6x6 blocks lie
    at most ``half_bandwidth`` poses off the diagonal."""
    return 6 * half_bandwidth + 5


def smem_bytes(b: int) -> int:
    """Dynamic shared memory of the kernel at bandwidth b (the layout of
    ``csrc/band_chol.cu``: two panels' columns transposed and their inverse
    pivots, the window's right-hand sides and its rows, each padded with a
    panel's width of zeros)."""
    rsp = b + 1 + PANEL
    groups = 1 + -(-b // PANEL)
    w = (groups + 1) * PANEL
    return 4 * (2 * PANEL * THREADS + 2 * PANEL + 4 + w + w * rsp)


def _fits(h: int) -> bool:
    b = scalar_bandwidth(h)
    return (smem_bytes(b) <= SMEM_LIMIT and PANEL + b + 1 <= THREADS
            and 2 * PANEL + b <= RING)


# the widest band (in poses off the diagonal) the kernel's window holds
MAX_HALF_BANDWIDTH = max(h for h in range(64) if _fits(h))


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load("band_chol").mloam_band_chol
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check_args(band, g, perm, dtypes=(torch.float32,)):
    if band.ndim != 2 or band.dtype not in dtypes:
        raise TypeError(f"band must be a {' or '.join(map(str, dtypes))} [N, b + 1] tensor")
    n_rows, w = band.shape
    if n_rows % 6 or n_rows == 0:
        raise ValueError("band must have 6 rows a pose")
    if (w - 6) % 6 or w < 6:
        raise ValueError("band must be 6 h + 6 columns wide (whole 6x6 blocks)")
    if g.shape != (n_rows,) or g.dtype != band.dtype:
        raise TypeError("g must be an [N] tensor of the band's type")
    if perm.shape != (n_rows // 6,) or perm.dtype != torch.int64:
        raise TypeError("perm must be an int64 [N / 6] tensor")
    if g.device != band.device or perm.device != band.device:
        raise ValueError("band, g and perm must lie on one device")


def band_solve(band: torch.Tensor, g: torch.Tensor, perm: torch.Tensor):
    """(x [N] in pose order solving A x = g, info) on CUDA tensors, the band
    overwritten by its factor. ``info`` (int32, 0-dim) is 0, or 1 + the
    first column (in the band's order) whose pivot is not positive or not
    finite; x is then not a solution."""
    global launches
    check_args(band, g, perm)
    if not band.is_cuda:
        raise ValueError("hopper_band_chol.band_solve takes CUDA tensors; solve() "
                         "routes CPU tensors to the plain version")
    b = band.shape[1] - 1
    if (b - 5) // 6 > MAX_HALF_BANDWIDTH:
        raise ValueError(f"a band of {b} scalars does not fit the kernel's window "
                         f"({smem_bytes(b)} of {SMEM_LIMIT} bytes)")
    if not band.is_contiguous() or band.data_ptr() % 16:
        raise ValueError("band must be contiguous and 16-byte aligned (it is factored "
                         "in place, its rows copied 16 bytes at a time)")
    fn = _kernel_fn()
    g = g.contiguous()
    perm = perm.contiguous()
    n_rows = band.shape[0]
    # scratch: the forward solution, a panel's width longer
    y = torch.empty(-(-n_rows // PANEL) * PANEL, dtype=torch.float32, device=band.device)
    x = torch.empty(n_rows, dtype=torch.float32, device=band.device)
    info = torch.empty((), dtype=torch.int32, device=band.device)
    with torch.cuda.device(band.device):
        err = fn(band.data_ptr(), g.data_ptr(), perm.data_ptr(), y.data_ptr(),
                 x.data_ptr(), info.data_ptr(), n_rows, b,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "band_chol")
    launches += 1
    return x, info


def band_solve_plain(band: torch.Tensor, g: torch.Tensor, perm: torch.Tensor):
    """The same function by the band unpacked to dense, ``cholesky_ex`` and
    ``cholesky_solve`` (``solve`` takes it for CPU tensors; float64 too, as
    a yardstick): (x, info), the band overwritten by its factor."""
    check_args(band, g, perm, (torch.float32, torch.float64))
    n_rows, w = band.shape
    r = torch.arange(n_rows, device=band.device)[:, None].expand(n_rows, w)
    c = r - torch.arange(w, device=band.device)
    inside = c >= 0
    A = torch.zeros((n_rows, n_rows), dtype=band.dtype, device=band.device)
    A[r[inside], c[inside]] = band[inside]
    L, info = torch.linalg.cholesky_ex(A)
    xp = torch.cholesky_solve(g.reshape(-1, 6)[perm].reshape(-1, 1), L)[:, 0]
    x = torch.empty_like(xp)
    x.reshape(-1, 6)[perm] = xp.reshape(-1, 6)
    band[inside] = L[r[inside], c[inside]]
    return x, info


def solve(band: torch.Tensor, g: torch.Tensor, perm: torch.Tensor):
    """``band_solve`` on CUDA tensors, ``band_solve_plain`` on CPU ones."""
    if band.is_cuda:
        return band_solve(band, g, perm)
    return band_solve_plain(band, g, perm)
