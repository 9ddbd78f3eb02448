"""Connected-component label propagation on the range image: the hand-written
CUDA kernel (``csrc/labels.cu``) and its plain PyTorch version.

Replaces the TPU kernel ``mloam_tpu/ops/pallas_labels.py:_label_kernel``
(entry ``propagate_labels_pallas``), same contract:

  labels  int32 [R, C], linear pixel index; non-clusterable cells = R*C
  conn_h  bool [R, C]: column c connected to c-1; ``conn_h[:, 0]`` carries the
          azimuth wrap flag (C-1 <-> 0)
  conn_v  bool [R, C]: row r connected to r-1 (row 0 is ignored)
  round   = row segmented-min over runs -> seam stitch -> row segmented-min
            again -> column segmented-min

or a batch of such images, ``[B, R, C]`` (1 <= B <= 65535), each labelled on
its own in its own index space (sink R*C): the TPU kernel under ``jax.vmap``,
as the JAX package's batched frontend runs it. The port's steady step labels
a uniform rig's images as one batch (``models/pipeline.py``). A batch is one
launch, as it is one dispatch there.

Bound on the H100: the image is a few hundred KB, so the bytes are well under
a microsecond of memory time and the cost is launches and barriers. The first
design took two launches a round (6 for the main path's 3 rounds). This one
is one launch for all rounds, as the TPU kernel is one dispatch: a cluster of
``min(R, 8)`` blocks per image, each block holding its rows in shared memory
for the whole call, with the column scan carried across blocks through
distributed shared memory; a batch's images lie along the grid's second axis.
An image whose block does not fit in shared memory raises ``ValueError``
before anything is built or launched. See the note in ``csrc/labels.cu``.

On a CUDA tensor ``propagate_labels`` launches the kernel or raises; the plain
version runs only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from mloam_tpu_torch.ops import _build

launches = 0  # kernel launches made by propagate_labels(), as the C entry counted them

MAX_SMEM = 232448  # bytes of shared memory a block can use on sm_90
MAX_CLUSTER = 8    # blocks of the cluster: the portable maximum
MAX_IMAGES = 65535  # images of a batch: the grid's second axis
_THREADS = 1024    # threads per block, as in csrc/labels.cu
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load("labels").mloam_propagate_labels
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def smem_bytes(r: int, c: int) -> int:
    """Shared memory one block of the cluster needs for an R x C image: its
    ceil(R / min(R, 8)) rows as int32 labels, int16 run starts and the two
    connection bytes, plus 24 bytes of partials and carries per column, the
    scan buffer and one int per row (the layout of ``csrc/labels.cu``)."""
    def a16(x):
        return (x + 15) & ~15
    rows = -(-r // min(r, MAX_CLUSTER))
    n = rows * c
    off = a16(4 * n)  # labels
    # column partials and carries, scan buffer, seam minima, run starts
    off = a16(off + 24 * c + 4 * _THREADS + 4 * rows + 2 * n)
    return a16(off + 2 * n)  # conn_h, conn_v


def check_fits(r: int, c: int):
    """Raise ``ValueError`` for an image the one-cluster kernel cannot hold
    (the same for every image of a batch)."""
    if c > 32767:
        raise ValueError(f"C = {c} columns: run starts are int16, C must be <= 32767")
    need = smem_bytes(r, c)
    if need > MAX_SMEM:
        raise ValueError(
            f"a {r}x{c} image needs {need} bytes of shared memory per block of a "
            f"{min(r, MAX_CLUSTER)}-block cluster; the limit is {MAX_SMEM}")


def _check_args(labels, conn_h, conn_v, rounds):
    if labels.ndim not in (2, 3) or labels.dtype != torch.int32:
        raise TypeError("labels must be an int32 [R, C] or [B, R, C] tensor")
    if labels.ndim == 3 and not 1 <= labels.shape[0] <= MAX_IMAGES:
        raise ValueError(f"a batch holds 1 to {MAX_IMAGES} images, not {labels.shape[0]}")
    for name, t in (("conn_h", conn_h), ("conn_v", conn_v)):
        if t.dtype != torch.bool or t.shape != labels.shape:
            raise TypeError(f"{name} must be a bool tensor of labels' shape")
        if t.device != labels.device:
            raise ValueError(f"{name} must lie on labels' device")
    if not isinstance(rounds, int) or rounds < 1:
        raise ValueError("rounds must be a positive int")


def _runs_min(lab: torch.Tensor, key: torch.Tensor, big: int) -> torch.Tensor:
    """Min of ``lab`` over cells sharing ``key`` (both flat), gathered back."""
    runmin = torch.full_like(lab, big)
    runmin.scatter_reduce_(0, key, lab, "amin", include_self=True)
    return runmin[key]


def propagate_labels_plain(labels: torch.Tensor, conn_h: torch.Tensor,
                           conn_v: torch.Tensor, rounds: int = 3) -> torch.Tensor:
    """The kernel's round structure in torch ops. A segmented min over runs is
    a ``cummax`` of run-start positions (the run key) followed by a
    scatter-min into the key's slot and a gather back. The images of a batch
    share one scatter: image b's run keys are offset by b*R*C."""
    _check_args(labels, conn_h, conn_v, rounds)
    shape = labels.shape
    r, c = shape[-2:]
    dev = labels.device
    big = r * c
    col = torch.arange(c, device=dev).expand(r, c)
    row = torch.arange(r, device=dev)[:, None].expand(r, c)
    # each image's first cell in the batch's flat index ([1, 1] for one image)
    base = (torch.arange(labels.numel() // big, device=dev) * big).reshape(
        shape[:-2] + (1, 1))
    # column 0 / row 0 always start a run
    head_h = (~conn_h) | (col == 0)
    head_v = (~conn_v) | (row == 0)
    start_h = torch.cummax(torch.where(head_h, col, 0), dim=-1).values
    start_v = torch.cummax(torch.where(head_v, row, 0), dim=-2).values
    key_h = (base + row * c + start_h).reshape(-1)
    key_v = (base + start_v * c + col).reshape(-1)
    wrap = conn_h[..., 0]

    lab = labels.reshape(-1).clone()
    for _ in range(rounds):
        lab = _runs_min(lab, key_h, big)
        l2 = lab.reshape(shape)
        m = torch.minimum(l2[..., 0], l2[..., c - 1])
        l2 = l2.clone()
        l2[..., 0] = torch.where(wrap, m, l2[..., 0])
        l2[..., c - 1] = torch.where(wrap, m, l2[..., c - 1])
        lab = _runs_min(l2.reshape(-1), key_h, big)
        lab = _runs_min(lab, key_v, big)
    return lab.reshape(shape)


def propagate_labels(labels: torch.Tensor, conn_h: torch.Tensor,
                     conn_v: torch.Tensor, rounds: int = 3) -> torch.Tensor:
    """``rounds`` rounds of label propagation over an image [R, C] or a batch
    [B, R, C]; returns int32 of the input's shape. A batch is one launch, and
    counts one."""
    if not labels.is_cuda:
        return propagate_labels_plain(labels, conn_h, conn_v, rounds)
    global launches
    _check_args(labels, conn_h, conn_v, rounds)
    r, c = labels.shape[-2:]
    check_fits(r, c)
    labels = labels.contiguous()
    conn_h = conn_h.contiguous()
    conn_v = conn_v.contiguous()
    out = torch.empty_like(labels)
    fn = _kernel_fn()
    n_launched = ctypes.c_int(0)
    with torch.cuda.device(labels.device):
        err = fn(labels.data_ptr(), conn_h.data_ptr(), conn_v.data_ptr(),
                 out.data_ptr(), labels.numel() // (r * c), r, c, rounds,
                 torch.cuda.current_stream().cuda_stream,
                 ctypes.byref(n_launched))
    launches += n_launched.value
    _build.check(err, "propagate_labels")
    return out
