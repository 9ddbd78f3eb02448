"""Device meshes: the shard layout and the collectives of the distributed
solvers.

Counterpart of ``mloam_tpu/parallel/mesh.py``. The JAX package runs SPMD
programs over a ``jax.sharding.Mesh`` (``shard_map``, ``psum``,
``all_gather``); here a ``Mesh`` holds the axis names and the shape, and
runs the collectives itself. Per-shard code is written once, against
``mesh.psum(x, axes)``, ``mesh.pmax(x, axes)``, ``mesh.all_gather(x, axes)``
and ``mesh.index_sum(values, index, n_out, axes)``, on tensors whose leading
axes are the mesh axes (``mesh.local_shape``). Two realizations:

  * ``StackedMesh`` (the default: one process, one device). Every shard is
    held: the leading axes have the mesh's shape, [P, ...] or [H, C, ...].
    ``psum`` over an axis is a sum over that dimension, ``all_gather`` a
    reshape. Any shape runs on one card (the 2x8 layout too).
  * ``ProcessMesh``: each rank of a ``torch.distributed`` group holds one
    shard, so the leading axes have size 1. ``psum`` is ``all_reduce`` over
    the sub-group of the reduced axes (built once with ``new_group``: one
    group per host row and one per chip column on a 2-D mesh), and
    ``all_gather`` is ``all_gather_into_tensor``. Gloo on the CPU, NCCL on
    GPUs; every collective waits at most ``timeout_s``.

A reduced axis keeps size 1 (a reduced value broadcasts against per-shard
ones), and a value that already has size 1 along a reduced axis is counted
once per shard, as ``psum`` of a replicated value is in JAX.

Each mesh counts the collectives it runs by axes: calls, and the bytes one
shard contributes (``collectives``). This is the counterpart of the JAX
package's reading of the same figures from compiled HLO
(``scaling_model.parse_collectives``).
"""

from __future__ import annotations

import datetime
import math

import torch

from mloam_tpu_torch import resolve_device
from mloam_tpu_torch.ops import segsum

FACTOR_AXIS = "factor"   # data-parallel over factors/edges/correspondences
MAP_AXIS = "map"         # sharding of map blocks / keyframes
HOST_AXIS = "host"       # cross-host axis


class Mesh:
    """Axis names, shape and collective counters; see the module note."""

    def __init__(self, shape, axis_names, device):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes {self.axis_names} differ")
        self.device = torch.device(device)
        self.collectives: dict[str, dict[str, int]] = {}

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def _dims(self, axes) -> tuple[int, ...]:
        if isinstance(axes, str):
            axes = (axes,)
        return tuple(sorted(self.axis_names.index(a) for a in axes))

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[d] for d in self._dims(axes))

    def _count(self, op: str, axes, x: torch.Tensor):
        key = op + ":" + "+".join(self.axis_names[d] for d in self._dims(axes))
        c = self.collectives.setdefault(key, {"calls": 0, "bytes": 0})
        c["calls"] += 1
        c["bytes"] += math.prod(x.shape[self.ndim:]) * x.element_size()

    def reset_counts(self):
        self.collectives = {}

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        self._count("psum", axes, x)
        return self._reduce(x, axes, "sum")

    def pmax(self, x: torch.Tensor, axes) -> torch.Tensor:
        self._count("pmax", axes, x)
        return self._reduce(x, axes, "max")

    def all_gather(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Every shard's ``x`` [*local, n, ...] along ``axes`` in mesh
        order, concatenated on the first data axis: [.., G·n, ...] (JAX's
        tiled ``all_gather``)."""
        self._count("all_gather", axes, x)
        g = self._gather(x, axes)                       # [*lead', G, n, ...]
        return g.reshape(g.shape[:self.ndim] + (-1,) + g.shape[self.ndim + 2:])

    def index_sum(self, values: torch.Tensor, index: torch.Tensor, n_out: int,
                  axes) -> torch.Tensor:
        """``segsum.index_sum`` of every shard's rows together, reduced over
        ``axes``: values [*local, N, ...], index [*local, N]. The fixed-point
        scale of each column comes from the bound over all shards (one small
        ``pmax``), the integer sums are ``psum``-reduced, so the result has
        the bits of one ``index_sum`` over the shards' rows concatenated."""
        nd = self.ndim
        n = index.shape[-1]
        flat = values.reshape(values.shape[:nd + 1] + (-1,))
        local_max = torch.amax(torch.abs(flat), dim=-2)
        bound = self.pmax(local_max, axes) * float(n * self.axis_size(axes))
        k = segsum.scale_exponent(bound)
        acc = self.psum(segsum.add_fixed(segsum.to_fixed(flat, k), index, n_out), axes)
        out = segsum.from_fixed(acc, k, bound, values.dtype)
        return out.reshape(out.shape[:nd + 1] + values.shape[nd + 1:])

    # ``local(x)``: a tensor with one row per shard [P, ...] (mesh order) ->
    # this process's shards, [*local_shape, ...], on the mesh's device;
    # ``local_shape`` and ``axis_index(axis)`` (the shards' coordinates along
    # an axis, broadcastable against [*local_shape]): each realization's own

    def shard(self, x) -> torch.Tensor:
        """Split the leading axis of ``x`` into ``size`` contiguous blocks
        in mesh order (JAX's ``P(axes)`` over every axis) -> [*local, m, ...]."""
        x = torch.as_tensor(x)
        if x.shape[0] % self.size:
            raise ValueError(f"{x.shape[0]} rows do not split over {self.size} shards")
        return self.local(x.reshape((self.size, -1) + tuple(x.shape[1:])))

    def replicated(self, x: torch.Tensor) -> torch.Tensor:
        """A reduced value [*1s, ...] without its leading mesh axes."""
        return x.reshape(x.shape[self.ndim:])


class StackedMesh(Mesh):
    """Every shard in one process: leading axes of the mesh's shape."""

    @property
    def local_shape(self) -> tuple[int, ...]:
        return self.shape

    def axis_index(self, axis: str) -> torch.Tensor:
        d = self.axis_names.index(axis)
        shape = [1] * self.ndim
        shape[d] = self.shape[d]
        return torch.arange(self.shape[d], device=self.device).reshape(shape)

    def _full(self, x, dims):
        shape = list(x.shape)
        for d in dims:
            shape[d] = self.shape[d]
        return x.expand(shape)

    def _reduce(self, x, axes, op):
        dims = self._dims(axes)
        x = self._full(x, dims)
        if op == "sum":
            return x.sum(dim=dims, keepdim=True)
        return torch.amax(x, dim=dims, keepdim=True)

    def _gather(self, x, axes):
        dims = self._dims(axes)
        x = self._full(x, dims)
        keep = [d for d in range(self.ndim) if d not in dims]
        y = x.permute(keep + list(dims) + list(range(self.ndim, x.ndim)))
        g = math.prod(x.shape[d] for d in dims)
        y = y.reshape([x.shape[d] for d in keep] + [g] + list(x.shape[self.ndim:]))
        # back to the mesh's axis order, the gathered axes at size 1
        lead = [1 if d in dims else x.shape[d] for d in range(self.ndim)]
        return y.reshape(lead + [g] + list(x.shape[self.ndim:]))

    def local(self, x) -> torch.Tensor:
        x = torch.as_tensor(x).to(self.device)
        return x.reshape(self.shape + tuple(x.shape[1:]))


class ProcessMesh(Mesh):
    """One shard per rank of the default ``torch.distributed`` group, rank
    r at mesh coordinate ``unravel(r, shape)``."""

    def __init__(self, shape, axis_names, device, timeout_s: float = 120.0):
        import torch.distributed as dist

        super().__init__(shape, axis_names, device)
        if dist.get_world_size() != self.size:
            raise ValueError(f"a {self.shape} mesh needs {self.size} ranks, "
                             f"the group has {dist.get_world_size()}")
        self.rank = dist.get_rank()
        self.timeout = datetime.timedelta(seconds=timeout_s)
        self.coords = []
        r = self.rank
        for s in reversed(self.shape):
            self.coords.insert(0, r % s)
            r //= s
        # one group for every subset of axes, each rank in it for its own
        # coordinates; every rank creates every group, in the same order
        self._groups = {}
        ranks = torch.arange(self.size).reshape(self.shape)
        for mask in range(1, 1 << self.ndim):
            dims = tuple(d for d in range(self.ndim) if mask >> d & 1)
            keep = [d for d in range(self.ndim) if d not in dims]
            blocks = ranks.permute(keep + list(dims)).reshape(-1, math.prod(
                self.shape[d] for d in dims))
            for row in blocks.tolist():
                grp = dist.new_group(row, timeout=self.timeout)
                if self.rank in row:
                    self._groups[dims] = (grp, row)

    @property
    def local_shape(self) -> tuple[int, ...]:
        return (1,) * self.ndim

    def axis_index(self, axis: str) -> torch.Tensor:
        c = self.coords[self.axis_names.index(axis)]
        return torch.full(self.local_shape, c, dtype=torch.int64, device=self.device)

    def _reduce(self, x, axes, op):
        import torch.distributed as dist

        grp, _ = self._groups[self._dims(axes)]
        y = x.contiguous().clone()
        red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
        dist.all_reduce(y, op=red, group=grp, async_op=True).wait(self.timeout)
        return y

    def _gather(self, x, axes):
        import torch.distributed as dist

        grp, row = self._groups[self._dims(axes)]
        x = x.contiguous()
        # ranks' tensors stacked on the first axis: [G, 1s..., n, ...]
        out = torch.empty((len(row),) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=grp, async_op=True).wait(self.timeout)
        return out.reshape((len(row),) + tuple(x.shape[self.ndim:])).reshape(
            self.local_shape + (len(row),) + tuple(x.shape[self.ndim:]))

    def local(self, x) -> torch.Tensor:
        x = torch.as_tensor(x)
        return x[self.rank].to(self.device).reshape(self.local_shape + tuple(x.shape[1:]))


def make_mesh(n_devices: int, axis: str = FACTOR_AXIS, device=None) -> StackedMesh:
    """A 1-D stacked mesh of ``n_devices`` shards."""
    return StackedMesh((n_devices,), (axis,), resolve_device(device))


def make_multihost_mesh(n_hosts: int, chips_per_host: int,
                        inner_axis: str = FACTOR_AXIS, device=None) -> StackedMesh:
    """A 2-D (host, chip) stacked mesh. Sharding a data axis over both axes
    and reducing over (host, inner) is the layout of the JAX package's
    multi-host programs: the in-host reduction first, one hop across hosts
    after."""
    return StackedMesh((n_hosts, chips_per_host), (HOST_AXIS, inner_axis),
                       resolve_device(device))


def make_process_mesh(shape, axis_names, device=None,
                      timeout_s: float = 120.0) -> ProcessMesh:
    """A mesh over the ranks of the initialised default ``torch.distributed``
    group (its world size must be the product of ``shape``)."""
    return ProcessMesh(shape, axis_names, resolve_device(device), timeout_s)


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """All mesh axis names, for sharding a big data axis over the whole
    mesh (1-D and 2-D meshes alike)."""
    return tuple(mesh.axis_names)
