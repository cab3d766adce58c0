"""The port's device mesh: a 2-D ("obj", "node") grid of torch devices.

Counterpart of the ``jax.sharding.Mesh`` that ``rio_tpu.parallel`` builds
and of the collectives its ``shard_map`` bodies call. The reference is
single-controller: one process drives every shard of the mesh. So is this
model, with two differences that PyTorch asks for:

- **A device may repeat.** Eight shards on ``"cpu"`` are the tests' mesh
  (the reference's tests use eight virtual CPU devices), eight shards on
  ``cuda:0`` run the sharded arithmetic at full size on one card, and a
  machine with several cards puts one shard on each.
- **Sharded values are explicit blocks.** A value sharded by a spec is a
  dict from grid cell to that cell's block (:func:`shard`); a block on the
  source tensor's device is a view, never a copy, so eight shards on one
  card hold a cost once. :class:`ShardedArray` carries such blocks with
  their mesh and spec (what :func:`~rio_tpu_torch.parallel.shard_cost` and
  :func:`~rio_tpu_torch.parallel.multihost.distributed_array` return).

A spec has one entry per dimension: ``None`` (replicated), an axis name, or
a tuple of axis names (the dimension is split over those axes, row-major).

The collectives ``psum``/``pmax``/``pmin``/``pmean`` (:func:`reduce`)
reduce over the cells that differ only along the named axes: in ascending
cell order, on the device of the group's first cell, and the result goes
back to each cell's device. A fixed order makes repeated runs equal. When
the mesh was built while a ``torch.distributed`` process group was up
(:func:`make_mesh`), the grid spans every process and each process holds
only its own cells: the cross-process part of every reduction is one
``torch.distributed.all_reduce``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

AXES = ("obj", "node")

# The specs of the sharded solvers' operands.
COST_SPEC = ("obj", "node")
ROW_SPEC = ("obj",)
COL_SPEC = ("node",)
ROWS_SPEC = (AXES, None)  # rows over every axis: the data-parallel layout

_DIST_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}
_COMBINE = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}


def group_up() -> bool:
    """Whether a ``torch.distributed`` process group is initialized."""
    return dist.is_available() and dist.is_initialized()


def _object_grid(items, shape) -> np.ndarray:
    grid = np.empty(len(items), dtype=object)
    for k, x in enumerate(items):  # one by one: numpy would unpack sequences
        grid[k] = x
    return grid.reshape(shape)


class Mesh:
    """A 2-D grid of torch devices with named axes.

    ``devices`` is the (obj, node) numpy object array of ``torch.device``
    (``.size``, ``.shape``); ``axis_names`` is ``("obj", "node")``;
    ``shape`` maps each axis name to its size. ``ranks`` holds the process
    that owns each cell: all 0 unless the mesh was built with a process
    group up, in which case ``distributed`` is true and every reduction
    crosses processes through ``torch.distributed``.
    """

    def __init__(self, devices: np.ndarray, axis_names=AXES, *, ranks=None) -> None:
        if devices.ndim != 2 or tuple(axis_names) != AXES:
            raise ValueError(f"a mesh is a 2-D {AXES} grid, got {devices.shape} {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.distributed = ranks is not None
        self.ranks = np.zeros(devices.shape, np.int64) if ranks is None else np.asarray(ranks)
        self.rank = dist.get_rank() if self.distributed else 0
        self.local_cells = [c for c in np.ndindex(devices.shape) if self.ranks[c] == self.rank]
        if not self.local_cells:
            raise ValueError(f"process {self.rank} owns no cell of this mesh")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def home(self) -> torch.device:
        """The device of this process's first cell: where results are gathered."""
        return self.devices[self.local_cells[0]]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={sorted({str(d) for d in self.devices.flat})})"


def make_mesh(devices=None, *, obj_axis: int | None = None) -> Mesh:
    """Build a 2-D ("obj", "node") mesh over the given devices (or every CUDA device).

    The object axis gets the larger factor, as in the reference: 8 -> (4, 2),
    7 -> (7, 1); ``obj_axis=2`` over 8 gives (2, 4). A device may repeat.
    With ``devices=None`` it takes every CUDA device and raises
    ``RuntimeError`` when there is none: it never picks the CPU on its own.

    With a process group up, ``devices`` are this process's local devices
    and every process must pass as many: the grid spans ``world_size x
    len(devices)`` cells in rank order, and the call is collective.
    """
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not count:
            raise RuntimeError(
                "make_mesh() uses every CUDA device and none is available; "
                "pass devices, e.g. ['cpu'] * 8"
            )
        devices = [torch.device("cuda", i) for i in range(count)]
    local = [torch.device(d) for d in devices]
    if not local:
        raise ValueError("make_mesh needs at least one device")
    every, ranks = local, None
    if group_up():
        per_rank: list = [None] * dist.get_world_size()
        dist.all_gather_object(per_rank, [str(d) for d in local])
        if len({len(r) for r in per_rank}) != 1:
            raise ValueError(
                f"every process must pass the same number of devices, got {[len(r) for r in per_rank]}"
            )
        every = [torch.device(d) for r in per_rank for d in r]
        ranks = [k for k, r in enumerate(per_rank) for _ in r]
    n = len(every)
    if obj_axis is None:
        obj_axis, node_axis = n, 1
        for cand in range(math.isqrt(n), 0, -1):  # 2-D when n is not prime
            if n % cand == 0:
                obj_axis, node_axis = n // cand, cand
                break
    else:
        if n % obj_axis:
            raise ValueError(f"obj_axis={obj_axis} does not divide {n} devices")
        node_axis = n // obj_axis
    shape = (obj_axis, node_axis)
    return Mesh(
        _object_grid(every, shape), ranks=None if ranks is None else np.reshape(ranks, shape)
    )


# ----------------------------------------------------------------- blocks


def _dim_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def block_index(mesh: Mesh, entry, cell) -> tuple[int, int]:
    """``(index, count)`` of ``cell``'s block along a dimension sharded as ``entry``."""
    axes = _dim_axes(entry)
    sizes = [mesh.shape[a] for a in axes]
    coords = [cell[mesh.axis_names.index(a)] for a in axes]
    if not axes:
        return 0, 1
    return int(np.ravel_multi_index(coords, sizes)), math.prod(sizes)


def block_slices(mesh: Mesh, spec, shape, cell) -> tuple[slice, ...]:
    slices = []
    for dim, size in enumerate(shape):
        idx, count = block_index(mesh, spec[dim] if dim < len(spec) else None, cell)
        if size % count:
            raise ValueError(f"dimension {dim} of size {size} does not split into {count} blocks")
        step = size // count
        slices.append(slice(idx * step, (idx + 1) * step))
    return tuple(slices)


class ShardedArray:
    """A global array held as blocks of ``mesh``'s cells under ``spec``.

    ``blocks`` maps each of this process's cells to its block. ``shape`` is
    the global shape; :meth:`gather` assembles the whole array.
    """

    def __init__(self, mesh: Mesh, spec, shape, blocks: dict) -> None:
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shape = tuple(shape)
        self.blocks = blocks

    def gather(self) -> torch.Tensor:
        """The whole array on ``mesh.home`` (across processes, one all-reduce)."""
        first = next(iter(self.blocks.values()))
        out = torch.zeros(self.shape, dtype=first.dtype, device=self.mesh.home)
        owned = _canonical_cells(self.mesh, self.spec)
        for cell, block in self.blocks.items():
            if cell in owned:
                out[block_slices(self.mesh, self.spec, self.shape, cell)] = block.to(out.device)
        if self.mesh.distributed:
            dist.all_reduce(out)
        return out


def _canonical_cells(mesh: Mesh, spec) -> set:
    """The first cell (in cell order) that holds each distinct block."""
    seen, cells = set(), set()
    for cell in np.ndindex(mesh.devices.shape):
        key = tuple(block_index(mesh, e, cell)[0] for e in spec)
        if key not in seen:
            seen.add(key)
            cells.add(cell)
    return cells


def shard(mesh: Mesh, x, spec) -> dict:
    """This process's blocks of ``x`` under ``spec``, each on its cell's device.

    ``x`` is a :class:`ShardedArray` of the same mesh and spec (its blocks
    are returned as they are) or a whole tensor (or array): a block on the
    tensor's device is a view, never a copy; other blocks are copied once
    per device.
    """
    if isinstance(x, ShardedArray):
        if x.mesh is not mesh or x.spec != tuple(spec):
            raise ValueError(f"sharded as {x.spec} on another mesh, want {tuple(spec)}")
        return x.blocks
    x = torch.as_tensor(x)
    out, copies = {}, {}
    for cell in mesh.local_cells:
        slices = block_slices(mesh, spec, x.shape, cell)
        dev = mesh.devices[cell]
        key = (str(dev), tuple((s.start, s.stop) for s in slices))
        if key not in copies:
            block = x[slices]
            copies[key] = block if block.device == dev else block.to(dev)
        out[cell] = copies[key]
    return out


def replicate(mesh: Mesh, *tensors) -> dict:
    """``tensors`` on every local cell's device (one copy per device): cell -> tuple."""
    per_device: dict = {}
    out = {}
    for cell in mesh.local_cells:
        dev = mesh.devices[cell]
        if str(dev) not in per_device:
            per_device[str(dev)] = tuple(torch.as_tensor(t).to(dev) for t in tensors)
        out[cell] = per_device[str(dev)]
    return out


def concat(mesh: Mesh, parts: dict, entry) -> torch.Tensor:
    """Assemble a vector from per-cell pieces split along ``entry``'s axes.

    Pieces are replicated over the other axes; each distinct piece is read
    from its first cell. The result is on ``mesh.home``; across processes
    it is complete on every process.
    """
    spec = (entry,)
    first = next(iter(parts.values()))
    _, count = block_index(mesh, entry, mesh.local_cells[0])
    shape = (first.shape[0] * count, *first.shape[1:])
    return ShardedArray(mesh, spec, shape, parts).gather()


# ------------------------------------------------------------ collectives


def _identity(op: str, dtype: torch.dtype) -> float | int:
    if op == "sum":
        return 0
    info = torch.finfo(dtype) if dtype.is_floating_point else torch.iinfo(dtype)
    big = float("inf") if dtype.is_floating_point else info.max
    return -big if op == "max" else big


def reduce(mesh: Mesh, parts: dict, axes, op: str) -> dict:
    """``psum``/``pmax``/``pmin`` of per-cell values over the mesh ``axes``.

    ``axes`` is one axis name or a tuple of them; ``op`` is ``"sum"``,
    ``"max"`` or ``"min"``. Cells that differ only along ``axes`` form a
    group; each group reduces in ascending cell order on its first cell's
    device, then, on a distributed mesh, one ``all_reduce`` combines every
    group's partials across processes. Returns cell -> the group's result
    on the cell's device.
    """
    pos = [mesh.axis_names.index(a) for a in _dim_axes(axes)]

    def group(cell):
        return tuple(c for k, c in enumerate(cell) if k not in pos)

    fn = _COMBINE[op]
    partial: dict = {}
    for cell in sorted(parts):
        key, value = group(cell), parts[cell]
        partial[key] = value if key not in partial else fn(partial[key], value.to(partial[key].device))
    if mesh.distributed:
        keys = sorted({group(c) for c in np.ndindex(mesh.devices.shape)})
        first = next(iter(partial.values()))
        stacked = torch.full(
            (len(keys), *first.shape), _identity(op, first.dtype), dtype=first.dtype, device=first.device
        )
        for k, key in enumerate(keys):
            if key in partial:
                stacked[k] = partial[key].to(first.device)
        dist.all_reduce(stacked, op=getattr(dist.ReduceOp, _DIST_OPS[op]))
        partial = {key: stacked[k] for k, key in enumerate(keys) if key in partial}
    out, moved = {}, {}
    for cell in parts:
        key, dev = group(cell), mesh.devices[cell]
        if (key, str(dev)) not in moved:
            value = partial[key]
            moved[key, str(dev)] = value if value.device == dev else value.to(dev)
        out[cell] = moved[key, str(dev)]
    return out


def psum(mesh: Mesh, parts: dict, axes) -> dict:
    return reduce(mesh, parts, axes, "sum")


def pmax(mesh: Mesh, parts: dict, axes) -> dict:
    return reduce(mesh, parts, axes, "max")


def pmin(mesh: Mesh, parts: dict, axes) -> dict:
    return reduce(mesh, parts, axes, "min")


def pmean(mesh: Mesh, parts: dict, axes) -> dict:
    size = math.prod(mesh.shape[a] for a in _dim_axes(axes))
    return {cell: s / size for cell, s in psum(mesh, parts, axes).items()}
