"""The mesh across processes, on ``torch.distributed``.

Counterpart of ``rio_tpu/parallel/multihost.py``. Every process runs the
same program: :func:`initialize` joins the processes into one
``torch.distributed`` group, after which
:func:`~rio_tpu_torch.parallel.make_mesh` builds a grid that spans every
process's devices (each process passes its own, all the same count) and
every reduction of the sharded solves combines the processes' partials
with one ``all_reduce``. Each process computes only its own shards and
feeds only its own rows (:func:`process_rows`, :func:`distributed_array`);
the solvers' results come back whole on every process.

    from rio_tpu_torch.parallel import make_mesh, multihost, sharded_hierarchical_assign

    multihost.initialize("10.0.0.1:29500", num_processes=2, process_id=rank)
    mesh = make_mesh([f"cuda:{i}" for i in range(torch.cuda.device_count())])
    rows = multihost.process_rows(n_objects, mesh)
    obj_feat = multihost.distributed_array(mesh, (("obj", "node"), None), local_rows)
    res = sharded_hierarchical_assign(mesh, obj_feat, ...)

In a single process with no group every function degrades to the local
equivalent, so the same program text runs everywhere.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

from .mesh import AXES, Mesh, ShardedArray, block_index, block_slices, group_up

log = logging.getLogger(__name__)

__all__ = ["distributed_array", "initialize", "is_multihost", "process_rows"]

_ENV = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
    *,
    backend: str | None = None,
    timeout: float = 60.0,
) -> bool:
    """Idempotent ``torch.distributed.init_process_group``; True iff multi-process.

    - A group already up: nothing to do.
    - No arguments and none of ``MASTER_ADDR``/``RANK``/``WORLD_SIZE`` in
      the environment: single process, returns False.
    - No arguments and all of them: ``init_method="env://"``.
    - Otherwise all three of ``coordinator_address`` (``host:port``),
      ``num_processes`` and ``process_id`` are needed: explicit but partial
      multi-process intent raises ``ValueError``, as does a partial
      environment, so that a launcher's mistake never runs as 1 of 1.

    ``backend`` defaults to NCCL for CUDA devices (``local_device_ids``
    given, or CUDA available) and gloo on the CPU; ``local_device_ids[0]``
    becomes this process's current CUDA device. ``timeout`` (seconds)
    bounds the rendezvous and every collective.
    """
    if group_up():
        return dist.get_world_size() > 1
    explicit = (coordinator_address, num_processes, process_id)
    if all(x is None for x in explicit):
        present = [k for k in _ENV if os.environ.get(k)]
        if not present:
            log.debug("no process group configured; staying single-process")
            return False
        if len(present) != len(_ENV):
            raise ValueError(f"partial process-group environment: {present} of {list(_ENV)}")
        init_method, world, rank = "env://", None, None
    elif any(x is None for x in explicit):
        raise ValueError(
            "coordinator_address, num_processes and process_id must all be given "
            f"(got {coordinator_address!r}, {num_processes!r}, {process_id!r})"
        )
    else:
        init_method, world, rank = f"tcp://{coordinator_address}", int(num_processes), int(process_id)
    cuda = local_device_ids is not None or torch.cuda.is_available()
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if local_device_ids is not None:
        torch.cuda.set_device(int(list(local_device_ids)[0]))
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout),
    )
    return dist.get_world_size() > 1


def is_multihost() -> bool:
    """True iff this process is one of several in a process group."""
    return group_up() and dist.get_world_size() > 1


def process_rows(n_global: int, mesh: Mesh, axis: str | tuple[str, ...] | None = None) -> slice:
    """The global row range this PROCESS supplies for ``n_global`` rows
    sharded over ``axis`` (default: every mesh axis, in order, the layout
    the sharded solvers use).

    Rows follow the grid's cell order, as :func:`distributed_array` lays
    them out. Raises ``ValueError`` when this process owns no cell or its
    shards are not contiguous.
    """
    entry = AXES if axis is None else axis
    owned = sorted({block_index(mesh, entry, c)[0] for c in mesh.local_cells})
    _, count = block_index(mesh, entry, mesh.local_cells[0])
    per_shard, rem = divmod(n_global, count)
    if rem:
        raise ValueError(f"{n_global} rows do not split into {count} shards")
    lo, hi = owned[0], owned[-1]
    if owned != list(range(lo, hi + 1)):
        raise ValueError(f"process {mesh.rank} owns non-contiguous shards {owned}")
    return slice(lo * per_shard, (hi + 1) * per_shard)


def distributed_array(mesh: Mesh, spec, local_data) -> ShardedArray:
    """A globally sharded array from this process's rows, never built whole.

    ``spec`` shards dimension 0 (and possibly others); ``local_data`` holds
    this process's rows (:func:`process_rows` over dimension 0's axes) and
    the whole extent of every other dimension. Each block is a view of
    ``local_data`` where the cell's device is its device. In one process
    this is the array sharded onto the mesh's devices.
    """
    local = torch.as_tensor(local_data)
    owned = {block_index(mesh, spec[0], c)[0] for c in mesh.local_cells}
    shards = block_index(mesh, spec[0], mesh.local_cells[0])[1]
    n_global = local.shape[0] * shards // len(owned)
    lo = process_rows(n_global, mesh, spec[0]).start
    shape = (n_global, *local.shape[1:])
    blocks = {}
    for cell in mesh.local_cells:
        rows, *rest = block_slices(mesh, spec, shape, cell)
        block = local[(slice(rows.start - lo, rows.stop - lo), *rest)]
        blocks[cell] = block.to(mesh.devices[cell])
    return ShardedArray(mesh, spec, shape, blocks)
