"""Two-level (hierarchical) optimal-transport placement, on one device or a mesh.

Counterpart of ``rio_tpu/parallel/hierarchical.py``.
The 1k-node x 10M-object tier cannot build a flat cost matrix: 10M x 1k
float32 is 40 GB. The two-level solve replaces it with two bounded stages
over a factorized affinity (object features x node features):

1. **Coarse**: nodes are split into ``G`` groups of ``S`` consecutive nodes.
   Each object scores each group by its best live member, and one (N x G)
   scaling Sinkhorn solve, CDF rounding and exact-quota repair assign every
   object a group, with group quotas following group capacity.
2. **Fine**: objects are bucketed by group (a fixed bucket size; the
   sentinel ``N`` pads each bucket), and the ``G`` (B x S) problems are
   solved together on (G, B, S) tensors: one batched solve, rounding and
   repair (the JAX fine stage is a ``jax.vmap`` of one problem).

Peak memory is O(N*G + G*B*S + N*d), never O(N*M).

:func:`chunked_hierarchical_assign` solves the object axis in chunks, each
against ``1/n_chunks`` of every node's capacity. The JAX form runs the
chunks under ``lax.map`` in one executable, so that the TPU compiles one
chunk shape. Eager PyTorch compiles nothing, so here both forms are the
same host loop; :func:`chunked_hierarchical_assign_timed` adds one device
synchronisation and a wall time per chunk. The JAX twin's buffer donation
has no counterpart.

Over a mesh (:mod:`rio_tpu_torch.parallel.mesh`) the object axis is
embarrassingly parallel: :func:`sharded_hierarchical_assign` gives every
shard its rows and ``1/n_shards`` of each node's capacity, and
:func:`mesh_chunked_hierarchical_assign` splits each shard's rows into
chunks too, every (shard, chunk) cell solving against ``cap / (n_shards *
n_chunks)``, divided in one step. Each cell is one :func:`hierarchical_assign`
call, so an 8-shard x 4-chunk solve equals the single-device 32-chunk
:func:`chunked_hierarchical_assign` row for row. Overflow is summed; the
coarse potentials and residual are the mean over shards (of each shard's
last chunk), a valid warm seed because every cell solves the same capacity
proportions. The reference's ``shard_map`` check switch and its cached
jitted cell solver (``_shard_map_check_kw``, ``_mesh_cell_solver``) have no
counterpart: nothing here is traced or compiled.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from ..ops.prng import sqrt_rn
from ..ops.scaling import scaling_sinkhorn
from ..ops.sinkhorn import exact_quota_repair, plan_rounded_assign, route_sentinel_spill
from .mesh import AXES, ROWS_SPEC, Mesh, concat, pmean, psum, replicate, shard

__all__ = [
    "HierarchicalResult",
    "chunked_hierarchical_assign",
    "chunked_hierarchical_assign_timed",
    "hierarchical_assign",
    "mesh_chunked_hierarchical_assign",
    "mesh_chunked_hierarchical_assign_timed",
    "sharded_hierarchical_assign",
]

# The coarse stage scores all objects against one block of groups at a
# time: an (N, groups_in_block * S) product of at most this many float32
# elements (256 MiB), where JAX maps over single groups.
_COARSE_BLOCK_ELEMS = 1 << 26


class HierarchicalResult(NamedTuple):
    assignment: torch.Tensor  # (N,) int32 global node index
    group: torch.Tensor  # (N,) int32 coarse group index
    overflow: torch.Tensor  # scalar int32: objects that missed their bucket
    # (G,) coarse-stage group potentials: the warm seed for the next
    # (delta) solve's coarse stage.
    coarse_g: torch.Tensor | None = None
    # Scalar final L1 column-marginal violation of the coarse solve.
    coarse_err: torch.Tensor | None = None


def _population_std(x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """``jnp.std(x, where=mask)``: two passes, ddof 0, over the entries where
    ``mask``, with a correctly rounded root as XLA's."""
    if mask is None:
        return sqrt_rn(((x - x.mean()) ** 2).mean())
    count = mask.sum()
    mean = torch.where(mask, x, 0.0).sum() / count
    return sqrt_rn((torch.where(mask, x - mean, 0.0) ** 2).sum() / count)


def hierarchical_assign(
    obj_feat: torch.Tensor,
    node_feat: torch.Tensor,
    node_capacity: torch.Tensor,
    alive: torch.Tensor,
    *,
    n_groups: int,
    bucket: int | None = None,
    eps: float = 0.05,
    coarse_iters: int = 30,
    fine_iters: int = 30,
    coarse_g_init: torch.Tensor | None = None,
) -> HierarchicalResult:
    """Two-level OT assignment over factorized affinity, on the inputs' device.

    Args:
      obj_feat: (N, d) object features.
      node_feat: (d, M) node features; affinity[i, j] = obj_feat[i] @ node_feat[:, j].
      node_capacity: (M,) capacity per node (0 = retired slot).
      alive: (M,) liveness in {0.0, 1.0}; dead nodes attract nothing.
      n_groups: number of node groups; M must be divisible by it.
      bucket: per-group object bucket size. Defaults to ``ceil(1.25 * N / G)``
        rounded up to a multiple of 8; objects past it fall back to their
        group's highest-capacity member.
      coarse_g_init: optional (G,) warm-start potentials for the coarse
        solve (the previous solve's ``coarse_g``). The fine stage starts cold.
    """
    n, d = obj_feat.shape
    d2, m = node_feat.shape
    assert d == d2 and m % n_groups == 0, (obj_feat.shape, node_feat.shape, n_groups)
    s = m // n_groups
    if bucket is None:
        bucket = -(-int(1.25 * n) // n_groups)
        bucket = -(-bucket // 8) * 8
    dev = obj_feat.device
    obj_feat = obj_feat.float()
    node_feat = node_feat.float()
    cap = node_capacity.float() * alive.float()

    # ---- stage 1: coarse obj -> group -------------------------------------
    # Coarse affinity = the object's best LIVE member in each group (a mean
    # embedding would dilute a single warm node by 1/S).
    alive_grouped = (cap > 0).reshape(n_groups, s)
    group_cap = cap.reshape(n_groups, s).sum(dim=1)  # (G,)
    coarse_aff = torch.empty((n, n_groups), dtype=torch.float32, device=dev)
    block = max(1, min(n_groups, _COARSE_BLOCK_ELEMS // max(1, n * s)))
    for g0 in range(0, n_groups, block):
        g1 = min(n_groups, g0 + block)
        scores = (obj_feat @ node_feat[:, g0 * s : g1 * s]).view(n, g1 - g0, s)
        scores = scores.masked_fill(~alive_grouped[g0:g1], float("-inf"))
        coarse_aff[:, g0:g1] = scores.amax(dim=-1)
    live_group = group_cap > 0  # (G,)
    raw_cost = -coarse_aff  # (N, G); +inf on all-dead groups
    # Normalize the cost scale over LIVE groups only (eps becomes a relative
    # knob), then a finite terrible cost on dead groups (their zero capacity
    # already excludes them from the marginals).
    std = _population_std(raw_cost, live_group[None, :].expand_as(raw_cost))
    coarse_cost = torch.where(live_group[None, :], raw_cost / std.clamp_min(1e-6), 1e6)
    mass = torch.ones(n, dtype=torch.float32, device=dev)
    res_c = scaling_sinkhorn(
        coarse_cost, mass, group_cap, eps=eps, n_iters=coarse_iters, g_init=coarse_g_init,
    )
    group = plan_rounded_assign(coarse_cost, res_c.f, res_c.g, eps)  # (N,)
    # Exact group quotas, so a bucket sized >= the largest quota cannot
    # overflow.
    group = exact_quota_repair(group, group_cap / group_cap.sum().clamp_min(1e-30) * n)

    # ---- bucket objects by group ------------------------------------------
    # Rank within group via a stable sort by group id: each group's objects
    # are a contiguous run of the sorted order.
    order = torch.argsort(group, stable=True)
    sorted_group = group[order].long()
    counts = torch.bincount(group, minlength=n_groups)
    starts = torch.cumsum(counts, dim=0) - counts
    rank = torch.arange(n, device=dev) - starts[sorted_group]
    in_bucket = rank < bucket
    overflow = (~in_bucket).sum().to(torch.int32)
    # The (G, bucket) table of object ids, sentinel N for padding. JAX
    # scatters overflow rows to an out-of-range slot and drops them; only
    # in-bucket rows are written here.
    flat = torch.full((n_groups * bucket,), n, dtype=torch.int64, device=dev)
    flat[(sorted_group * bucket + rank)[in_bucket]] = order[in_bucket]
    idx = flat.view(n_groups, bucket)

    # ---- stage 2: the G fine problems, batched ----------------------------
    obj_feat_pad = torch.cat([obj_feat, obj_feat.new_zeros((1, d))])
    feat_b = obj_feat_pad[idx]  # (G, B, d); padding reads the zero row
    node_feat_g = node_feat.reshape(d, n_groups, s).permute(1, 0, 2)  # (G, d, S)
    fine_cost = -torch.bmm(feat_b, node_feat_g)  # (G, B, S)
    # One scale over all (G, B, S) entries, padding rows included.
    fine_cost = fine_cost / _population_std(fine_cost).clamp_min(1e-6)
    fine_mass = (idx < n).float()  # (G, B)
    real = fine_mass > 0
    cap_g = cap.reshape(n_groups, s)  # (G, S)
    res_f = scaling_sinkhorn(fine_cost, fine_mass, cap_g, eps=eps, n_iters=fine_iters)
    local = plan_rounded_assign(fine_cost, res_f.f, res_f.g, eps)  # (G, B)
    # Exact per-node quotas within each group: padding rows go to a
    # sentinel column s sized to their count, so real rows land exactly on
    # capacity shares of the group's real population.
    n_real = fine_mass.sum(dim=-1, keepdim=True)  # (G, 1)
    local = torch.where(real, local, s)
    expected = torch.cat(
        [cap_g / cap_g.sum(dim=-1, keepdim=True).clamp_min(1e-30) * n_real, bucket - n_real],
        dim=-1,
    )
    repaired = exact_quota_repair(local, expected)
    # Real rows left on the sentinel go to the group's best live member.
    fine_local = route_sentinel_spill(repaired, real, s, cap_g)  # (G, B) in [0, S]
    members = torch.arange(m, device=dev).view(n_groups, s)
    # Padding rows keep the sentinel s; their writes are dropped below.
    fine_global = members.gather(1, fine_local.long().clamp_max(s - 1))  # (G, B)

    # ---- map back to object order -----------------------------------------
    assignment = torch.zeros(n, dtype=torch.int32, device=dev)
    flat_idx = idx.reshape(-1)
    seated = flat_idx < n
    assignment[flat_idx[seated]] = fine_global.reshape(-1)[seated].to(torch.int32)
    # Overflow objects (rank >= bucket) fall back to their group's
    # highest-capacity member.
    fallback = members.gather(1, cap_g.argmax(dim=1, keepdim=True))[:, 0].to(torch.int32)
    missed = torch.zeros(n, dtype=torch.bool, device=dev)
    missed[order] = ~in_bucket
    assignment = torch.where(missed, fallback[group.long()], assignment)
    return HierarchicalResult(
        assignment=assignment, group=group, overflow=overflow,
        coarse_g=res_c.g, coarse_err=res_c.err,
    )


def _solve_chunks(
    obj_feat, node_feat, node_capacity, alive, *, n_groups, n_chunks, coarse_g_init, timed, kw,
) -> tuple[HierarchicalResult, list[float]]:
    """The chunk loop of both chunked forms; wall ms per chunk when ``timed``."""
    n, d = obj_feat.shape
    assert n % n_chunks == 0, (n, n_chunks)
    of = obj_feat.reshape(n_chunks, n // n_chunks, d)
    cap_chunk = node_capacity / n_chunks

    def sync() -> None:
        if timed and obj_feat.device.type == "cuda":
            torch.cuda.synchronize(obj_feat.device)

    # Staged inputs first, so that no pending producer (feature generation)
    # drains inside chunk 0's timer.
    sync()
    parts: list[HierarchicalResult] = []
    chunk_ms: list[float] = []
    for c in range(n_chunks):
        t0 = time.perf_counter()
        res = hierarchical_assign(
            of[c], node_feat, cap_chunk, alive,
            n_groups=n_groups, coarse_g_init=coarse_g_init, **kw,
        )
        sync()
        if timed:
            chunk_ms.append(round((time.perf_counter() - t0) * 1e3, 3))
        parts.append(res)
    last = parts[-1]
    return (
        HierarchicalResult(
            assignment=torch.cat([r.assignment for r in parts]),
            group=torch.cat([r.group for r in parts]),
            overflow=torch.stack([r.overflow for r in parts]).sum().to(torch.int32),
            # Every chunk solves the same capacity proportions, so any
            # chunk's coarse potentials seed the next solve; keep the last.
            coarse_g=last.coarse_g,
            coarse_err=last.coarse_err,
        ),
        chunk_ms,
    )


def chunked_hierarchical_assign(
    obj_feat: torch.Tensor,
    node_feat: torch.Tensor,
    node_capacity: torch.Tensor,
    alive: torch.Tensor,
    *,
    n_groups: int,
    n_chunks: int,
    coarse_g_init: torch.Tensor | None = None,
    **kw,
) -> HierarchicalResult:
    """:func:`hierarchical_assign` over ``n_chunks`` equal slices of the objects.

    Each slice solves against ``1/n_chunks`` of every node's capacity, so
    per-chunk exact quota repair keeps node loads exact to chunk
    granularity. ``N`` must divide by ``n_chunks``.
    """
    res, _ = _solve_chunks(
        obj_feat, node_feat, node_capacity, alive, n_groups=n_groups,
        n_chunks=n_chunks, coarse_g_init=coarse_g_init, timed=False, kw=kw,
    )
    return res


def chunked_hierarchical_assign_timed(
    obj_feat: torch.Tensor,
    node_feat: torch.Tensor,
    node_capacity: torch.Tensor,
    alive: torch.Tensor,
    *,
    n_groups: int,
    n_chunks: int,
    coarse_g_init: torch.Tensor | None = None,
    **kw,
) -> tuple[HierarchicalResult, list[float]]:
    """:func:`chunked_hierarchical_assign` with a wall time per chunk.

    The same loop, with a device synchronisation before it and after each
    chunk, so each chunk's time holds its device work. Returns ``(result,
    chunk_ms)``; the result equals the untimed form's exactly.
    """
    return _solve_chunks(
        obj_feat, node_feat, node_capacity, alive, n_groups=n_groups,
        n_chunks=n_chunks, coarse_g_init=coarse_g_init, timed=True, kw=kw,
    )


# ---------------------------------------------------------------- on a mesh


def _mesh_inputs(mesh: Mesh, obj_feat, node_feat, node_capacity, alive, coarse_g_init, n_groups):
    """Object rows sharded over every mesh axis; node inputs replicated.

    Returns ``(rows, rep)``: cell -> row block, and cell -> ``(node_feat,
    node_capacity, alive, seed)`` on the cell's device. A missing warm seed
    becomes the zero seed, the same solve bit for bit (``v0 = exp(0) = 1``
    either way, see ``ops.scaling.scaling_core``).
    """
    if coarse_g_init is None:
        coarse_g_init = torch.zeros(n_groups, dtype=torch.float32)
    seed = torch.as_tensor(coarse_g_init, dtype=torch.float32)
    return shard(mesh, obj_feat, ROWS_SPEC), replicate(mesh, node_feat, node_capacity, alive, seed)


def _combine(mesh: Mesh, per_cell: dict) -> HierarchicalResult:
    """The mesh result from each cell's: rows in shard order on ``mesh.home``,
    overflow summed, coarse potentials and residual averaged over shards."""
    home = mesh.local_cells[0]
    return HierarchicalResult(
        assignment=concat(mesh, {c: r.assignment for c, r in per_cell.items()}, AXES),
        group=concat(mesh, {c: r.group for c, r in per_cell.items()}, AXES),
        overflow=psum(mesh, {c: r.overflow for c, r in per_cell.items()}, AXES)[home],
        coarse_g=pmean(mesh, {c: r.coarse_g for c, r in per_cell.items()}, AXES)[home],
        coarse_err=pmean(mesh, {c: r.coarse_err for c, r in per_cell.items()}, AXES)[home],
    )


def sharded_hierarchical_assign(
    mesh: Mesh,
    obj_feat,
    node_feat,
    node_capacity,
    alive,
    *,
    n_groups: int,
    coarse_g_init=None,
    **kw,
) -> HierarchicalResult:
    """Data-parallel hierarchical solve: objects sharded over the mesh.

    Every shard runs an independent two-level solve of its rows against
    ``1/n_shards`` of each node's capacity (marginal normalization spreads
    each shard's slice over the same capacity proportions), so the only
    collectives are the overflow ``psum`` and the ``pmean`` of the coarse
    potentials and residual into one warm seed; ``coarse_g_init`` threads
    the previous one back in. ``obj_feat`` is a whole (N, d) tensor or a
    :class:`~rio_tpu_torch.parallel.mesh.ShardedArray` of its rows; the
    result holds every row, in shard order, on ``mesh.home``.
    """
    rows, rep = _mesh_inputs(mesh, obj_feat, node_feat, node_capacity, alive, coarse_g_init, n_groups)
    per_cell = {}
    for cell in sorted(rows):
        nf, cap, al, g0 = rep[cell]
        per_cell[cell] = hierarchical_assign(
            rows[cell], nf, cap, al, n_groups=n_groups, coarse_g_init=g0, **kw
        )
    return _combine(mesh, per_cell)


def _solve_mesh_chunks(
    mesh, obj_feat, node_feat, node_capacity, alive, *, n_groups, n_chunks, coarse_g_init, timed, kw,
) -> tuple[HierarchicalResult, list[float]]:
    """The slab loop of both mesh x chunk forms; wall ms per slab when ``timed``.

    Slab ``c`` is every shard's chunk-``c`` cell; each cell is one
    :func:`hierarchical_assign` call against ``cap / (n_shards * n_chunks)``.
    """
    n_shards = int(mesh.devices.size)
    n = obj_feat.shape[0]
    assert n % (n_shards * n_chunks) == 0, (n, n_shards, n_chunks)
    scale = n_shards * n_chunks
    rows, rep = _mesh_inputs(mesh, obj_feat, node_feat, node_capacity, alive, coarse_g_init, n_groups)
    cells = sorted(rows)
    # Divide by the FULL scale in one step, once per device.
    cap_cell, by_device = {}, {}
    for cell in cells:
        cap = rep[cell][1]
        cap_cell[cell] = by_device.setdefault(str(cap.device), cap / scale)
    cuda = sorted({str(rows[c].device) for c in cells if rows[c].device.type == "cuda"})

    def sync() -> None:
        if timed:
            for dev in cuda:
                torch.cuda.synchronize(dev)

    # Staged inputs first, so that no pending producer drains inside slab 0's timer.
    sync()
    parts: dict = {c: [] for c in cells}
    chunk_ms: list[float] = []
    for c in range(n_chunks):
        t0 = time.perf_counter()
        for cell in cells:
            step = rows[cell].shape[0] // n_chunks
            nf, _, al, g0 = rep[cell]
            parts[cell].append(hierarchical_assign(
                rows[cell][c * step : (c + 1) * step], nf, cap_cell[cell], al,
                n_groups=n_groups, coarse_g_init=g0, **kw,
            ))
        sync()
        if timed:
            chunk_ms.append(round((time.perf_counter() - t0) * 1e3, 3))
    per_cell = {
        cell: HierarchicalResult(
            assignment=torch.cat([r.assignment for r in rs]),
            group=torch.cat([r.group for r in rs]),
            overflow=torch.stack([r.overflow for r in rs]).sum().to(torch.int32),
            # Each shard's last chunk, as the chunked solve keeps its last.
            coarse_g=rs[-1].coarse_g,
            coarse_err=rs[-1].coarse_err,
        )
        for cell, rs in parts.items()
    }
    return _combine(mesh, per_cell), chunk_ms


def mesh_chunked_hierarchical_assign(
    mesh: Mesh,
    obj_feat,
    node_feat,
    node_capacity,
    alive,
    *,
    n_groups: int,
    n_chunks: int,
    coarse_g_init=None,
    **kw,
) -> HierarchicalResult:
    """Mesh x chunk composed solve: shards AND chunks divide the rows.

    Every (shard, chunk) cell solves ``N / (n_shards * n_chunks)`` rows
    against ``1 / (n_shards * n_chunks)`` of each node's capacity. Overflow
    is summed; the coarse potentials are the mean over shards of each
    shard's last chunk. ``N`` must divide by ``n_shards * n_chunks``.
    """
    res, _ = _solve_mesh_chunks(
        mesh, obj_feat, node_feat, node_capacity, alive, n_groups=n_groups,
        n_chunks=n_chunks, coarse_g_init=coarse_g_init, timed=False, kw=kw,
    )
    return res


def mesh_chunked_hierarchical_assign_timed(
    mesh: Mesh,
    obj_feat,
    node_feat,
    node_capacity,
    alive,
    *,
    n_groups: int,
    n_chunks: int,
    coarse_g_init=None,
    **kw,
) -> tuple[HierarchicalResult, list[float]]:
    """:func:`mesh_chunked_hierarchical_assign` with a wall time per slab.

    The same loop, with a synchronisation of the mesh's CUDA devices before
    it and after each slab (every shard's cell of one chunk). Returns
    ``(result, chunk_ms)``; the result equals the untimed form's exactly.
    """
    return _solve_mesh_chunks(
        mesh, obj_feat, node_feat, node_capacity, alive, n_groups=n_groups,
        n_chunks=n_chunks, coarse_g_init=coarse_g_init, timed=True, kw=kw,
    )
