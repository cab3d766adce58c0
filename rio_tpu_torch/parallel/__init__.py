"""Scale-out solves of the port: counterpart of ``rio_tpu/parallel``.

The reference shards the (objects x nodes) cost over a 2-D ``("obj",
"node")`` mesh and writes the Sinkhorn row and column normalizations as
explicit ``psum``/``pmax`` collectives inside ``shard_map``. Here the mesh
is a grid of torch devices (:mod:`rio_tpu_torch.parallel.mesh`: a device
may repeat), each ``shard_map`` body is a loop over this process's cells,
and each collective is an explicit reduction over the grid. The bodies are
the reference's plain arithmetic; neither hand-written kernel runs on
these paths, as no Pallas kernel runs inside the reference's.

- :func:`make_mesh`, :func:`shard_cost`, :func:`sharded_sinkhorn`,
  :func:`sharded_scaling_sinkhorn`, :func:`sharded_sinkhorn_assign`: the
  flat sharded solves;
- :mod:`rio_tpu_torch.parallel.hierarchical`: the two-level solve, on one
  device and over a mesh (``sharded_hierarchical_assign``,
  ``mesh_chunked_hierarchical_assign``);
- :mod:`rio_tpu_torch.parallel.multihost`: the mesh across processes on
  ``torch.distributed``.
"""

from __future__ import annotations

import torch

from .hierarchical import (
    HierarchicalResult,
    chunked_hierarchical_assign,
    chunked_hierarchical_assign_timed,
    hierarchical_assign,
)
from .mesh import (
    COL_SPEC,
    COST_SPEC,
    ROW_SPEC,
    Mesh,
    ShardedArray,
    concat,
    make_mesh,
    pmax,
    pmin,
    psum,
    shard,
)

__all__ = [
    "HierarchicalResult",
    "Mesh",
    "ShardedArray",
    "chunked_hierarchical_assign",
    "chunked_hierarchical_assign_timed",
    "hierarchical_assign",
    "make_mesh",
    "mesh_chunked_hierarchical_assign",
    "mesh_chunked_hierarchical_assign_timed",
    "shard_cost",
    "sharded_hierarchical_assign",
    "sharded_scaling_sinkhorn",
    "sharded_sinkhorn",
    "sharded_sinkhorn_assign",
]

_NEG_INF = float("-inf")


def __getattr__(name):
    # Lazy, as in the reference: the mesh forms of the two-level solve and
    # the multi-process layer load on first use.
    if name in (
        "sharded_hierarchical_assign",
        "mesh_chunked_hierarchical_assign",
        "mesh_chunked_hierarchical_assign_timed",
    ):
        from . import hierarchical

        return getattr(hierarchical, name)
    if name == "multihost":
        # importlib, not `from . import`: the from-import re-enters this
        # __getattr__ while the attribute is still unset.
        import importlib

        return importlib.import_module(".multihost", __name__)
    raise AttributeError(name)


def shard_cost(mesh: Mesh, cost) -> ShardedArray:
    """Place a cost matrix on the mesh, rows over "obj", columns over "node"."""
    cost = torch.as_tensor(cost)
    return ShardedArray(mesh, COST_SPEC, cost.shape, shard(mesh, cost, COST_SPEC))


def _dist_lse(mesh: Mesh, z: dict, axis: int, mesh_axis: str) -> dict:
    """Stable log-sum-exp of per-cell blocks ``z`` along ``axis``, across ``mesh_axis``.

    The reference's two-collective combine: the global max by ``pmax``,
    then a ``psum`` of exponentials re-based on it. A slice whose entries
    are all -inf keeps the base 0 (the ``isfinite(gmax)`` guard).
    """
    gmax = pmax(mesh, {c: b.amax(dim=axis) for c, b in z.items()}, mesh_axis)
    safe = {c: torch.where(torch.isfinite(m), m, 0.0) for c, m in gmax.items()}
    gsum = psum(
        mesh, {c: torch.exp(b - safe[c].unsqueeze(axis)).sum(dim=axis) for c, b in z.items()},
        mesh_axis,
    )
    return {c: safe[c] + torch.log(gsum[c].clamp_min(1e-30)) for c in z}


def _marginals(mesh: Mesh, cost, row_mass, col_capacity):
    """Float32 cost blocks and unit-mass marginals, normalized by a ``psum``
    of the shard sums."""
    c = {k: b.float() for k, b in shard(mesh, cost, COST_SPEC).items()}
    a = {k: b.float() for k, b in shard(mesh, row_mass, ROW_SPEC).items()}
    b = {k: x.float() for k, x in shard(mesh, col_capacity, COL_SPEC).items()}
    total_a = psum(mesh, {k: x.sum() for k, x in a.items()}, "obj")
    total_b = psum(mesh, {k: x.sum() for k, x in b.items()}, "node")
    a = {k: x / total_a[k].clamp_min(1e-30) for k, x in a.items()}
    b = {k: x / total_b[k].clamp_min(1e-30) for k, x in b.items()}
    return c, a, b


def sharded_sinkhorn(
    mesh: Mesh,
    cost,
    row_mass,
    col_capacity,
    *,
    eps: float = 0.05,
    n_iters: int = 50,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Log-domain Sinkhorn with the cost sharded on both mesh axes.

    Returns the potentials ``(f, g)`` whole, on ``mesh.home``. The
    semantics are :func:`rio_tpu_torch.ops.sinkhorn.sinkhorn`'s: rows of
    zero mass get ``f = -inf``, columns of zero capacity ``g = -inf``. Row
    updates reduce over "node", column updates over "obj": two collectives
    a direction.
    """
    c, a, b = _marginals(mesh, cost, row_mass, col_capacity)
    log_a = {k: torch.where(x > 0, torch.log(x.clamp_min(1e-30)), _NEG_INF) for k, x in a.items()}
    log_b = {k: torch.where(x > 0, torch.log(x.clamp_min(1e-30)), _NEG_INF) for k, x in b.items()}
    f = {k: torch.zeros(x.shape[0], dtype=torch.float32, device=x.device) for k, x in c.items()}
    g = {k: torch.zeros(x.shape[1], dtype=torch.float32, device=x.device) for k, x in c.items()}
    for _ in range(n_iters):
        lse = _dist_lse(mesh, {k: (g[k][None, :] - x) / eps for k, x in c.items()}, 1, "node")
        f = {k: torch.where(torch.isfinite(log_a[k]), eps * (log_a[k] - lse[k]), _NEG_INF) for k in c}
        lse = _dist_lse(mesh, {k: (f[k][:, None] - x) / eps for k, x in c.items()}, 0, "obj")
        g = {k: torch.where(torch.isfinite(log_b[k]), eps * (log_b[k] - lse[k]), _NEG_INF) for k in c}
    return concat(mesh, f, "obj"), concat(mesh, g, "node")


def sharded_scaling_sinkhorn(
    mesh: Mesh,
    cost,
    row_mass,
    col_capacity,
    *,
    eps: float = 0.05,
    n_iters: int = 50,
    kernel_dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scaling-form Sinkhorn-Knopp sharded over the 2-D mesh.

    ``K = exp(-(C - shift) / eps)`` is built shard-local in
    ``kernel_dtype`` with a PER-ROW gauge shift (the ``pmin`` of each row's
    minimum across the node shards): every row keeps its best entry at
    exp(0) = 1, so no row underflows whatever the cost range (a global
    shift breaks once range/eps >> 88). Each iteration is one local
    product and one ``psum`` a direction, each product in float32 on the
    ``kernel_dtype``-rounded values (JAX's ``preferred_element_type``).
    Returns log-domain potentials ``(f, g)`` whole, on ``mesh.home``.
    """
    c, a, b = _marginals(mesh, cost, row_mass, col_capacity)
    shift = pmin(mesh, {k: x.amin(dim=1) for k, x in c.items()}, "node")
    shift = {k: torch.where(torch.isfinite(s), s, 0.0) for k, s in shift.items()}
    Kf = {}
    for k, x in c.items():
        K = x - shift[k][:, None]  # a fresh tensor: the in-place steps never touch the cost
        K.div_(-eps).exp_()
        Kf[k] = K.to(kernel_dtype).float()
        del K
    u = {k: torch.zeros_like(x) for k, x in a.items()}
    v = {k: torch.ones_like(x) for k, x in b.items()}
    for _ in range(n_iters):
        Kv = psum(mesh, {k: K @ v[k].to(kernel_dtype).float() for k, K in Kf.items()}, "node")
        u = {k: torch.where(a[k] > 0, a[k] / Kv[k].clamp_min(1e-30), 0.0) for k in Kf}
        KTu = psum(mesh, {k: u[k].to(kernel_dtype).float() @ K for k, K in Kf.items()}, "obj")
        v = {k: torch.where(b[k] > 0, b[k] / KTu[k].clamp_min(1e-30), 0.0) for k in Kf}
    f = {
        k: torch.where(x > 0, eps * torch.log(x.clamp_min(1e-30)) + shift[k], _NEG_INF)
        for k, x in u.items()
    }
    g = {k: torch.where(x > 0, eps * torch.log(x.clamp_min(1e-30)), _NEG_INF) for k, x in v.items()}
    return concat(mesh, f, "obj"), concat(mesh, g, "node")


def _assign_with_g(mesh: Mesh, cost, g: torch.Tensor) -> torch.Tensor:
    """``argmin_j cost[i, j] - g[j]`` over the sharded cost: (n,) int32 on ``mesh.home``.

    Each shard takes its block's minimum and first arg-minimum; a ``pmin``
    of the values, then of the indices that reach it, gives the global
    first arg-minimum, as ``argmin`` over the whole row does.
    """
    g = torch.where(torch.isfinite(g), g, _NEG_INF)
    gb = shard(mesh, g, COL_SPEC)
    vals, idx = {}, {}
    for k, x in shard(mesh, cost, COST_SPEC).items():
        v, i = (x.float() - gb[k][None, :]).min(dim=1)
        vals[k], idx[k] = v, i + k[1] * x.shape[1]
    best = pmin(mesh, vals, "node")
    cand = {k: torch.where(vals[k] == best[k], idx[k], torch.iinfo(torch.int64).max) for k in vals}
    return concat(mesh, pmin(mesh, cand, "node"), "obj").to(torch.int32)


def sharded_sinkhorn_assign(
    mesh: Mesh,
    cost,
    row_mass,
    col_capacity,
    *,
    eps: float = 0.05,
    n_iters: int = 50,
) -> torch.Tensor:
    """Sharded solve, then the assignment ``argmin_j cost - g`` (int32)."""
    _, g = sharded_sinkhorn(mesh, cost, row_mass, col_capacity, eps=eps, n_iters=n_iters)
    return _assign_with_g(mesh, cost, g)
