"""The placement steps: solve, capacity-aware rounding, exact-quota repair.

:func:`placement_step` is the counterpart of ``__graft_entry__.entry`` and of
the step that ``bench.py``'s solve tier times (``_solve_rate.step``):

1. a scaling-form Sinkhorn solve (:func:`~rio_tpu_torch.ops.scaling.scaling_core_auto`:
   the fused CUDA kernel on the card, the eager loop on the CPU);
2. capacity-aware CDF rounding from the scaling state, whole or ranked in
   row chunks, and the row-marginal check, both by
   :func:`~rio_tpu_torch.ops.cdf_round.cdf_round`: on the card one launch
   of the CDF-rounding kernel (one read of K for both), on the CPU its
   plain twin;
3. largest-remainder exact-quota repair
   (:func:`~rio_tpu_torch.ops.sinkhorn.exact_quota_repair`).

:func:`logdomain_placement_step` is the same step in the log domain: the
solve is the loop of :func:`~rio_tpu_torch.ops.pallas_sinkhorn.pallas_sinkhorn`
(one launch of the fused log-domain kernel per iteration on the card), and
the rounding from the potentials and the column-marginal error share one
read of the cost (:func:`~rio_tpu_torch.ops.logdomain_post.logdomain_post`:
on the card one launch of the post-solve kernel and one of its finalize).
Its spans are ``placement.step`` around ``logdomain.iterations``,
``logdomain.round``, ``logdomain.err`` and ``placement.repair``.

:func:`dryrun_multichip` is the counterpart of
``__graft_entry__.dryrun_multichip``: the sharded placement step over an
``n_devices``-shard mesh, held against the single-device solves with the
reference's bounds.

Everything runs on CUDA unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .device import resolve_device
from .kernels.launch import impl_for
from .ops.assignment import build_cost_matrix
from .ops.cdf_round import cdf_round
from .ops.logdomain_post import logdomain_post, logdomain_post_finalize
from .ops.pallas_sinkhorn import logdomain_iterations
from .ops.scaling import scaling_core_auto
from .ops.sinkhorn import (
    block_quantiles,
    exact_quota_repair,
    normalize_marginals,
    plan_rounded_assign,
    scaling_row_residuals,
    sinkhorn,
)
from .tracing import span

# Rows per block of the row-marginal check (bounds its float32 temporary).
_ERR_BLOCK_ROWS = 65536


def make_problem(n_obj: int, n_nodes: int, seed: int = 0, device=None):
    """Uniform [0, 1) costs with unit masses and capacities, from ``seed``.

    Returns ``(cost, mass, cap)`` on the resolved device; the cost comes from
    a ``torch.Generator`` on that device, so it is made where it is used.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cost = torch.rand((n_obj, n_nodes), generator=gen, dtype=torch.float32, device=dev)
    mass = torch.ones(n_obj, dtype=torch.float32, device=dev)
    cap = torch.ones(n_nodes, dtype=torch.float32, device=dev)
    return cost, mass, cap


def row_marginal_err(K, u, v, mass, cap) -> torch.Tensor:
    """Row-marginal L1 error ``sum |u * (K v) - a|`` against the solver's own target.

    The column marginal is exact by construction after the trailing v
    update, so the rows carry the convergence error. As in ``bench.py``,
    ``v`` is cast to K's dtype and the product is taken in float32
    (:func:`~rio_tpu_torch.ops.sinkhorn.scaling_row_residuals`, summed
    block by block).
    """
    a, _ = normalize_marginals(mass, cap)
    err = torch.zeros((), dtype=torch.float32, device=K.device)
    for i in range(0, K.shape[0], _ERR_BLOCK_ROWS):
        rows = slice(i, i + _ERR_BLOCK_ROWS)
        err += scaling_row_residuals(K[rows], u[rows], v, a[rows]).sum()
    return err


def repair_to_quota(assignment, cost, cap):
    """Exact-quota repair to ``cap``'s share of the rows: ``(assignment, mean_cost)``."""
    expected = cap / cap.sum().clamp_min(1e-30) * assignment.shape[0]
    assignment = exact_quota_repair(assignment, expected)
    return assignment, cost.gather(1, assignment[:, None].long()).mean()


def round_and_repair(cost, mass, cap, u, v, K, *, chunk: int | None = None):
    """Steps 2 and 3 on a solve's state: ``(assignment, mean_cost, row_marginal_err)``.

    The rounding and the row check are one call of
    :func:`~rio_tpu_torch.ops.cdf_round.cdf_round`, which ranks each block
    of ``chunk`` rows on its own (``block_quantiles``): on a CUDA K
    one launch of the kernel, on a CPU K its plain twin. The check sums the
    residuals it wrote.
    """
    with span("placement.round", impl=impl_for(K)):
        a, _ = normalize_marginals(mass, cap)
        rounded, res = cdf_round(K, u, v, a, block_quantiles(u > 0, chunk))
    with span("placement.row_check"):
        err = res.sum()
    with span("placement.repair"):
        assignment, mean_cost = repair_to_quota(rounded, cost, cap)
    return assignment, mean_cost, err


def placement_step(
    cost: torch.Tensor,
    mass: torch.Tensor,
    cap: torch.Tensor,
    *,
    eps: float = 0.05,
    n_iters: int = 30,
    kernel_dtype: torch.dtype = torch.bfloat16,
    chunk: int | None = None,
    device=None,
):
    """Place ``n`` objects on ``m`` nodes: ``(assignment, mean_cost, row_marginal_err)``.

    ``assignment`` is (n,) int32 with every node at its integer quota;
    ``mean_cost`` is the mean of ``cost[i, assignment[i]]`` (0.50 for a
    random placement on U[0, 1) costs); ``row_marginal_err`` is the solve's
    convergence error (:func:`row_marginal_err`). Inputs move to the
    resolved device. The step and its stages are spans of
    :mod:`rio_tpu_torch.tracing`: ``placement.step`` around
    ``scaling.k_build``, ``scaling.iterations``, ``placement.round``
    (attribute ``impl``: ``"kernel"`` or ``"eager"``),
    ``placement.row_check`` and ``placement.repair``.
    """
    dev = resolve_device(device)
    with span("placement.step"):
        cost, mass, cap = (t.to(dev) for t in (cost, mass, cap))
        u, v, K, _ = scaling_core_auto(
            cost, mass, cap, eps=eps, n_iters=n_iters, kernel_dtype=kernel_dtype
        )
        return round_and_repair(cost, mass, cap, u, v, K, chunk=chunk)


def logdomain_placement_step(
    cost: torch.Tensor,
    mass: torch.Tensor,
    cap: torch.Tensor,
    *,
    eps: float = 0.05,
    n_iters: int = 30,
    chunk: int | None = None,
    device=None,
):
    """Place ``n`` objects on ``m`` nodes in the log domain: ``(assignment, mean_cost, err)``.

    Solve with the loop of
    :func:`~rio_tpu_torch.ops.pallas_sinkhorn.pallas_sinkhorn` (the JAX
    ``pallas_sinkhorn``, a drop-in for ``sinkhorn`` in the dense log-domain
    solve-round-repair core of ``JaxObjectPlacement.rebalance``, and the
    solver of ``tpu_pallas_check.py``'s ``pallas_logdomain`` lane), round
    from the potentials with each row ranked within its block of ``chunk``
    rows and take the column-marginal error, both in one read of the cost
    (:func:`~rio_tpu_torch.ops.logdomain_post.logdomain_post`), then repair
    to the exact quotas of ``cap``. ``assignment`` and ``mean_cost`` are as
    in :func:`placement_step`; ``err`` is the solve's L1 column-marginal
    error. Inputs move to the resolved device. The step and its stages are
    spans of :mod:`rio_tpu_torch.tracing`: ``placement.step`` around
    ``logdomain.iterations`` (attributes ``impl`` and ``iterations``),
    ``logdomain.round`` (the quantiles and the rows pass; attribute
    ``impl``: ``"kernel"`` on a CUDA cost, where the post-solve kernel
    runs, ``"eager"`` on the CPU, where its twin does), ``logdomain.err``
    (the kernel's finalize, or the twin's ``marginal_err``) and
    ``placement.repair``.
    """
    dev = resolve_device(device)
    with span("placement.step"):
        cost, mass, cap = (t.to(dev) for t in (cost, mass, cap))
        c32 = cost.float().contiguous()
        a, b = normalize_marginals(mass, cap)
        f, g = logdomain_iterations(c32, a, b, eps=eps, n_iters=n_iters)
        with span("logdomain.round", impl=impl_for(c32)):
            rows = logdomain_post(c32, f, g, block_quantiles(torch.isfinite(f), chunk), eps)
        with span("logdomain.err"):
            err = logdomain_post_finalize(rows, c32, f, g, b, eps)
        with span("placement.repair"):
            assignment, mean_cost = repair_to_quota(rows.idx, cost, cap)
        return assignment, mean_cost, err


def entry(device=None):
    """Return ``(placement_step, example_args)``: the 4096 x 256 step of ``__graft_entry__``."""
    dev = resolve_device(device)
    return functools.partial(placement_step, device=dev), make_problem(4096, 256, 0, dev)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def dryrun_multichip(n_devices: int, *, device=None) -> dict:
    """The sharded placement step over an ``n_devices``-shard mesh, checked.

    ``__graft_entry__.dryrun_multichip`` with its bounds, on the resolved
    device repeated ``n_devices`` times (one card or the CPU runs every
    shard) and inputs from numpy seeds:

    1. the flat step at ``64 n x 8 n``: ``shard_cost`` -> ``sharded_sinkhorn``
       (20 iterations) -> rounding -> loads; f and g within rtol/atol 1e-4
       of the single-device ``sinkhorn``, rounded rows differing on <= 2%;
    2. ``sharded_hierarchical_assign`` against the single-device solve: no
       overflow, the dead node empty, node loads within ``n + 2``, mean
       assigned score within 0.25 sigma, coarse groups differing <= 50%;
    3. :func:`_hier_phase2`.

    Raises ``AssertionError`` on a missed bound; returns the measured values.
    """
    from .parallel import make_mesh, shard_cost, sharded_sinkhorn
    from .parallel.hierarchical import hierarchical_assign, sharded_hierarchical_assign

    dev = resolve_device(device)
    mesh = make_mesh([dev] * n_devices)
    rng = np.random.default_rng(42)
    n_obj, n_nodes = 64 * n_devices, 8 * n_devices
    affinity = torch.from_numpy(rng.random((n_obj, n_nodes), dtype=np.float32)).to(dev)
    node_load = torch.zeros(n_nodes, device=dev)
    cap = torch.ones(n_nodes, device=dev)
    alive = torch.ones(n_nodes, device=dev)
    row_mass = torch.ones(n_obj, device=dev)

    cost = build_cost_matrix(node_load, cap, alive, affinity)
    f, g = sharded_sinkhorn(mesh, shard_cost(mesh, cost), row_mass, cap * alive, eps=0.05, n_iters=20)
    assignment = plan_rounded_assign(cost, f, g, 0.05)
    new_load = torch.zeros_like(node_load).index_add_(0, assignment.long(), row_mass)
    _check(assignment.shape == (n_obj,), "assignment shape")
    _check(float(new_load.sum()) == float(n_obj), "loads do not sum to the objects")
    single = sinkhorn(cost, row_mass, cap * alive, eps=0.05, n_iters=20)
    for name, got, want in (("g", g, single.g), ("f", f, single.f)):
        _check(bool(torch.allclose(got, want, rtol=1e-4, atol=1e-4)),
               f"sharded {name} differs from the single-device solve by {float((got - want).abs().max())}")
    mismatch = float((assignment != plan_rounded_assign(cost, single.f, single.g, 0.05)).float().mean())
    _check(mismatch <= 0.02, f"sharded vs single-device assignment differs on {mismatch:.1%} of rows")

    # The two-level solve, rows data-parallel over the whole mesh.
    d_feat, dead = 8, 3
    n_groups = max(2, n_nodes // 8)
    obj_feat = rng.normal(size=(n_obj, d_feat)).astype(np.float32)
    node_feat = (rng.normal(size=(d_feat, n_nodes)) * 0.2).astype(np.float32)
    alive_h = alive.clone()
    alive_h[dead] = 0.0
    of, nf = torch.from_numpy(obj_feat).to(dev), torch.from_numpy(node_feat).to(dev)
    kw = dict(n_groups=n_groups, coarse_iters=8, fine_iters=8)
    res = sharded_hierarchical_assign(mesh, of, nf, cap, alive_h, **kw)
    res_single = hierarchical_assign(of, nf, cap, alive_h, **kw)
    a_sh, a_si = res.assignment.cpu().numpy(), res_single.assignment.cpu().numpy()
    _check(a_sh.shape == (n_obj,) and int(a_sh.max()) < n_nodes, "hierarchical assignment range")
    _check(int(res.overflow) == 0 and int(res_single.overflow) == 0, "hierarchical overflow")
    _check(not np.any(a_sh == dead) and not np.any(a_si == dead), "an object on the dead node")
    load_delta = int(np.abs(np.bincount(a_sh, minlength=n_nodes) - np.bincount(a_si, minlength=n_nodes)).max())
    _check(load_delta <= n_devices + 2, f"hierarchical load delta {load_delta}")
    score = obj_feat @ node_feat
    rows = np.arange(n_obj)
    gap = float(score[rows, a_si].mean() - score[rows, a_sh].mean()) / float(score.std())
    _check(gap <= 0.25, f"hierarchical score gap {gap:.3f} sigma")
    group_size = n_nodes // n_groups
    group_mismatch = float(np.mean(a_sh // group_size != a_si // group_size))
    _check(group_mismatch <= 0.5, f"hierarchical sharded/single coarse routing diverges: {group_mismatch:.1%}")
    return {
        "n_devices": n_devices, "mesh": mesh.shape, "f_max_abs": float((f - single.f).abs().max()),
        "g_max_abs": float((g - single.g).abs().max()), "row_mismatch": mismatch,
        "hier_load_delta": load_delta, "hier_score_gap_sigma": gap,
        "hier_group_mismatch": group_mismatch, "phase2": _hier_phase2(mesh, n_devices, dev),
    }


def phase2_inputs(n_devices: int) -> dict:
    """:func:`_hier_phase2`'s inputs as numpy, from seeds: 1,024 objects and
    32 nodes a shard, 16 features; group directions plus strong node
    perturbations, each object aligned to an owner node; node 3 dead."""
    rng = np.random.default_rng(1)
    n_obj, n_nodes, d_feat = 1024 * n_devices, 32 * n_devices, 16
    n_groups = n_nodes // 8
    group_dirs = rng.normal(size=(n_groups, d_feat))
    node_feat = (np.repeat(group_dirs, 8, axis=0) + 0.5 * rng.normal(size=(n_nodes, d_feat))).T
    owner = rng.integers(0, n_nodes, n_obj)
    obj_feat = node_feat.T[owner] * 3.0 + 0.1 * rng.normal(size=(n_obj, d_feat))
    alive = np.ones(n_nodes, np.float32)
    alive[3] = 0.0
    return {
        "obj_feat": obj_feat.astype(np.float32), "node_feat": node_feat.astype(np.float32),
        "cap": np.ones(n_nodes, np.float32), "alive": alive, "n_groups": n_groups, "dead": 3,
    }


def _hier_phase2(mesh, n_devices: int, dev: torch.device) -> dict:
    """``__graft_entry__._hier_phase2`` with its bounds, on :func:`phase2_inputs`.

    Mechanism parity: the sharded solve against the concatenation of
    per-shard local solves (flips <= 1%, load delta <= 2, equal overflow).
    Quality against the global single-device solve: coarse mismatch <= 12%,
    row flips <= 0.6, score gap <= 0.3 sigma, and the transport cost (summed
    squared feature distance object -> node) within 1.12x (the reference
    measured 1.081). Prints the cost ratio as the reference does.
    """
    from .parallel.hierarchical import hierarchical_assign, sharded_hierarchical_assign

    inp = phase2_inputs(n_devices)
    obj_feat, node_feat = inp["obj_feat"], inp["node_feat"]
    n_obj, n_nodes = obj_feat.shape[0], node_feat.shape[1]
    s, dead = n_nodes // inp["n_groups"], inp["dead"]
    of, nf, cap, alive = (torch.from_numpy(inp[k]).to(dev) for k in ("obj_feat", "node_feat", "cap", "alive"))
    kw = dict(n_groups=inp["n_groups"], coarse_iters=16, fine_iters=16)

    res = sharded_hierarchical_assign(mesh, of, nf, cap, alive, **kw)
    a_sh = res.assignment.cpu().numpy()
    shard = n_obj // n_devices
    parts = [hierarchical_assign(of[k * shard : (k + 1) * shard], nf, cap, alive, **kw) for k in range(n_devices)]
    ref = np.concatenate([p.assignment.cpu().numpy() for p in parts])
    mech_flips = float(np.mean(a_sh != ref))
    _check(mech_flips <= 0.01, f"the sharded solve differs from per-shard local solves on {mech_flips:.2%} of rows")
    _check(int(res.overflow) == sum(int(p.overflow) for p in parts), "overflow differs from the per-shard sum")
    loads_sh = np.bincount(a_sh, minlength=n_nodes)
    _check(int(np.abs(loads_sh - np.bincount(ref, minlength=n_nodes)).max()) <= 2, "mechanism load delta")

    a_si = hierarchical_assign(of, nf, cap, alive, **kw).assignment.cpu().numpy()
    _check(int(res.overflow) == 0, "phase-2 overflow")
    _check(not np.any(a_sh == dead) and not np.any(a_si == dead), "phase 2: an object on the dead node")
    load_delta = int(np.abs(loads_sh - np.bincount(a_si, minlength=n_nodes)).max())
    _check(load_delta <= n_devices, f"phase-2 load delta {load_delta}")
    group_mismatch = float(np.mean(a_sh // s != a_si // s))
    _check(group_mismatch <= 0.12, f"phase-2 coarse routing diverges: {group_mismatch:.1%}")
    flips = float(np.mean(a_sh != a_si))
    _check(flips <= 0.6, f"phase-2 row flips: {flips:.1%}")
    score = obj_feat.astype(np.float64) @ node_feat.astype(np.float64)
    rows = np.arange(n_obj)
    gap = float(score[rows, a_si].mean() - score[rows, a_sh].mean()) / float(score.std())
    _check(gap <= 0.3, f"phase-2 score gap {gap:.3f} sigma")
    obj_norm = (obj_feat.astype(np.float64) ** 2).sum(axis=1)
    node_norm = (node_feat.astype(np.float64) ** 2).sum(axis=0)
    cost_sh = float((obj_norm + node_norm[a_sh] - 2.0 * score[rows, a_sh]).sum())
    cost_si = float((obj_norm + node_norm[a_si] - 2.0 * score[rows, a_si]).sum())
    ratio = cost_sh / max(cost_si, 1e-9)
    print(
        f"# phase2 transport cost: sharded {cost_sh:.0f} vs global {cost_si:.0f} "
        f"(ratio {ratio:.4f}), coarse mismatch {group_mismatch:.1%}"
    )
    _check(cost_sh <= cost_si * 1.12, f"sharded transport cost exceeds global by {ratio - 1:.1%}")
    return {
        "mech_flips": mech_flips, "load_delta": load_delta, "coarse_mismatch": group_mismatch,
        "flips": flips, "score_gap_sigma": gap, "cost_sharded": cost_sh, "cost_global": cost_si,
        "cost_ratio": ratio,
    }
