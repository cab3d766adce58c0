"""The placement steps: solve, capacity-aware rounding, exact-quota repair.

:func:`placement_step` is the counterpart of ``__graft_entry__.entry`` and of
the step that ``bench.py``'s solve tier times (``_solve_rate.step``):

1. a scaling-form Sinkhorn solve (:func:`~rio_tpu_torch.ops.scaling.scaling_core_auto`:
   the fused CUDA kernel on the card, the eager loop on the CPU);
2. capacity-aware CDF rounding from the scaling state
   (:func:`~rio_tpu_torch.ops.sinkhorn.plan_rounded_assign_from_scaling`),
   whole or in row chunks;
3. largest-remainder exact-quota repair
   (:func:`~rio_tpu_torch.ops.sinkhorn.exact_quota_repair`).

:func:`logdomain_placement_step` is the same step in the log domain: the
solve is :func:`~rio_tpu_torch.ops.pallas_sinkhorn.pallas_sinkhorn` (one
launch of the fused log-domain kernel per iteration on the card) and the
rounding reads the potentials (:func:`round_from_potentials`).

Everything runs on CUDA unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import functools

import torch

from .device import resolve_device
from .ops.pallas_sinkhorn import pallas_sinkhorn
from .ops.scaling import scaling_core_auto
from .ops.sinkhorn import (
    exact_quota_repair,
    normalize_marginals,
    plan_rounded_assign,
    plan_rounded_assign_from_scaling,
)

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
    ``v`` is cast to K's dtype and the product is taken in float32.
    """
    a, _ = normalize_marginals(mass, cap)
    vk = v.to(K.dtype).float()
    err = torch.zeros((), dtype=torch.float32, device=K.device)
    for i in range(0, K.shape[0], _ERR_BLOCK_ROWS):
        rows = slice(i, i + _ERR_BLOCK_ROWS)
        err += (u[rows] * (K[rows].float() @ vk) - a[rows]).abs().sum()
    return err


def _by_row_chunks(n: int, chunk: int | None, round_rows) -> torch.Tensor:
    """``round_rows(rows)`` over all ``n`` rows at once, or per block of ``chunk`` rows.

    Per-chunk rounding ranks each chunk's rows on their own, as ``bench.py``
    does. That equals global ranking only because every row here is real
    with identical mass (each chunk spreads over the same marginals); mixed
    masses or padding split across chunks would need an explicit rank
    offset. ``n`` must be a multiple of ``chunk``.
    """
    if chunk is None:
        return round_rows(slice(None))
    if n % chunk:
        raise ValueError(f"{n} rows are not a multiple of chunk={chunk}")
    return torch.cat([round_rows(slice(i, i + chunk)) for i in range(0, n, chunk)])


def round_from_scaling(K, u, v, *, chunk: int | None = None) -> torch.Tensor:
    """Step 2: CDF rounding of the plan ``diag(u) K diag(v)``, whole or in row chunks.

    ``chunk`` as in :func:`_by_row_chunks`.
    """
    return _by_row_chunks(
        K.shape[0], chunk, lambda rows: plan_rounded_assign_from_scaling(K[rows], u[rows], v)
    )


def round_from_potentials(cost, f, g, eps: float, *, chunk: int | None = None) -> torch.Tensor:
    """CDF rounding of the plan ``exp((f + g - C)/eps)``, whole or in row chunks.

    :func:`round_from_scaling` for a log-domain solve, over
    :func:`~rio_tpu_torch.ops.sinkhorn.plan_rounded_assign`; chunks bound
    its softmax and cumsum temporaries to ``chunk`` rows (see
    :func:`_by_row_chunks`).
    """
    return _by_row_chunks(
        cost.shape[0], chunk, lambda rows: plan_rounded_assign(cost[rows], f[rows], g, eps)
    )


def repair_to_quota(assignment, cost, cap):
    """Exact-quota repair to ``cap``'s share of the rows: ``(assignment, mean_cost)``."""
    expected = cap / cap.sum().clamp_min(1e-30) * assignment.shape[0]
    assignment = exact_quota_repair(assignment, expected)
    return assignment, cost.gather(1, assignment[:, None].long()).mean()


def round_and_repair(cost, mass, cap, u, v, K, *, chunk: int | None = None):
    """Steps 2 and 3 on a solve's state: ``(assignment, mean_cost, row_marginal_err)``."""
    err = row_marginal_err(K, u, v, mass, cap)
    assignment, mean_cost = repair_to_quota(round_from_scaling(K, u, v, chunk=chunk), cost, cap)
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
    resolved device.
    """
    dev = resolve_device(device)
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

    Solve with :func:`~rio_tpu_torch.ops.pallas_sinkhorn.pallas_sinkhorn`
    (the JAX ``pallas_sinkhorn``, a drop-in for ``sinkhorn`` in the dense
    log-domain solve-round-repair core of ``JaxObjectPlacement.rebalance``,
    and the solver of ``tpu_pallas_check.py``'s ``pallas_logdomain`` lane),
    round from the potentials (:func:`round_from_potentials`), then repair
    to the exact quotas of ``cap``. ``assignment`` and ``mean_cost`` are as
    in :func:`placement_step`; ``err`` is the solve's L1 column-marginal
    error. Inputs move to the resolved device.
    """
    dev = resolve_device(device)
    cost, mass, cap = (t.to(dev) for t in (cost, mass, cap))
    res = pallas_sinkhorn(cost, mass, cap, eps=eps, n_iters=n_iters)
    rounded = round_from_potentials(cost, res.f, res.g, eps, chunk=chunk)
    assignment, mean_cost = repair_to_quota(rounded, cost, cap)
    return assignment, mean_cost, res.err


def entry(device=None):
    """Return ``(placement_step, example_args)``: the 4096 x 256 step of ``__graft_entry__``."""
    dev = resolve_device(device)
    return functools.partial(placement_step, device=dev), make_problem(4096, 256, 0, dev)
