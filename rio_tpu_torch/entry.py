"""The placement step: scaling solve, rounding from the scaling state, quota repair.

Counterpart of ``__graft_entry__.entry`` and of the step that ``bench.py``'s
solve tier times (``_solve_rate.step``):

1. a scaling-form Sinkhorn solve (:func:`~rio_tpu_torch.ops.scaling.scaling_core_auto`:
   the fused CUDA kernel on the card, the eager loop on the CPU);
2. capacity-aware CDF rounding from the scaling state
   (:func:`~rio_tpu_torch.ops.sinkhorn.plan_rounded_assign_from_scaling`),
   whole or in row chunks;
3. largest-remainder exact-quota repair
   (:func:`~rio_tpu_torch.ops.sinkhorn.exact_quota_repair`).

Everything runs on CUDA unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import functools

import torch

from .device import resolve_device
from .ops.scaling import scaling_core_auto
from .ops.sinkhorn import exact_quota_repair, normalize_marginals, plan_rounded_assign_from_scaling

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


def round_from_scaling(K, u, v, *, chunk: int | None = None) -> torch.Tensor:
    """Step 2: CDF rounding of the plan ``diag(u) K diag(v)``, whole or in row chunks.

    ``chunk=None`` rounds all rows at once. With ``chunk`` the rounding runs
    per block of ``chunk`` rows with per-chunk quantile ranks, as
    ``bench.py`` does; that equals global ranking only because every row
    here is real with identical mass (each chunk spreads over the same
    marginals) — mixed masses or padding split across chunks would need an
    explicit rank offset. ``n`` must be a multiple of ``chunk``.
    """
    n = K.shape[0]
    if chunk is None:
        return plan_rounded_assign_from_scaling(K, u, v)
    if n % chunk:
        raise ValueError(f"{n} rows are not a multiple of chunk={chunk}")
    return torch.cat(
        [
            plan_rounded_assign_from_scaling(K[i : i + chunk], u[i : i + chunk], v)
            for i in range(0, n, chunk)
        ]
    )


def round_and_repair(cost, mass, cap, u, v, K, *, chunk: int | None = None):
    """Steps 2 and 3 on a solve's state: ``(assignment, mean_cost, row_marginal_err)``."""
    n = K.shape[0]
    err = row_marginal_err(K, u, v, mass, cap)
    assignment = round_from_scaling(K, u, v, chunk=chunk)
    expected = cap / cap.sum().clamp_min(1e-30) * n
    assignment = exact_quota_repair(assignment, expected)
    mean_cost = cost.gather(1, assignment[:, None].long()).mean()
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


def entry(device=None):
    """Return ``(placement_step, example_args)``: the 4096 x 256 step of ``__graft_entry__``."""
    dev = resolve_device(device)
    return functools.partial(placement_step, device=dev), make_problem(4096, 256, 0, dev)
