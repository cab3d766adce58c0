"""Scaling-form (Sinkhorn-Knopp) solver: matrix-vector products, no per-iteration exp.

Counterpart of ``rio_tpu/ops/scaling.py``. The scaling form moves every
transcendental out of the loop:

    K = exp(-C / eps)                  # once
    repeat:  u = a / (K @ v) ;  v = b / (K^T @ u)
    f = eps * log u ;  g = eps * log v

Each iteration reads K; K can be stored bfloat16, products accumulate in
float32.

Two implementations, with two bfloat16 semantics:

* :func:`scaling_core` / :func:`scaling_sinkhorn` — eager PyTorch, two
  reads of K per iteration. Like the JAX ``scaling_core``, it casts ``v``
  and ``u`` to the kernel dtype before each product.
* :func:`fused_scaling_core` / :func:`fused_scaling_sinkhorn` — one
  hand-written CUDA kernel per iteration (:func:`fused_scaling_iteration`,
  ``kernels/csrc/scaling_iteration.cu``) that reads K once. Like the JAX
  Pallas kernel, it keeps ``u`` and ``v`` in float32. Its plain twin
  :func:`fused_scaling_iteration_ref` computes the same function and is
  what the wrapper runs for CPU tensors.

:func:`scaling_core_auto` picks the kernel for CUDA tensors and the eager
loop for CPU tensors.

:func:`scaling_kernel`, :func:`scaling_core` and :func:`scaling_sinkhorn`
also take a leading batch axis: a ``(G, n, m)`` cost with ``(G, n)`` masses,
``(G, m)`` capacities and an optional ``(G, m)`` seed solves ``G`` problems
at once, each with its own marginals, row shifts and warm gauge. The
products of a batch are batched matrix products, so they need not round
as a loop of the unbatched calls does: the hierarchical fine stage holds
them to a tolerance, not to equal bits.
"""

from __future__ import annotations

import ctypes

import torch

from .sinkhorn import SinkhornResult, _safe_log, marginal_err, normalize_marginals

_NEG_INF = float("-inf")


def _potentials(u: torch.Tensor, v: torch.Tensor, eps: float):
    f = torch.where(u > 0, eps * _safe_log(u), _NEG_INF)
    g = torch.where(v > 0, eps * _safe_log(v), _NEG_INF)
    return f, g


def _warm_seed(g_init: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Effective warm seed and the gauge ``s`` it is lowered by (one per problem).

    Non-finite entries (dead columns of the previous solve) cold-fill to 0.
    ``v0 = exp((g0 - s) / eps)`` with ``s = max(g0)`` keeps every exponent
    <= 0. The scaling updates are homogeneous, so the gauge persists to the
    converged scalings; :func:`scaling_sinkhorn` undoes it on the final
    potentials. It is a global scalar on the seed only, orthogonal to the
    per-row min-shift on the cost.
    """
    g0 = torch.where(torch.isfinite(g_init), g_init.float(), 0.0)
    return g0, g0.max(dim=-1, keepdim=True).values


def scaling_kernel(
    cost: torch.Tensor,
    row_mass: torch.Tensor,
    col_capacity: torch.Tensor,
    *,
    eps: float,
    kernel_dtype: torch.dtype,
):
    """The solve's fixed inputs: ``(a, b, K, row_shift)``.

    ``K = exp(-(C - shift) / eps)`` in ``kernel_dtype``, with a PER-ROW
    min-shift: pure gauge (each row's shift is absorbed into its u), and it
    keeps every row's best entry at exp(0) = 1, so no row underflows to all
    zeros whatever the global cost range (a global shift breaks down once
    range/eps >> 88). Rows whose minimum is not finite get shift 0.
    """
    cost = cost.float()
    a, b = normalize_marginals(row_mass, col_capacity)
    shift = cost.min(dim=-1, keepdim=True).values
    shift = torch.where(torch.isfinite(shift), shift, 0.0)
    # In place on the one float32 temporary: at 1M x 1024 each extra
    # temporary is 4 GiB. x / (-eps) equals -x / eps exactly.
    K = cost - shift
    K.div_(-eps).exp_()
    return a, b, K.to(kernel_dtype), shift[..., 0]


def scaling_core(
    cost: torch.Tensor,
    row_mass: torch.Tensor,
    col_capacity: torch.Tensor,
    *,
    eps: float = 0.05,
    n_iters: int = 50,
    kernel_dtype: torch.dtype = torch.bfloat16,
    g_init: torch.Tensor | None = None,
):
    """The eager scaling iteration; returns ``(u, v, K, row_shift)``.

    ``row_shift`` is the (n,) per-row gauge subtracted from the cost before
    exponentiating (add it back to ``eps*log(u)`` to recover ``f``). ``K``
    is returned for the rounding pass to reuse. ``v`` and ``u`` are cast to
    ``kernel_dtype`` before each product, which is computed in float32 (a
    bfloat16 product in PyTorch would return bfloat16).

    ``g_init`` warm-starts ``v0`` from a previous solve's node potentials,
    gauged by its max (:func:`_warm_seed`); exponents are clipped at -60.
    """
    a, b, K, shift = scaling_kernel(
        cost, row_mass, col_capacity, eps=eps, kernel_dtype=kernel_dtype
    )
    Kf = K.float()
    u = torch.zeros_like(a)
    if g_init is None:
        v = torch.ones_like(b)
    else:
        g_seed, s = _warm_seed(g_init)
        v = torch.exp(torch.clamp((g_seed - s) / eps, -60.0, 0.0))
    for _ in range(n_iters):
        Kv = _matvec(Kf, v.to(kernel_dtype).float())
        u = torch.where(a > 0, a / Kv.clamp_min(1e-30), 0.0)
        KTu = _vecmat(u.to(kernel_dtype).float(), Kf)
        v = torch.where(b > 0, b / KTu.clamp_min(1e-30), 0.0)
    return u, v, K, shift


def _matvec(K: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``K @ v`` for (n, m) K, or per problem for (G, n, m) K and (G, m) v."""
    return K @ v if K.dim() == 2 else (K @ v.unsqueeze(-1)).squeeze(-1)


def _vecmat(u: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """``u @ K`` for (n, m) K, or per problem for (G, n, m) K and (G, n) u."""
    return u @ K if K.dim() == 2 else (u.unsqueeze(-2) @ K).squeeze(-2)


def _log_domain_result(cost, row_mass, col_capacity, u, v, shift, eps, gauge=None):
    """Potentials ``(f, g)`` and the column-marginal error from a scaling solve."""
    cost = cost.float() - shift[..., None]
    _, b = normalize_marginals(row_mass, col_capacity)
    f, g = _potentials(u, v, eps)
    if gauge is not None:
        # Undo the warm gauge (f + g is invariant, so err is unaffected).
        f = torch.where(torch.isfinite(f), f - gauge, f)
        g = torch.where(torch.isfinite(g), g + gauge, g)
    err = marginal_err(cost, f, g, b, eps)  # shifted-cost / shifted-f pair
    f = torch.where(torch.isfinite(f), f + shift, f)  # undo the row gauge
    return SinkhornResult(f=f, g=g, err=err)


def scaling_sinkhorn(
    cost: torch.Tensor,
    row_mass: torch.Tensor,
    col_capacity: torch.Tensor,
    *,
    eps: float = 0.05,
    n_iters: int = 50,
    kernel_dtype: torch.dtype = torch.bfloat16,
    g_init: torch.Tensor | None = None,
) -> SinkhornResult:
    """Sinkhorn-Knopp in scaling form; returns log-domain potentials.

    Matches :func:`rio_tpu_torch.ops.sinkhorn.sinkhorn` up to dtype
    tolerance (``kernel_dtype=torch.float32`` for tight parity), warm
    starts included.
    """
    u, v, _, shift = scaling_core(
        cost, row_mass, col_capacity, eps=eps, n_iters=n_iters,
        kernel_dtype=kernel_dtype, g_init=g_init,
    )
    gauge = None if g_init is None else _warm_seed(g_init)[1]
    return _log_domain_result(cost, row_mass, col_capacity, u, v, shift, eps, gauge)


# ---------------------------------------------------------------------------
# Fused iteration: one hand-written CUDA kernel, one read of K per iteration
# ---------------------------------------------------------------------------

_K_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _kernel_lib() -> ctypes.CDLL:
    from ..kernels.build import load

    lib = load("scaling_iteration")
    lib.scaling_iteration_parts.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.scaling_iteration_parts.restype = ctypes.c_int
    lib.scaling_iteration_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.scaling_iteration_launch.restype = ctypes.c_int
    return lib


def _check_iteration_args(K, a, b, v) -> None:
    if K.dim() != 2:
        raise ValueError(f"K must be 2-D, got shape {tuple(K.shape)}")
    n, m = K.shape
    if m == 0:
        raise ValueError("K needs at least one column")
    if K.dtype not in _K_DTYPES:
        raise TypeError(f"K must be float32 or bfloat16, got {K.dtype}")
    for name, x, size in (("a", a, n), ("b", b, m), ("v", v, m)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != (size,):
            raise ValueError(f"{name} must have shape ({size},), got {tuple(x.shape)}")
    for name, x in (("K", K), ("a", a), ("b", b), ("v", v)):
        if x.device != K.device:
            raise ValueError(f"{name} is on {x.device}, K on {K.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_scaling_iteration_ref(
    K: torch.Tensor, a: torch.Tensor, b: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel: one iteration with u and v in float32.

    ``u = a / max(K v, 1e-30)`` (0 where ``a <= 0``), then
    ``v' = b / max(K^T u, 1e-30)`` (0 where ``b <= 0``), K widened to
    float32 — the JAX Pallas kernel's semantics.
    """
    Kf = K.float()
    u = torch.where(a > 0, a / (Kf @ v).clamp_min(1e-30), 0.0)
    v_new = torch.where(b > 0, b / (u @ Kf).clamp_min(1e-30), 0.0)
    return u, v_new


def fused_scaling_iteration(
    K: torch.Tensor, a: torch.Tensor, b: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused scaling iteration: returns ``(u, v_new)``.

    For CUDA tensors this launches the CUDA kernel (one read of K) on the
    current stream, or raises; for CPU tensors it runs
    :func:`fused_scaling_iteration_ref`. K is (n, m) float32 or bfloat16;
    a (n,), b (m,) and v (m,) are float32; all contiguous, on one device.
    ``fused_scaling_iteration.launches`` counts kernel launches.
    """
    _check_iteration_args(K, a, b, v)
    if K.device.type == "cpu":
        return fused_scaling_iteration_ref(K, a, b, v)
    if K.device.type != "cuda":
        raise ValueError(f"no kernel for device {K.device}")
    n, m = K.shape
    dtype = _K_DTYPES[K.dtype]
    lib = _kernel_lib()
    with torch.cuda.device(K.device):
        parts = ctypes.c_int(0)
        rc = lib.scaling_iteration_parts(dtype, K.data_ptr(), n, m, ctypes.byref(parts))
        if rc:
            raise RuntimeError(f"scaling_iteration_parts failed: CUDA error {rc}")
        u = torch.empty(n, dtype=torch.float32, device=K.device)
        v_new = torch.empty(m, dtype=torch.float32, device=K.device)
        workspace = torch.empty((parts.value, m), dtype=torch.float32, device=K.device)
        stream = torch.cuda.current_stream(K.device).cuda_stream
        rc = lib.scaling_iteration_launch(
            dtype, K.data_ptr(), a.data_ptr(), b.data_ptr(), v.data_ptr(),
            u.data_ptr(), v_new.data_ptr(), workspace.data_ptr(), parts.value,
            n, m, stream,
        )
    if rc:
        raise RuntimeError(f"scaling iteration kernel failed to launch: CUDA error {rc}")
    fused_scaling_iteration.launches += 1
    return u, v_new


fused_scaling_iteration.launches = 0


def fused_scaling_core(
    cost: torch.Tensor,
    row_mass: torch.Tensor,
    col_capacity: torch.Tensor,
    *,
    eps: float = 0.05,
    n_iters: int = 50,
    kernel_dtype: torch.dtype = torch.bfloat16,
):
    """Fused-kernel counterpart of :func:`scaling_core`: ``(u, v, K, shift)``.

    Each iteration is one :func:`fused_scaling_iteration`. The kernel masks
    ragged shapes itself, so K is neither padded nor copied; the returned
    ``K`` is the (n, m) kernel matrix the rounding pass reuses.
    """
    a, b, K, shift = scaling_kernel(
        cost, row_mass, col_capacity, eps=eps, kernel_dtype=kernel_dtype
    )
    u = torch.zeros_like(a)
    v = torch.ones_like(b)
    for _ in range(n_iters):
        u, v = fused_scaling_iteration(K, a, b, v)
    return u, v, K, shift


def fused_scaling_sinkhorn(
    cost: torch.Tensor,
    row_mass: torch.Tensor,
    col_capacity: torch.Tensor,
    *,
    eps: float = 0.05,
    n_iters: int = 50,
    kernel_dtype: torch.dtype = torch.bfloat16,
) -> SinkhornResult:
    """Fused-kernel scaling Sinkhorn: log-domain potentials, one read of K per iteration."""
    u, v, _, shift = fused_scaling_core(
        cost, row_mass, col_capacity, eps=eps, n_iters=n_iters, kernel_dtype=kernel_dtype
    )
    return _log_domain_result(cost, row_mass, col_capacity, u, v, shift, eps)


def scaling_impl_for(device: str | torch.device) -> str:
    """Which implementation :func:`scaling_core_auto` picks on ``device``.

    ``"fused"`` (the CUDA kernel) on CUDA, ``"eager"`` elsewhere. There is
    no size threshold: none has been measured on the card yet.
    """
    return "fused" if torch.device(device).type == "cuda" else "eager"


def scaling_core_auto(
    cost: torch.Tensor,
    row_mass: torch.Tensor,
    col_capacity: torch.Tensor,
    *,
    eps: float = 0.05,
    n_iters: int = 50,
    kernel_dtype: torch.dtype = torch.bfloat16,
):
    """Device-aware :func:`scaling_core`: the fused kernel on CUDA, the eager loop else.

    Returns ``(u, v, K, shift)`` either way.
    """
    core = fused_scaling_core if scaling_impl_for(cost.device) == "fused" else scaling_core
    return core(
        cost, row_mass, col_capacity, eps=eps, n_iters=n_iters, kernel_dtype=kernel_dtype
    )
