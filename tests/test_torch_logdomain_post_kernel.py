"""The post-solve kernel of the log-domain step (``ops/logdomain_post.py``, ``kernels/csrc/logdomain_post.cu``).

The CPU cases hold the step against the composition it replaced (the whole
``pallas_sinkhorn``, then the rounding per chunk of rows), bit for bit;
``pallas_sinkhorn`` against its own former body; the quantile helper against
``_quantiles`` per block; the wrapper's checks against ``potential_round``'s;
its dispatch (every CUDA cost takes the kernel); and its CPU path against
the twin. The cases marked ``card`` hold the kernel against its twin on a real
solve at the benchmark cell's shape, on ragged and edge shapes, where the
column error is far from 0, from launch to launch, and under
``torch.cuda.set_sync_debug_mode("error")``; they skip without a CUDA device.
On a card:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_logdomain_post_kernel.py``.
"""

import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rio_tpu_torch import tracing  # noqa: E402
from rio_tpu_torch.entry import logdomain_placement_step, repair_to_quota  # noqa: E402
from rio_tpu_torch.kernels import launch as L  # noqa: E402
from rio_tpu_torch.ops import logdomain_post as lp  # noqa: E402
from rio_tpu_torch.ops import potential_round as pr  # noqa: E402

# The package re-exports the functions ``pallas_sinkhorn`` and ``sinkhorn`` under the modules' names.
ps = importlib.import_module("rio_tpu_torch.ops.pallas_sinkhorn")
S = importlib.import_module("rio_tpu_torch.ops.sinkhorn")

EPS = 0.05


def _problem(n, m, *, seed=0, padding=False, dead=False, device="cpu"):
    """``(cost, mass, cap)``: U[0, 1) costs, unit masses and capacities; some zero if asked."""
    gen = torch.Generator().manual_seed(seed)
    cost = torch.rand((n, m), generator=gen)
    mass, cap = torch.ones(n), torch.ones(m)
    if padding:
        mass[3::7] = 0.0
    if dead and m > 2:
        cap[2::11] = 0.0
    return cost.to(device), mass.to(device), cap.to(device)


def _potentials(cost, mass, cap, n_iters=30):
    """``(f, g, b)`` of ``n_iters`` log-domain iterations on the cost's device (``g = 0`` with no row)."""
    a, b = S.normalize_marginals(mass, cap)
    if cost.shape[0] == 0:  # the twin's column LSE takes no empty column
        return a, torch.zeros_like(b), b
    f, g = ps.logdomain_iterations(cost, a, b, eps=EPS, n_iters=n_iters)
    return f, g, b


def _parent_step(cost, mass, cap, *, eps, n_iters, chunk):
    """The step as it was composed before the post-solve kernel: ``pallas_sinkhorn``, then
    ``plan_rounded_assign`` on each chunk of rows, then the repair."""
    res = ps.pallas_sinkhorn(cost, mass, cap, eps=eps, n_iters=n_iters)

    def round_rows(rows):
        return S.plan_rounded_assign(cost[rows], res.f[rows], res.g, eps)

    n = cost.shape[0]
    if chunk is None:
        rounded = round_rows(slice(None))
    else:
        rounded = torch.cat([round_rows(slice(i, i + chunk)) for i in range(0, n, chunk)])
    assignment, mean_cost = repair_to_quota(rounded, cost, cap)
    return assignment, mean_cost, res.err


def _parent_pallas_sinkhorn(cost, row_mass, col_capacity, *, eps, n_iters):
    """``pallas_sinkhorn``'s body before its loop was factored out."""
    cost = cost.float().contiguous()
    n, m = cost.shape
    a, b = S.normalize_marginals(row_mass, col_capacity)
    log_a, log_b = S.log_marginals(a, b)
    f = torch.zeros(n, dtype=torch.float32)
    g = torch.zeros(m, dtype=torch.float32)
    for _ in range(n_iters):
        f, g = ps.fused_iteration(cost, log_a, log_b, g, eps)
    return f, g, S.marginal_err(cost, f, g, b, eps)


# --- the step, pallas_sinkhorn and the quantiles on the CPU ------------------------------

SHAPES = [  # (n, m, chunk, padding rows, dead columns)
    (4096, 64, 1024, False, False),
    (4096, 64, None, True, True),
    (1000, 33, None, True, False),
    (2048, 130, 512, False, True),
    (512, 1025, 256, False, False),
    (300, 4, 100, True, True),
    (1237, 1000, None, False, True),
]


@pytest.mark.parametrize("n,m,chunk,padding,dead", SHAPES)
def test_the_step_on_the_cpu_is_bit_for_bit_the_former_composition(n, m, chunk, padding, dead):
    cost, mass, cap = _problem(n, m, seed=n + m, padding=padding, dead=dead)
    got = logdomain_placement_step(cost, mass, cap, eps=EPS, n_iters=12, chunk=chunk, device="cpu")
    want = _parent_step(cost, mass, cap, eps=EPS, n_iters=12, chunk=chunk)
    for x, y in zip(got, want, strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)


@pytest.mark.parametrize("n,m,chunk,padding,dead", SHAPES[:4])
def test_pallas_sinkhorn_is_unchanged_for_its_callers(n, m, chunk, padding, dead):
    cost, mass, cap = _problem(n, m, seed=2 * n + m, padding=padding, dead=dead)
    seen = []
    tracing.add_sink(seen.append)
    try:
        res = ps.pallas_sinkhorn(cost, mass, cap, eps=EPS, n_iters=9)
    finally:
        tracing.clear_sinks()
    for x, y in zip(res, _parent_pallas_sinkhorn(cost, mass, cap, eps=EPS, n_iters=9), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert [s.name for s in seen] == ["logdomain.iterations", "logdomain.err"]
    assert seen[0].attrs == {"impl": "eager", "iterations": 9}


@pytest.mark.parametrize("chunk", [None, 1, 8, 64, 512])
def test_block_quantiles_are_quantiles_per_block(chunk):
    is_real = torch.rand(512, generator=torch.Generator().manual_seed(chunk or 0)) > 0.3
    is_real[:64] = False  # a whole block of padding
    got = S.block_quantiles(is_real, chunk)
    step = chunk or 512
    want = torch.cat([S._quantiles(is_real[i : i + step]) for i in range(0, 512, step)])
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_block_quantiles_take_only_whole_blocks():
    with pytest.raises(ValueError, match="multiple of chunk"):
        S.block_quantiles(torch.ones(100, dtype=torch.bool), 64)
    with pytest.raises(ValueError, match="multiple of chunk"):
        logdomain_placement_step(*_problem(100, 8), eps=EPS, n_iters=1, chunk=64, device="cpu")


# --- the wrapper's checks, its dispatch and its CPU path ---------------------------------


def _case(case):
    cost, mass, cap = _problem(40, 8, seed=1, padding=True)
    f, g, _ = _potentials(cost, mass, cap, n_iters=3)
    q = S._quantiles(torch.isfinite(f))
    expect = ValueError
    if case == "cost_dtype":
        cost, expect = cost.double(), TypeError
    elif case == "f_dtype":
        f, expect = f.half(), TypeError
    elif case == "q_dtype":
        q, expect = q.double(), TypeError
    elif case == "f_len":
        f = f[:-1]
    elif case == "g_len":
        g = torch.cat([g, g[:1]])
    elif case == "q_len":
        q = q[:-1]
    elif case == "no_columns":
        cost, g = cost[:, :0], g[:0]
    elif case == "device":
        g = g.to("meta")
    else:
        cost = cost.t().contiguous().t()
    return (cost, f, g, q), expect


@pytest.mark.parametrize(
    "case", ["cost_dtype", "f_dtype", "q_dtype", "f_len", "g_len", "q_len", "no_columns", "device",
             "noncontiguous"],
)
def test_the_wrapper_rejects_what_potential_round_rejects(case):
    args, expect = _case(case)
    with pytest.raises(expect) as theirs:
        pr.potential_round(*args, EPS)
    with pytest.raises(expect) as ours:
        lp.logdomain_post(*args, EPS)
    assert str(ours.value) == str(theirs.value)


def test_the_wrapper_takes_a_2d_cost_only():
    cost, mass, cap = _problem(40, 8)
    f, g, b = _potentials(cost, mass, cap, n_iters=2)
    q = S._quantiles(torch.isfinite(f))
    with pytest.raises(ValueError, match="2-D"):
        lp.logdomain_post(cost[None], f[None], g[None], q[None], EPS)
    rows = lp.logdomain_post(cost, f, g, q, EPS)
    with pytest.raises(ValueError, match=r"b must have shape \(8,\)"):
        lp.logdomain_post_finalize(rows, cost, f, g, b[:-1], EPS)


def _misaligned(n, m):
    """An (n, m) float32 cost, contiguous, whose base address is 4 bytes past a 16-byte boundary."""
    flat = torch.rand(n * m + 4, generator=torch.Generator().manual_seed(m))
    base = (flat.data_ptr() // 4) % 4
    return flat[(1 - base) % 4 :][: n * m].view(n, m)


@pytest.mark.parametrize("m", [4, 36, 512, 1000, 1024, 33, 1001, 1025, "misaligned"])
def test_every_cuda_cost_takes_the_kernel_at_any_width_and_alignment(monkeypatch, m):
    cost = _misaligned(64, 36) if m == "misaligned" else _problem(64, m, seed=7)[0]
    assert (cost.data_ptr() % 16 != 0) == (m == "misaligned")
    n, m = cost.shape
    f, g = torch.randn(n) * 0.1, torch.randn(m) * 0.1
    q = S._quantiles(torch.isfinite(f))
    b = torch.full((m,), 1.0 / m)
    calls = []
    monkeypatch.setattr(lp, "impl_for", lambda x: "kernel")  # as a CUDA tensor reads
    monkeypatch.setattr(lp, "parts", lambda name, like, *args: calls.append(("parts", name, args)) or 3)
    monkeypatch.setattr(lp, "launch", lambda name, like, *args, rows: calls.append(("launch", name, args, rows)))
    monkeypatch.setattr(lp, "finalize", lambda name, like, *args: calls.append(("finalize", name, args)))
    rows = lp.logdomain_post(cost, f, g, q, EPS)
    err = lp.logdomain_post_finalize(rows, cost, f, g, b, EPS)
    (_, pname, pargs), (_, name, args, n_rows), (kind, fname, fargs) = calls
    inv = float(np.float32(1.0) / np.float32(EPS))
    assert pname == name == fname == "logdomain_post" and kind == "finalize" and n_rows == n
    assert pargs == (cost.data_ptr(), n, m)  # the kernel picks its form from the base and the width
    assert args[0] == cost.data_ptr() and args[-4:] == (3, inv, n, m) and rows.col_parts.shape == (3, m)
    assert fargs == (rows.col_parts.data_ptr(), 3, b.data_ptr(), err.data_ptr(), m)
    assert rows.idx.shape == (n,) and rows.idx.dtype == torch.int32 and err.shape == ()


def _edges(cost, f, g):
    """A NaN cost, a +inf cost, and a NaN and a -inf potential (two more padding rows)."""
    cost, f, g = cost.clone(), f.clone(), g.clone()
    cost[5, 0] = float("nan")
    cost[9, -1] = float("inf")
    f[8] = float("nan")
    f[11] = float("-inf")
    return cost, f, g


@pytest.mark.parametrize("n,m", [(0, 8), (5, 4), (1237, 36), (70_000, 8)])
def test_the_cpu_path_is_the_twin_block_by_block(n, m):
    cost, mass, cap = _problem(n, m, seed=n, padding=True, dead=True)
    f, g, b = _potentials(cost, mass, cap, n_iters=4)
    if n > 20:
        cost, f, g = _edges(cost, f, g)
    q = S._quantiles(torch.isfinite(f))
    before = L.launches()
    rows = lp.logdomain_post(cost, f, g, q, EPS)
    err = lp.logdomain_post_finalize(rows, cost, f, g, b, EPS)
    assert L.launches() == before and rows.col_parts is None
    assert torch.equal(rows.idx, pr.potential_round_ref(cost, f, g, q, EPS))  # blocks of 65,536 rows
    assert torch.equal(err, S.marginal_err(cost, f, g, b, EPS))


# --- on the card ------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


def _both(cost, f, g, b, chunk=None):
    """``(idx, err, col_parts)`` of the kernel and ``(idx, err)`` of its twin on the same inputs."""
    q = S.block_quantiles(torch.isfinite(f), chunk)
    rows = lp.logdomain_post(cost, f, g, q, EPS)
    err = lp.logdomain_post_finalize(rows, cost, f, g, b, EPS)
    want = (lp.logdomain_post_round_ref(cost, f, g, q, EPS), S.marginal_err(cost, f, g, b, EPS))
    torch.cuda.synchronize()
    return (rows.idx, err, rows.col_parts), want


def _warps_per_part(cost):
    """The warps whose sums share a workspace row: a CTA's 8 in the rows kernel (rows of at most
    1,024 columns, whole 16-byte multiples on a 16-byte base), one in the kernel for any other row."""
    m = cost.shape[1]
    return 8 if m % 4 == 0 and m <= 1024 and cost.data_ptr() % 16 == 0 else 1


def _sum_tol(n, n_parts, warps_per_part):
    """An absolute bound on |err - err_twin| where the plan's mass is 1 (``sum_j col_j`` ~ 1).

    Recursive float32 summation of positive terms errs by at most (k - 1) 2^-24 of their
    sum, k the length of the chain. A column's sum in the kernel chains at most
    ceil(n / (w n_parts)) rows a lane, the w warps of a part and the ``n_parts`` parts. The
    twin's reduction is bounded as the kernel's, and each exponential adds 2^-22
    (ex2.approx); so |err - err_twin| <= sum_j |col_j - col_j'| <= 2 (k 2^-24 + 2^-22) sum_j col_j.
    """
    k = math.ceil(n / (warps_per_part * n_parts)) + warps_per_part + n_parts
    return 2 * (k * 2.0**-24 + 2.0**-22)


@pytest.mark.card
@pytest.mark.parametrize("seed", [2**31 + 21, 2**33 + 5])
def test_the_kernel_rounds_and_sums_as_its_twin_at_the_cells_shape(card, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    cost = torch.rand((1 << 20, 1024), generator=gen, device=card)
    mass, cap = torch.ones(1 << 20, device=card), torch.ones(1024, device=card)
    f, g, b = _potentials(cost, mass, cap)
    assert L.impl_for(cost) == "kernel"
    (idx, err, parts), (idx_t, err_t) = _both(cost, f, g, b, chunk=65_536)
    agree = float((idx == idx_t).float().mean())
    assert agree >= 0.999, agree
    assert float(err) < 1e-2  # chip_smoke.py's bound on the same step
    tol = _sum_tol(cost.shape[0], parts.shape[0], 8)
    assert abs(float(err) - float(err_t)) <= tol, (float(err), float(err_t), tol)


@pytest.mark.card
@pytest.mark.parametrize("n", [1237, 5, 0])
@pytest.mark.parametrize("m", [4, 36, 512, 1000, 1024, 33, 1001, 1025])
def test_ragged_and_edge_shapes_on_the_card(card, n, m):
    cost, mass, cap = _problem(n, m, seed=n * m + 3, padding=True, dead=True, device=card)
    f, g, b = _potentials(cost, mass, cap, n_iters=10)
    if n > 20:
        cost, f, g = _edges(cost, f, g)
    _the_kernel_near_its_twin(cost, f, g, b)


@pytest.mark.card
@pytest.mark.parametrize("m", [36, 1024, 1025])
def test_a_cost_off_16_byte_alignment_on_the_card(card, m):
    flat = _problem(1, 2000 * m + 4, seed=m, device=card)[0].view(-1)
    cost = flat[1 : 1 + 2000 * m].view(2000, m)
    assert cost.data_ptr() % 16 == 4
    _, mass, cap = _problem(2000, m, padding=True, dead=True, device=card)
    f, g, b = _potentials(cost, mass, cap, n_iters=10)
    _the_kernel_near_its_twin(cost, f, g, b)


def _the_kernel_near_its_twin(cost, f, g, b):
    """One launch of the kernel and one of its finalize; seats and err near the twin's."""
    n = cost.shape[0]
    before = L.launches()
    (idx, err, parts), (idx_t, err_t) = _both(cost, f, g, b)
    after = L.launches()
    launched = {k: after[k] - before[k] for k in ("logdomain_post", "logdomain_post_finalize")}
    assert launched == dict.fromkeys(launched, 1)
    assert idx.dtype == torch.int32 and idx.shape == (n,)
    assert int((idx != idx_t).sum()) <= max(1, n // 1000)  # a CDF on its quantile within rounding
    if n > 5 and bool(torch.isnan(cost[5, 0])):  # from _edges
        assert int(idx[5]) == int(idx_t[5]) == 0  # a NaN cost makes the row's CDF NaN
    tol = 1e-4 * float(err_t) + _sum_tol(n, parts.shape[0], _warps_per_part(cost))
    assert abs(float(err) - float(err_t)) <= tol, (err, err_t)


@pytest.mark.card
@pytest.mark.parametrize("how", ["stale_g", "perturbed_g"])
def test_err_far_from_zero_matches_the_twin(card, how):
    """The g update makes the column marginals exact, so the error is set far from 0 by hand:
    ``f`` of the first iteration against the ``g = 0`` it started from, on costs that rise
    by 1 across the columns, or a converged ``g`` perturbed by 0.4 eps."""
    cost, mass, cap = _problem(262_144, 1024, seed=9, device=card)
    if how == "stale_g":
        cost += torch.linspace(0.0, 1.0, 1024, device=card)
        f, _, b = _potentials(cost, mass, cap, n_iters=1)
        g = torch.zeros_like(b)
    else:
        f, g, b = _potentials(cost, mass, cap)
        g = g + 0.02 * torch.randn(g.shape, generator=torch.Generator().manual_seed(1)).to(card)
    (idx, err, _), (idx_t, err_t) = _both(cost, f, g, b)
    assert float(err_t) > 0.1, float(err_t)  # an O(1) violation
    assert abs(float(err) - float(err_t)) <= 1e-4 * float(err_t), (float(err), float(err_t))
    assert float((idx == idx_t).float().mean()) >= 0.999


@pytest.mark.card
def test_two_launches_give_the_same_bits(card):
    cost, mass, cap = _problem(300_000, 1000, seed=11, padding=True, dead=True, device=card)
    f, g, b = _potentials(cost, mass, cap, n_iters=5)
    one, _ = _both(cost, f, g, b)
    two, _ = _both(cost, f, g, b)
    for x, y in zip(one, two, strict=True):
        assert torch.equal(x, y)


@pytest.mark.card
def test_the_kernel_and_its_finalize_wait_on_nothing(card):
    cost, mass, cap = _problem(100_000, 1024, seed=12, device=card)
    f, g, b = _potentials(cost, mass, cap, n_iters=3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        q = S.block_quantiles(torch.isfinite(f), 50_000)
        rows = lp.logdomain_post(cost, f, g, q, EPS)
        err = lp.logdomain_post_finalize(rows, cost, f, g, b, EPS)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert rows.idx.device.type == "cuda" and err.device.type == "cuda" and float(err) == float(err)
