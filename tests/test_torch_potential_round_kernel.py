"""The potential-rounding kernel (``ops/potential_round.py``, ``kernels/csrc/potential_round.cu``) and its place in the two-level solve.

The CPU cases hold the wrapper's checks and its dispatch, the wrapper and
``plan_rounded_assign`` against the eager chain ``plan_rounded_assign`` ran
inline before the kernel, the ``hier.round`` spans, and the two-level solve's
CPU results bit for bit. The cases marked ``card`` compare the kernel with its
twin bit for bit and count its launches; they skip without a CUDA device. On a
card: ``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_potential_round_kernel.py``.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rio_tpu_torch import tracing  # noqa: E402
from rio_tpu_torch.kernels.launch import launches  # noqa: E402
from rio_tpu_torch.ops import potential_round as pr  # noqa: E402
from rio_tpu_torch.ops import scaling as C  # noqa: E402
from rio_tpu_torch.parallel import hierarchical as H  # noqa: E402

# The package re-exports the function ``sinkhorn`` under the module's name.
S = importlib.import_module("rio_tpu_torch.ops.sinkhorn")

N_RAGGED = 1237  # a multiple of no tile of 32 rows
WIDTHS = [1, 5, 16, 31, 32]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


def _inline_plan_rounded_assign(cost, f, g, eps=0.05):
    """``plan_rounded_assign`` as it computed the seats inline before the kernel."""
    cost = cost.float()
    is_real = torch.isfinite(f)
    logit = (f[..., :, None] + g[..., None, :] - cost) / eps
    alive_cols = torch.isfinite(g)
    padding_logit = torch.where(alive_cols, 0.0, float("-inf"))
    logit = torch.where(is_real[..., :, None], logit, padding_logit[..., None, :])
    p = torch.softmax(logit, dim=-1)
    cum = torch.cumsum(p, dim=-1)
    q = S._quantiles(is_real)
    idx = (cum < q[..., None]).sum(dim=-1, dtype=torch.int32)
    return idx.clamp(0, cost.shape[-1] - 1)


def _solved(batch, n, m, *, seed=0, device="cpu"):
    """``(cost, f, g)`` of a 30-iteration scaling solve, with padding rows and dead columns.

    ``batch`` None gives one (n, m) problem, else (batch, n, m) problems.
    """
    rng = np.random.default_rng(seed)
    shape = (n, m) if batch is None else (batch, n, m)
    cost = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    mass = torch.ones(shape[:-1])
    mass[..., 3::7] = 0.0
    cap = torch.ones((*shape[:-2], m))
    if m > 2:
        cap[..., 2::11] = 0.0
    res = C.scaling_sinkhorn(cost, mass, cap, eps=0.05, n_iters=30)
    return cost.to(device), res.f.contiguous().to(device), res.g.contiguous().to(device)


def _with_edges(cost, f, g):
    """Rows and columns the kernel must treat as the eager chain does: a NaN cost, a row
    whose every column is dead, a padding row with none live."""
    cost, f, g = cost.clone(), f.clone(), g.clone()
    flat_cost, flat_f = cost.view(-1, cost.shape[-1]), f.view(-1)
    flat_cost[5, 0] = float("nan")
    flat_f[8] = float("nan")  # NaN potential: a padding row
    flat_cost[9, -1] = float("inf")
    if g.dim() == 2:  # the second problem has no live column
        g[1] = float("-inf")
    return cost, f, g


def _quantiles_of(f):
    return S._quantiles(torch.isfinite(f))


# --- the wrapper's checks ----------------------------------------------------


@pytest.mark.parametrize(
    "case", ["cost_dtype", "f_dtype", "q_dtype", "rank", "f_len", "g_len", "q_len", "batch",
             "no_columns", "device", "noncontiguous"],
)
def test_the_wrapper_rejects_what_the_kernel_does_not_take(case):
    cost, f, g = _solved(None, 40, 8)
    q = _quantiles_of(f)
    expect = ValueError
    if case == "cost_dtype":
        cost, expect = cost.double(), TypeError
    elif case == "f_dtype":
        f, expect = f.half(), TypeError
    elif case == "q_dtype":
        q, expect = q.double(), TypeError
    elif case == "rank":
        cost, f, g, q = cost[None, None], f[None, None], g[None, None], q[None, None]
    elif case == "f_len":
        f = f[:-1]
    elif case == "g_len":
        g = torch.cat([g, g[:1]])
    elif case == "q_len":
        q = q[:-1]
    elif case == "batch":
        g = g[None]  # a batch of one g against an unbatched cost
    elif case == "no_columns":
        cost, g = cost[:, :0], g[:0]
    elif case == "device":
        g = g.to("meta")
    else:
        cost = cost.t().contiguous().t()
    with pytest.raises(expect):
        pr.potential_round(cost, f, g, q, 0.05)


# --- the dispatch ------------------------------------------------------------------


@pytest.mark.parametrize("m,impl", [(1, "kernel"), (32, "kernel"), (33, "eager"), (1024, "eager")])
def test_rows_over_32_columns_take_the_twin(monkeypatch, m, impl):
    cost, f, g = _solved(None, 64, m, seed=m)
    q = _quantiles_of(f)
    assert pr.potential_round_impl(cost) == "eager"  # on the CPU, at every width
    launched = []
    monkeypatch.setattr(pr, "impl_for", lambda x: "kernel")  # as a CUDA tensor reads
    monkeypatch.setattr(pr, "launch", lambda name, like, *args, rows: launched.append((name, args, rows)))
    assert pr.potential_round_impl(cost) == impl
    got = pr.potential_round(cost, f, g, q, 0.05)
    if impl == "eager":
        assert launched == [] and torch.equal(got, pr.potential_round_ref(cost, f, g, q, 0.05))
    else:
        ((name, args, rows),) = launched
        inv = float(np.float32(1.0) / np.float32(0.05))
        assert name == "potential_round" and rows == 64 and args[-4:] == (1, 64, m, inv)
        assert got.shape == (64,) and got.dtype == torch.int32


# --- the wrapper and plan_rounded_assign against the inline chain ---------------------


@pytest.mark.parametrize("m", WIDTHS)
@pytest.mark.parametrize("batch", [None, 3], ids=["coarse", "fine"])
def test_the_wrapper_equals_the_old_inline_rounding(batch, m):
    cost, f, g = _solved(batch, N_RAGGED, m, seed=m + (batch or 0))
    want = _inline_plan_rounded_assign(cost, f, g)
    assert want.shape == f.shape and want.dtype == torch.int32
    assert torch.equal(pr.potential_round(cost, f, g, _quantiles_of(f), 0.05), want)
    assert torch.equal(S.plan_rounded_assign(cost, f, g, 0.05), want)
    assert bool((~torch.isfinite(f)).any()) and bool((~torch.isfinite(g)).any()) == (m > 2)


@pytest.mark.parametrize("batch", [None, 3], ids=["coarse", "fine"])
def test_nan_costs_nan_potentials_and_rows_with_no_live_column(batch):
    cost, f, g = _with_edges(*_solved(batch, 64, 16, seed=4))
    want = _inline_plan_rounded_assign(cost, f, g)
    assert torch.equal(S.plan_rounded_assign(cost, f, g, 0.05), want)
    flat = want.view(-1)
    assert int(flat[5]) == 0  # a NaN in the row makes every p NaN: no column counts
    if batch is not None:
        assert bool((want[1] == 0).all())  # no live column: the logits are all -inf


# --- the two-level solve on the CPU ------------------------------------------------


def _solve(**kw):
    gen = torch.Generator().manual_seed(5)
    obj = torch.randn(8192, 4, generator=gen)
    node = torch.randn(4, 64, generator=gen) * 0.2
    cap = torch.ones(64)
    alive = torch.ones(64)
    alive[[3, 17, 18]] = 0.0
    return H.chunked_hierarchical_assign(
        obj, node, cap, alive, n_groups=8, n_chunks=2, coarse_iters=10, fine_iters=10, **kw,
    )


def test_the_two_level_solve_on_the_cpu_is_bit_identical_to_the_inline_rounding(monkeypatch):
    got = _solve()
    monkeypatch.setattr(H, "plan_rounded_assign", _inline_plan_rounded_assign)
    want = _solve()
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_the_round_spans_nest_in_the_coarse_and_fine_stages_and_read_eager():
    seen = []
    tracing.add_sink(seen.append)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _solve()
    finally:
        tracing.clear_sinks()
    assert [s.attrs for s in seen if s.name == "hier.round"] == [{"impl": "eager"}] * 4
    ranges = {}
    for e in prof.events():
        ranges.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    rounds = sorted(ranges["hier.round"])
    stages = sorted(ranges["hier.coarse"] + ranges["hier.fine"])
    assert len(rounds) == len(stages) == 4
    for (c0, c1), (r0, r1) in zip(stages, rounds):
        assert c0 <= r0 and r1 <= c1


# --- on the card ----------------------------------------------------------------


def _captured_rounds(monkeypatch, device, *, seed, dead):
    """The ``(cost, f, g, q, eps)`` of both roundings of one two-level solve at the benchmark
    cell's chunk: 655,360 objects, d = 16, 1,024 nodes in 32 groups, 30 iterations a stage."""
    calls = []
    real = S.potential_round

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(S, "potential_round", spy)
    gen = torch.Generator(device=device).manual_seed(seed)
    obj = torch.randn(655_360, 16, generator=gen, device=device)
    node = torch.randn(16, 1024, generator=gen, device=device) * 0.2
    alive = torch.ones(1024, device=device)
    alive[list(dead)] = 0.0
    H.hierarchical_assign(obj, node, torch.ones(1024, device=device), alive, n_groups=32)
    return calls


@pytest.mark.card
@pytest.mark.parametrize("dead", [(), tuple(range(5, 1024, 33))[:31]], ids=["all_live", "31_dead"])
@pytest.mark.parametrize("seed", [24, 2_300_000_205])
def test_the_kernel_equals_the_twin_at_the_cells_shapes(card, monkeypatch, seed, dead):
    coarse, fine = _captured_rounds(monkeypatch, card, seed=seed, dead=dead)
    assert tuple(coarse[0].shape) == (655_360, 32) and tuple(fine[0].shape) == (32, 25_600, 32)
    for args in (coarse, fine):
        before = launches()["potential_round"]
        got = pr.potential_round(*args)
        torch.cuda.synchronize()
        assert launches()["potential_round"] == before + 1
        want = pr.potential_round_ref(*args)
        assert int((got != want).sum()) == 0  # bit for bit: the eager chain's order
    if dead:
        assert bool((~torch.isfinite(fine[2])).sum() == len(dead))


@pytest.mark.card
@pytest.mark.parametrize("m", WIDTHS)
@pytest.mark.parametrize("batch", [None, 3], ids=["coarse", "fine"])
def test_the_kernel_on_ragged_widths_with_padding_rows(card, batch, m):
    cost, f, g = _solved(batch, N_RAGGED, m, seed=m + (batch or 0), device=card)
    q = _quantiles_of(f)
    before = launches()["potential_round"]
    got = pr.potential_round(cost, f, g, q, 0.05)
    torch.cuda.synchronize()
    assert launches()["potential_round"] == before + 1
    assert torch.equal(got, pr.potential_round_ref(cost, f, g, q, 0.05))
    assert torch.equal(S.plan_rounded_assign(cost, f, g, 0.05), got)


@pytest.mark.card
@pytest.mark.parametrize("batch", [None, 3], ids=["coarse", "fine"])
def test_the_kernel_takes_nan_rows_dead_rows_and_an_unaligned_row_base(card, batch):
    cost, f, g = _with_edges(*_solved(batch, 999, 31, seed=7))
    flat = torch.empty(cost.numel() + 1, device=card)
    shifted = flat[1:].view(cost.shape)  # 4-byte aligned, not 16
    shifted.copy_(cost.to(card))
    f, g = f.to(card), g.to(card)
    q = _quantiles_of(f)
    got = pr.potential_round(shifted, f, g, q, 0.05)
    assert torch.equal(got, pr.potential_round_ref(shifted, f, g, q, 0.05))
    assert int(got.view(-1)[5]) == 0  # the NaN cost's row


@pytest.mark.card
def test_a_card_solve_launches_the_kernel_twice_a_chunk(card):
    gen = torch.Generator(device=card).manual_seed(3)
    obj = torch.randn(4 * 65_536, 16, generator=gen, device=card)
    node = torch.randn(16, 1024, generator=gen, device=card) * 0.2
    cap = torch.ones(1024, device=card)
    alive = torch.ones(1024, device=card)
    alive[[5, 700]] = 0.0
    seen = []
    tracing.add_sink(seen.append)
    try:
        before = launches()["potential_round"]
        res = H.chunked_hierarchical_assign(obj, node, cap, alive, n_groups=32, n_chunks=4)
        torch.cuda.synchronize()
        assert launches()["potential_round"] == before + 8
    finally:
        tracing.clear_sinks()
    assert int(res.overflow) == 0
    assert [s.attrs for s in seen if s.name == "hier.round"] == [{"impl": "kernel"}] * 8
