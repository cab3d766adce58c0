"""The K-build kernel (``ops/kbuild.py``, ``kernels/csrc/kbuild.cu``) and its place in the step.

The CPU cases hold the wrapper's checks, the plain twin against the eager
K build the step ran before the kernel, and the step's CPU results bit for
bit. The cases marked ``card`` compare the kernel with its twin and count
its launches; they skip without a CUDA device. On a card:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kbuild_kernel.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rio_tpu_torch import entry, tracing  # noqa: E402
from rio_tpu_torch.kernels.launch import launches  # noqa: E402
from rio_tpu_torch.ops import kbuild as kb  # noqa: E402
from rio_tpu_torch.ops import scaling as S  # noqa: E402
from rio_tpu_torch.ops.sinkhorn import normalize_marginals  # noqa: E402

EPS = 0.05


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


def _cost(n, m, *, seed=0, specials=True, device="cpu"):
    """U[0, 1) costs; with ``specials``, a dead column (+inf), a row of +inf, a NaN, a -inf."""
    rng = np.random.default_rng(seed)
    c = rng.random((n, m), dtype=np.float32)
    if specials and n > 3:
        c[:, m // 2] = np.inf  # a dead node
        c[1, :] = np.inf  # a row with no finite entry
        c[2, m // 3] = np.nan
        c[3, m - 1] = -np.inf
    return torch.from_numpy(c).to(device)


def _eager_build(cost, eps, dtype):
    """The K build as ``scaling_kernel`` wrote it before the kernel."""
    cost = cost.float()
    shift = cost.min(dim=-1, keepdim=True).values
    shift = torch.where(torch.isfinite(shift), shift, 0.0)
    K = cost - shift
    K.div_(-eps).exp_()
    return K.to(dtype), shift[..., 0]


def _same(x, y) -> bool:
    """Equal values, NaN where NaN, and the same dtype and shape."""
    if x.dtype != y.dtype or x.shape != y.shape:
        return False
    nx, ny = torch.isnan(x), torch.isnan(y)
    return torch.equal(nx, ny) and torch.equal(x.masked_fill(nx, 0), y.masked_fill(ny, 0))


# --- the wrapper's checks ----------------------------------------------------


@pytest.mark.parametrize(
    "case", ["cost_dtype", "k_dtype", "rank", "no_columns", "device", "noncontiguous"],
)
def test_the_wrapper_rejects_what_the_kernel_does_not_take(case):
    cost, dtype, expect = _cost(16, 8, specials=False), torch.bfloat16, ValueError
    if case == "cost_dtype":
        cost, expect = cost.double(), TypeError
    elif case == "k_dtype":
        dtype, expect = torch.float16, TypeError
    elif case == "rank":
        cost = cost[None]
    elif case == "no_columns":
        cost = cost[:, :0].contiguous()
    elif case == "device":
        cost = cost.to("meta")
    else:
        cost = torch.rand(8, 16).t()
    with pytest.raises(expect):
        kb.kbuild(cost, eps=EPS, kernel_dtype=dtype)


# --- the twin against the eager K build ----------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("n,m", [(0, 8), (5, 1), (64, 1), (300, 31), (300, 256), (129, 1000)])
def test_the_twin_equals_the_eager_k_build_with_dead_nodes_nan_and_minus_inf(n, m, dtype):
    cost = _cost(n, m, seed=n + m)
    K, shift = kb.kbuild_ref(cost, eps=EPS, kernel_dtype=dtype)
    K0, shift0 = _eager_build(cost, EPS, dtype)
    assert _same(K, K0) and _same(shift, shift0)
    assert K.shape == (n, m) and shift.shape == (n,) and shift.dtype == torch.float32
    assert bool(torch.isfinite(shift).all())
    if n > 3 and m > 1:
        assert float(shift[1]) == 0.0 and bool((K[1] == 0).all())  # no finite entry
        assert float(shift[2]) == 0.0 and bool(torch.isnan(K[2, m // 3]))  # the NaN row
        assert float(shift[3]) == 0.0 and float(K[3, m - 1]) == float("inf")  # -inf


def test_scaling_kernel_still_builds_k_as_before_batched_too():
    cost = torch.stack([_cost(40, 24, seed=s) for s in range(3)])
    mass, cap = torch.rand(3, 40) + 0.5, torch.rand(3, 24) + 0.5
    a, b, K, shift = S.scaling_kernel(cost, mass, cap, eps=EPS, kernel_dtype=torch.bfloat16)
    K0, shift0 = _eager_build(cost, EPS, torch.bfloat16)
    a0, b0 = normalize_marginals(mass, cap)
    assert _same(K, K0) and _same(shift, shift0)
    assert torch.equal(a, a0) and torch.equal(b, b0)


# --- the step on the CPU ------------------------------------------------------


@pytest.mark.parametrize("core", ["scaling_core", "fused_scaling_core"])
def test_the_cores_on_the_cpu_equal_the_eager_k_build_bit_for_bit(core):
    cost, mass, cap = entry.make_problem(2048, 64, seed=3, device="cpu")
    u, v, K, shift = getattr(S, core)(cost, mass, cap, eps=EPS, n_iters=8)
    K0, shift0 = _eager_build(cost, EPS, torch.bfloat16)
    assert torch.equal(K, K0) and torch.equal(shift, shift0)
    if core == "fused_scaling_core":
        a, b = normalize_marginals(mass, cap)
        v0 = torch.ones_like(b)
        for _ in range(8):
            u0, v0 = S.fused_scaling_iteration_ref(K0, a, b, v0)
        assert torch.equal(u, u0) and torch.equal(v, v0)


def test_placement_step_on_the_cpu_is_bit_identical_to_the_eager_k_build(monkeypatch):
    cost, mass, cap = entry.make_problem(4096, 64, seed=9, device="cpu")
    got = entry.placement_step(cost, mass, cap, n_iters=12, chunk=1024, device="cpu")

    def eager_kernel(cost, row_mass, col_capacity, *, eps, kernel_dtype):
        return (*normalize_marginals(row_mass, col_capacity), *_eager_build(cost, eps, kernel_dtype))

    monkeypatch.setattr(S, "scaling_kernel", eager_kernel)
    want = entry.placement_step(cost, mass, cap, n_iters=12, chunk=1024, device="cpu")
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_the_k_build_span_reads_eager_on_the_cpu():
    seen = []
    tracing.add_sink(seen.append)
    try:
        cost, mass, cap = entry.make_problem(512, 16, seed=2, device="cpu")
        entry.placement_step(cost, mass, cap, n_iters=4, chunk=128, device="cpu")
        S.fused_scaling_core(cost, mass, cap, n_iters=2)
    finally:
        tracing.clear_sinks()
    assert [s.attrs for s in seen if s.name == "scaling.k_build"] == [{"impl": "eager"}] * 2


# --- on the card ----------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m", [1, 31, 32, 256, 1000, 1024, 1500])
@pytest.mark.parametrize("n", [1, 1000, 65537])
def test_the_kernel_equals_its_twin_on_ragged_shapes(card, n, m, dtype):
    cost = _cost(n, m, seed=n + m, device=card)
    before = launches()["kbuild"]
    K, shift = kb.kbuild(cost, eps=EPS, kernel_dtype=dtype)
    torch.cuda.synchronize()
    assert launches()["kbuild"] == before + 1
    K0, shift0 = kb.kbuild_ref(cost, eps=EPS, kernel_dtype=dtype)
    assert _same(K, K0) and _same(shift, shift0)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_the_kernel_takes_a_misaligned_cost(card, dtype):
    n, m, offset = 777, 1024, 3
    cost = torch.empty(n * m + offset, dtype=torch.float32, device=card)[offset:].view(n, m)
    cost.copy_(_cost(n, m, seed=5, device=card))
    K, shift = kb.kbuild(cost, eps=EPS, kernel_dtype=dtype)
    K0, shift0 = kb.kbuild_ref(cost, eps=EPS, kernel_dtype=dtype)
    assert _same(K, K0) and _same(shift, shift0)


@pytest.mark.card
def test_a_card_step_launches_the_kernel_once(card):
    cost, mass, cap = entry.make_problem(65536, 256, seed=4, device=card)
    seen = []
    tracing.add_sink(seen.append)
    try:
        for _ in range(2):
            before = launches()["kbuild"]
            entry.placement_step(cost, mass, cap, n_iters=10, chunk=16384, device=card)
            torch.cuda.synchronize()
            assert launches()["kbuild"] == before + 1
    finally:
        tracing.clear_sinks()
    assert [s.attrs for s in seen if s.name == "scaling.k_build"] == [{"impl": "kernel"}] * 2
