"""The CDF-rounding kernel (``ops/cdf_round.py``, ``kernels/csrc/cdf_round.cu``) and its place in the step.

The CPU cases hold the wrapper's checks, the plain twin and the batched
quantiles against the eager chain the step ran before the kernel, and the
step's CPU results bit for bit against that chain. The cases marked
``card`` compare the kernel with its twin and count its launches; they skip
without a CUDA device. On a card:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_round_kernel.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rio_tpu_torch import entry, tracing  # noqa: E402
from rio_tpu_torch.kernels.launch import launches  # noqa: E402
from rio_tpu_torch.ops import cdf_round as cr  # noqa: E402
from rio_tpu_torch.ops import scaling as S  # noqa: E402
from rio_tpu_torch.ops.sinkhorn import (  # noqa: E402
    _quantiles,
    block_quantiles,
    exact_quota_repair,
    normalize_marginals,
    plan_rounded_assign_from_scaling,
)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


def _state(n, m, *, seed=0, dtype=torch.bfloat16, padding=True, dead=True, device="cpu"):
    """A scaling state ``(K, u, v, a)`` with padding rows (``u == 0``) and dead columns (``v == 0``)."""
    rng = np.random.default_rng(seed)
    K = torch.from_numpy(rng.random((n, m), dtype=np.float32) * 0.99 + 0.01).to(dtype)
    u = rng.random(n, dtype=np.float32) / n + 1e-7
    v = rng.random(m, dtype=np.float32) + 0.5
    if padding:
        u[::7] = 0.0
    if dead and m > 1:
        v[::11] = 0.0
    a = np.where(u > 0, 1.0, 0.0).astype(np.float32)
    a /= max(a.sum(), 1.0)
    return tuple(
        x.to(device) for x in (K, torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(a))
    )


def _eager_chain(cost, mass, cap, u, v, K, chunk):
    """The step's rounding, check and repair as they ran before the kernel."""
    n = K.shape[0]
    blocks = [slice(None)] if chunk is None else [slice(i, i + chunk) for i in range(0, n, chunk)]
    rounded = torch.cat([plan_rounded_assign_from_scaling(K[r], u[r], v) for r in blocks])
    expected = cap / cap.sum().clamp_min(1e-30) * n
    assignment = exact_quota_repair(rounded, expected)
    mean_cost = cost.gather(1, assignment[:, None].long()).mean()
    a, _ = normalize_marginals(mass, cap)
    vk = v.to(K.dtype).float()
    err = torch.zeros((), dtype=torch.float32)
    for i in range(0, n, 65536):
        r = slice(i, i + 65536)
        err += (u[r] * (K[r].float() @ vk) - a[r]).abs().sum()
    return assignment, mean_cost, err


# --- the wrapper's checks ----------------------------------------------------


@pytest.mark.parametrize(
    "case", ["k_dtype", "u_dtype", "q_shape", "v_shape", "k_rank", "no_columns", "device",
             "noncontiguous_k", "noncontiguous_q"],
)
def test_the_wrapper_rejects_what_the_kernel_does_not_take(case):
    K, u, v, a = _state(16, 8)
    q = block_quantiles(u > 0)
    expect = ValueError
    if case == "k_dtype":
        K, expect = K.double(), TypeError
    elif case == "u_dtype":
        u, expect = u.half(), TypeError
    elif case == "q_shape":
        q = q[:-1]
    elif case == "v_shape":
        v = torch.ones(9)
    elif case == "k_rank":
        K = K[None]
    elif case == "no_columns":
        K, v = K[:, :0].contiguous(), v[:0]
    elif case == "device":
        a = a.to("meta")
    elif case == "noncontiguous_k":
        K = torch.rand(8, 16).to(K.dtype).t()
    else:
        q = torch.stack([q, q], 1)[:, 0]
    with pytest.raises(expect):
        cr.cdf_round(K, u, v, a, q)


# --- the twin and the batched quantiles against the eager chain --------------


@pytest.mark.parametrize("chunk", [None, 128, 512])
def test_batched_quantiles_equal_the_per_chunk_quantiles(chunk):
    _, u, _, _ = _state(1024, 8)
    u[200:260] = 0.0  # a run of padding rows across a chunk boundary
    want = _quantiles(u > 0) if chunk is None else torch.cat(
        [_quantiles(u[i : i + chunk] > 0) for i in range(0, 1024, chunk)]
    )
    assert torch.equal(block_quantiles(u > 0, chunk), want)


def test_chunk_quantiles_needs_whole_chunks():
    with pytest.raises(ValueError):
        block_quantiles(torch.ones(100) > 0, 64)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("chunk", [None, 256])
@pytest.mark.parametrize("m", [1, 31, 256, 300])
def test_the_twin_rounds_as_the_eager_chain_with_padding_and_dead_columns(dtype, chunk, m):
    n = 1024
    K, u, v, a = _state(n, m, seed=m, dtype=dtype)
    blocks = [slice(None)] if chunk is None else [slice(i, i + chunk) for i in range(0, n, chunk)]
    want = torch.cat([plan_rounded_assign_from_scaling(K[r], u[r], v) for r in blocks])
    idx, res = cr.cdf_round_ref(K, u, v, a, block_quantiles(u > 0, chunk))
    assert idx.dtype == torch.int32 and res.dtype == torch.float32
    assert torch.equal(idx, want)
    mass = (u > 0).float()
    err = entry.row_marginal_err(K, u, v, mass, torch.ones(m))
    assert float(res.sum()) == pytest.approx(float(err), rel=1e-6)


# --- the step on the CPU ------------------------------------------------------


@pytest.mark.parametrize("chunk", [None, 1024])
def test_round_and_repair_on_the_cpu_equals_the_eager_chain_bit_for_bit(chunk):
    cost, mass, cap = entry.make_problem(4096, 64, seed=9, device="cpu")
    u, v, K, _ = S.scaling_core_auto(cost, mass, cap, eps=0.05, n_iters=12)
    got = entry.round_and_repair(cost, mass, cap, u, v, K, chunk=chunk)
    want = _eager_chain(cost, mass, cap, u, v, K, chunk)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_the_round_span_reads_eager_on_the_cpu():
    seen = []
    tracing.add_sink(seen.append)
    try:
        cost, mass, cap = entry.make_problem(512, 16, seed=2, device="cpu")
        entry.placement_step(cost, mass, cap, n_iters=4, chunk=128, device="cpu")
    finally:
        tracing.clear_sinks()
    (rnd,) = [s for s in seen if s.name == "placement.round"]
    assert rnd.attrs == {"impl": "eager"}
    names = [s.name for s in seen if s.name.startswith("placement.") and s.name != "placement.step"]
    assert names == ["placement.round", "placement.row_check", "placement.repair"]


# --- on the card ----------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m", [1, 31, 256, 1000, 1024, 1500])
@pytest.mark.parametrize("n", [1, 1000, 65537])
def test_the_kernel_matches_its_twin_on_ragged_shapes(card, n, m, dtype):
    K, u, v, a = _state(n, m, seed=n + m, dtype=dtype, device=card)
    q = block_quantiles(u > 0)
    before = launches()["cdf_round"]
    idx, res = cr.cdf_round(K, u, v, a, q)
    torch.cuda.synchronize()
    assert launches()["cdf_round"] == before + 1
    idx_p, res_p = cr.cdf_round_ref(K, u, v, a, q)
    assert int(idx.min()) >= 0 and int(idx.max()) < m
    assert float((idx == idx_p).float().mean()) >= 0.999
    assert float(res.sum()) == pytest.approx(float(res_p.sum()), rel=1e-5)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_the_kernel_takes_a_misaligned_k(card, dtype):
    n, m, offset = 777, 1024, 3
    K0, u, v, a = _state(n, m, seed=5, dtype=dtype, device=card)
    K = torch.empty(n * m + offset, dtype=dtype, device=card)[offset:].view(n, m)
    K.copy_(K0)
    q = block_quantiles(u > 0)
    idx, res = cr.cdf_round(K, u, v, a, q)
    idx_p, res_p = cr.cdf_round_ref(K, u, v, a, q)
    assert float((idx == idx_p).float().mean()) >= 0.999
    assert float(res.sum()) == pytest.approx(float(res_p.sum()), rel=1e-5)


@pytest.mark.card
def test_a_card_step_launches_the_kernel_once_and_no_eager_rounding(card, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the eager rounding ran on the card")

    monkeypatch.setattr(cr, "cdf_round_ref", refuse)
    monkeypatch.setattr(entry, "row_marginal_err", refuse)
    cost, mass, cap = entry.make_problem(65536, 256, seed=4, device=card)
    seen = []
    tracing.add_sink(seen.append)
    try:
        for _ in range(2):
            before = launches()
            assignment, _, err = entry.placement_step(
                cost, mass, cap, n_iters=10, chunk=16384, device=card
            )
            torch.cuda.synchronize()
            after = launches()
            assert after["cdf_round"] == before["cdf_round"] + 1
            assert after["fused_scaling_iteration"] == before["fused_scaling_iteration"] + 10
    finally:
        tracing.clear_sinks()
    assert [s.attrs for s in seen if s.name == "placement.round"] == [{"impl": "kernel"}] * 2
    loads = torch.bincount(assignment.long(), minlength=256)
    assert bool((loads == 256).all()) and 0.0 <= float(err) < 1e-2
