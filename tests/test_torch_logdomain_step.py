"""The log-domain placement step (``entry.logdomain_placement_step``): its spans, and its seats against the plain reference.

The CPU cases hold the step's spans (by name, nesting, order and attributes,
through a ``tracing`` sink), show that neither a sink nor the profiler moves a
bit of its answers, and compare its seats with the plain float32 reference of
the benchmark's log-domain cell (``rio_bench/reference/flat_logdomain.py``) at
the cell's CPU sizes; the reference with the cost stored in bfloat16, the
cell's control, fails the same limits. The cases marked ``card`` run the step
at the cell's size, 1,048,576 x 1,024: one step launches ``fused_iteration``
30 times, the post-solve kernel ``logdomain_post`` and its finalize once each,
and no other kernel, its spans read ``impl="kernel"`` for the iterations and
the rounding, and it waits on the card nowhere under
``torch.cuda.set_sync_debug_mode("error")``; they skip without a CUDA device.
On a card:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_logdomain_step.py``.
"""

import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from rio_bench import traffic  # noqa: E402
from rio_bench.reference import flat_logdomain as reference  # noqa: E402
from rio_tpu_torch import tracing  # noqa: E402
from rio_tpu_torch.entry import logdomain_placement_step  # noqa: E402
from rio_tpu_torch.kernels import launch as L  # noqa: E402

EPS, ITERS = 0.05, 30
# The CPU sizes of the benchmark's flat-1m-1k-logdomain configuration: 4,096 objects
# over 64 nodes, rounded in 1,024-row chunks.
_SIZES = json.loads(
    (Path(__file__).resolve().parents[1] / "rio_bench/tests/cpu_sizes/configs/flat-1m-1k-logdomain.json").read_text()
)["config"]
N, M, CHUNK = _SIZES["objects"], _SIZES["nodes"], _SIZES["solve"]["round_chunk_rows"]
SEEDS = [2**31 + 7, 2**33 + 5, 12_345]
# On the CPU the step's iterations run the kernel's eager twin, whose float32
# arithmetic is the reference's up to the order of its sums, so only a row on
# a boundary of its CDF may change its seat (none did on 16 costs of 8 seeds);
# the bfloat16 control moves 0.83-1.64% of the rows on the same costs.
SEAT_MISMATCH = 0.002
# The mean cost moves only with the seats; float64 means of equal seats are
# equal. 1e-4 is far above the float32 rounding of any sum; the control's gap
# is 4.1e-5 to 1.9e-2 (seat_mismatch is what it fails on every cost).
COST_GAP = 1e-4
# The rounding's pass reads the cost once for the column sums too, so the error's
# finalize follows it.
SPANS = ["logdomain.iterations", "logdomain.round", "logdomain.err", "placement.repair", "placement.step"]


def _problem(seed, k=0, n=N, m=M, device="cpu"):
    cost = traffic.uniform_costs(seed, k, n, m, device)
    return cost, torch.ones(n, device=device), torch.ones(m, device=device)


def _step(cost, mass, cap, chunk=CHUNK):
    return logdomain_placement_step(cost, mass, cap, eps=EPS, n_iters=ITERS, chunk=chunk, device=cost.device)


class _Sink:
    def __init__(self):
        self.spans = []

    def __enter__(self):
        tracing.add_sink(self.spans.append)
        return self.spans

    def __exit__(self, *exc):
        tracing.clear_sinks()
        return False


def test_the_step_opens_its_spans_in_order_with_their_attributes():
    with _Sink() as spans:
        _step(*_problem(SEEDS[0]))
    assert [s.name for s in spans] == SPANS  # sinks see each span as it closes
    by_name = {s.name: s for s in spans}
    step = by_name["placement.step"]
    assert step.parent_id == ""
    assert all(by_name[name].parent_id == step.span_id for name in SPANS[:-1])
    assert len({s.trace_id for s in spans}) == 1
    assert by_name["logdomain.iterations"].attrs == {"impl": "eager", "iterations": ITERS}
    assert by_name["logdomain.round"].attrs == {"impl": "eager"}
    assert by_name["logdomain.err"].attrs == {} and by_name["placement.repair"].attrs == {}


@pytest.mark.parametrize("traced", ["sink", "profiler"])
def test_spans_change_no_bit_of_the_answers(traced):
    problem = _problem(SEEDS[1])
    want = _step(*problem)
    if traced == "sink":
        with _Sink():
            got = _step(*problem)
    else:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            got = _step(*problem)
    for x, y in zip(got, want, strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _judged(seed, answer_of):
    cost, mass, cap = _problem(seed)
    ref = reference.place(cost, cap, eps=EPS, n_iters=ITERS, chunk=CHUNK)
    return reference.judge(cost, ref, answer_of(cost, mass, cap))


@pytest.mark.parametrize("seed", SEEDS)
def test_the_step_seats_as_the_plain_reference(seed):
    got = _judged(seed, lambda cost, mass, cap: _step(cost, mass, cap)[0].numpy())
    assert got["quota_gap"] == 0, got
    assert got["seat_mismatch"] <= SEAT_MISMATCH, got
    assert got["cost_gap"] <= COST_GAP, got


@pytest.mark.parametrize("seed", SEEDS)
def test_the_bfloat16_control_fails_the_limits(seed):
    def control(cost, mass, cap):
        return reference.place(cost, cap, eps=EPS, n_iters=ITERS, chunk=CHUNK, store="bfloat16")

    got = _judged(seed, control)
    assert got["seat_mismatch"] > SEAT_MISMATCH or got["cost_gap"] > COST_GAP, got


def test_the_reference_rounds_in_whole_chunks():
    cost, _, cap = _problem(SEEDS[0])
    with pytest.raises(ValueError, match="multiple of chunk"):
        reference.place(cost, cap, eps=EPS, n_iters=2, chunk=1000)


# --- on the card ----------------------------------------------------------------


@pytest.fixture(scope="module")
def full_size():
    """The benchmark cell's problem, 1,048,576 x 1,024 float32 on the card, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    problem = _problem(2**31 + 21, n=1 << 20, m=1024, device=torch.device("cuda"))
    _step(*problem, chunk=65_536)  # builds the kernels
    torch.cuda.synchronize()
    yield problem
    del problem
    torch.cuda.empty_cache()


@pytest.mark.card
def test_one_step_on_the_card_launches_the_log_domain_kernel_30_times_and_nothing_else(full_size):
    L.reset_launches()
    _step(*full_size, chunk=65_536)
    torch.cuda.synchronize()
    launched = {name: count for name, count in L.launches().items() if count}
    assert launched == {"fused_iteration": ITERS, "logdomain_post": 1, "logdomain_post_finalize": 1}


@pytest.mark.card
def test_the_spans_on_the_card_name_the_kernel_and_the_eager_rounding(full_size):
    with _Sink() as spans:
        _step(*full_size, chunk=65_536)
    torch.cuda.synchronize()
    by_name = {s.name: s for s in spans}
    assert [s.name for s in spans] == SPANS
    assert by_name["logdomain.iterations"].attrs == {"impl": "kernel", "iterations": ITERS}
    assert by_name["logdomain.round"].attrs == {"impl": "kernel"}  # the post-solve kernel takes 1,024 columns


@pytest.mark.card
@pytest.mark.parametrize("traced", ["off", "profiler"])
def test_the_step_on_the_card_waits_on_nothing(full_size, traced):
    """No operator of the step synchronises with the host, its spans' CUDA events included."""
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    if traced == "profiler":
        prof.__enter__()
    torch.cuda.set_sync_debug_mode("error")
    try:
        seats, mean_cost, err = _step(*full_size, chunk=65_536)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        if traced == "profiler":
            prof.__exit__(None, None, None)
    assert seats.device.type == "cuda" and seats.dtype == torch.int32
    counts = torch.bincount(seats.long(), minlength=1024)
    assert int(counts.min()) == int(counts.max()) == 1024
    assert float(err) < 1e-2  # chip_smoke.py's bound on the same step
