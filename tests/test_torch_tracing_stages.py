"""The port's spans on the profiler's clock: stage ranges of the two placement paths, and the stage ring.

``rio_tpu_torch.tracing.span`` opens a ``torch.profiler`` range while the
profiler records, and times its stage into a ring per name (host
durations here: this process has no CUDA). Everything runs on the CPU.
"""

import asyncio
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from rio_tpu_torch import tracing  # noqa: E402
from rio_tpu_torch.entry import make_problem, placement_step  # noqa: E402
from rio_tpu_torch.object_placement.torch_placement import TorchObjectPlacement  # noqa: E402
from rio_tpu_torch.parallel.hierarchical import chunked_hierarchical_assign  # noqa: E402
from rio_tpu_torch.registry import ObjectId  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FLAT_STAGES = [
    "scaling.k_build", "scaling.iterations", "placement.row_check", "placement.round",
    "placement.repair",
]
HIER_STAGES = ["hier.coarse", "hier.bucket", "hier.fine", "hier.map_back"]
N_CHUNKS = 4


def _profiled(fn):
    """``(result, ranges)``: ``fn()`` under a CPU profiler, and its host ranges as (name, start, end)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]
    return out, ranges


def _named(ranges, name):
    return sorted((r for r in ranges if r[0] == name), key=lambda r: r[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _flat_step():
    cost, mass, cap = make_problem(1024, 32, seed=3, device="cpu")
    return placement_step(cost, mass, cap, n_iters=10, chunk=256, device="cpu")


def _hier_solve():
    gen = torch.Generator().manual_seed(5)
    obj = torch.randn(8192, 4, generator=gen)
    node = torch.randn(4, 64, generator=gen)
    ones = torch.ones(64)
    return chunked_hierarchical_assign(
        obj, node, ones, ones, n_groups=4, n_chunks=N_CHUNKS, coarse_iters=10, fine_iters=10,
    )


def test_span_without_sink_or_profiler_is_the_shared_null_object():
    tracing.clear_sinks()
    assert not torch.autograd.profiler._is_profiler_enabled
    assert tracing.span("placement.round") is tracing._NULL_SPAN
    assert tracing.span("hier.chunk", chunk=3) is tracing._NULL_SPAN
    with tracing.span("placement.round") as s:
        assert s is None


def test_importing_tracing_leaves_torch_unloaded():
    code = "import sys, json, rio_tpu_torch.tracing; print(json.dumps('torch' in sys.modules))"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) is False


def test_placement_step_stages_nest_in_order_under_the_profiler():
    _, ranges = _profiled(_flat_step)
    (step,) = _named(ranges, "placement.step")
    stages = []
    for name in FLAT_STAGES:
        (r,) = _named(ranges, name)
        assert _inside(r, step), name
        stages.append(r)
    for before, after in zip(stages, stages[1:]):
        assert before[2] <= after[1], (before[0], after[0])


def test_chunked_solve_has_one_chunk_range_per_chunk_each_holding_the_four_stages():
    _, ranges = _profiled(_hier_solve)
    (solve,) = _named(ranges, "hier.solve")
    chunks = _named(ranges, "hier.chunk")
    assert len(chunks) == N_CHUNKS
    for chunk in chunks:
        assert _inside(chunk, solve)
        held = [r for name in HIER_STAGES for r in _named(ranges, name) if _inside(r, chunk)]
        assert [r[0] for r in held] == HIER_STAGES
        assert all(a[2] <= b[1] for a, b in zip(held, held[1:]))
    for name in HIER_STAGES:
        assert len(_named(ranges, name)) == N_CHUNKS, name


def test_device_stage_ms_sums_the_newest_entries():
    name = "test.newest"

    def spans():
        for pause in (0.0, 0.0, 0.0, 0.03, 0.03):
            with tracing.span(name):
                time.sleep(pause)

    _profiled(spans)
    newest = tracing.device_stage_ms(name, 2)
    assert newest >= 60.0
    assert tracing.device_stage_ms(name, 5) - newest < 25.0
    assert tracing.device_stage_ms(name, 0) == 0.0
    with pytest.raises(ValueError):
        tracing.device_stage_ms(name, 6)
    with pytest.raises(ValueError):
        tracing.device_stage_ms("test.never_opened", 1)


def test_the_stage_ring_stays_bounded():
    name = "test.ring"

    def spans():
        for _ in range(tracing.STAGE_RING + 50):
            with tracing.span(name):
                pass

    _profiled(spans)
    assert len(tracing._STAGES[name]) == tracing.STAGE_RING
    assert tracing.device_stage_ms(name, tracing.STAGE_RING) >= 0.0
    with pytest.raises(ValueError):
        tracing.device_stage_ms(name, tracing.STAGE_RING + 1)
    # Nothing is timed while the profiler is off.
    with tracing.span(name):
        pass
    assert len(tracing._STAGES[name]) == tracing.STAGE_RING


@pytest.mark.parametrize("solve", [_flat_step, _hier_solve], ids=["placement_step", "chunked"])
def test_results_are_bit_identical_with_the_profiler_on_and_off(solve):
    off = solve()
    on, _ = _profiled(solve)
    for a, b in zip(off, on):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


def test_sinks_get_spans_as_before_while_the_profiler_records():
    seen = []
    tracing.add_sink(seen.append)
    try:
        def work():
            with tracing.span("placement.round", rows=7) as s:
                assert isinstance(s, tracing.Span)
            return None

        _, ranges = _profiled(work)
    finally:
        tracing.clear_sinks()
    assert [s.name for s in seen] == ["placement.round"]
    assert seen[0].attrs == {"rows": 7} and seen[0].duration > 0.0 and seen[0].span_id
    assert len(_named(ranges, "placement.round")) == 1


def test_the_directory_opens_assign_snapshot_solve_and_apply_spans():
    seen = []

    async def run():
        p = TorchObjectPlacement(node_axis_size=16, mode="sinkhorn", device="cpu")
        for i in range(4):
            p.register_node(f"10.0.0.{i}:5000")
        await p.assign_batch([ObjectId("T", str(i)) for i in range(300)])
        p.register_node("10.0.0.9:5000")
        return await p.rebalance(delta=False)

    tracing.add_sink(seen.append)
    try:
        moved = asyncio.run(run())
    finally:
        tracing.clear_sinks()
    names = [s.name for s in seen]
    assert names == [
        "placement_assign", "placement_snapshot", "placement_solve", "placement_apply",
    ]
    assign = seen[0]
    assert assign.attrs["n"] == 300 and assign.attrs["lock_wait_ms"] >= 0.0
    assert moved > 0 and seen[3].attrs["n"] == 300
