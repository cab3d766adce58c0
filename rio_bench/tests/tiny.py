"""A copy of the benchmark's folder at CPU sizes, and one run of a cell on it."""

import json
import shutil
import time
from pathlib import Path

import torch

from rio_bench import harness

REPO = Path(__file__).resolve().parents[2]


def _full_spec() -> dict:
    """``BENCHMARK.json`` with the entries of the cells it does not hold yet (``pending.json``).

    A pending cell is built and checked but not measured: the churn cell,
    whose host-bound numbers spread too widely between runs for a bound.
    """
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    pending = json.loads((Path(__file__).with_name("pending.json")).read_text())
    for key, entries in pending.items():
        spec[key] = spec[key] + entries
    return spec


SPEC = _full_spec()
TINY = {
    "flat-1m-1k": {"objects": 4096, "nodes": 64, "solve": {"round_chunk_rows": 1024}},
    "hier-10m-1k": {"objects": 65536, "nodes": 64, "solve": {"groups": 4, "chunk_rows": 16384}},
}
# The CPU runs the eager scaling loop (u and v cast to bfloat16 before each
# product) where the card runs the kernel (float32 vectors): looser limits.
# At 4,096 objects over 64 nodes the collapsed full solve's rounding moves
# 1-2% of the objects beyond the forced (none at 1,048,576 over 1,024).
TINY_LIMITS = {
    "flat-1m-1k.place": {"seat_mismatch": 0.05, "cost_gap": 0.05},
    "hier-10m-1k.place": {"seat_mismatch": 0.05, "group_mismatch": 0.05, "score_gap": 0.05},
    "flat-1m-1k.churn": {"full_excess_moves": 0.1},
}
TINY_TRAFFIC = {"flat-1m-1k.churn": {"alloc_batch": 64}}


def _update(path: Path, change: dict) -> None:
    data = json.loads(path.read_text())
    for key, value in change.items():
        if isinstance(value, dict):
            data[key].update(value)
        else:
            data[key] = value
    path.write_text(json.dumps(data))


def make_tiny(tmp_path):
    """``(registry, spec)`` of the benchmark's folder copied at CPU sizes."""
    root = tmp_path / "rio_bench"
    shutil.copytree(REPO / "rio_bench", root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, change in TINY.items():
        _update(root / "configs" / f"{name}.json", change)
    for cell in {*TINY_LIMITS, *TINY_TRAFFIC}:
        path = root / "workloads" / f"{cell}.json"
        data = json.loads(path.read_text())
        data["traffic"]["limits"].update(TINY_LIMITS.get(cell, {}))
        data["traffic"].update(TINY_TRAFFIC.get(cell, {}))
        path.write_text(json.dumps(data))
    return harness.Registry(root), json.loads(json.dumps(SPEC))


def run_tiny(tiny, cell, *, seconds=1.5, trace=False, program=None, seed=2**31 + 7):
    registry, spec = tiny
    return harness.run(cell, seed, seconds, trace, spec=spec, registry=registry,
                       device=torch.device("cpu"), t_start=time.perf_counter(), program=program)
