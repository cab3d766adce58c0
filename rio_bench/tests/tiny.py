"""A copy of the benchmark's folder at CPU sizes, and one run of a cell on it.

Each configuration and each cell has a file of its own under ``cpu_sizes/``,
found by its name: ``configs/<config>.json`` changes the configuration's
sizes (its ``config``), ``workloads/<cell>.json`` the cell's traffic and
limits (its ``traffic``); each says in ``why`` what it changes and why. A
cell or configuration without its file is an error, so that none runs at
its full size on the CPU by omission.
"""

import json
import shutil
import time
from pathlib import Path

import torch

from rio_bench import harness

REPO = Path(__file__).resolve().parents[2]


def full_spec(repo: Path = REPO) -> dict:
    """``BENCHMARK.json`` with the entries of the cells it does not hold yet (``pending.json``).

    A pending cell is built and checked but not measured: its host-bound
    numbers spread too widely between runs for its bound. A pending entry
    that names a metric ``BENCHMARK.json`` already has adds its cells to
    that metric's ``workloads``.
    """
    spec = json.loads((repo / "BENCHMARK.json").read_text())
    pending = json.loads((repo / "rio_bench" / "tests" / "pending.json").read_text())
    for key, entries in pending.items():
        known = {entry["name"]: entry for entry in spec[key]}
        for entry in entries:
            if entry["name"] in known:
                known[entry["name"]]["workloads"] += entry["workloads"]
            else:
                spec[key].append(entry)
    return spec


SPEC = full_spec()


def cpu_sizes_file(source: Path, kind: str, name: str) -> Path:
    """The CPU sizes of configuration (``kind`` ``configs``) or cell (``workloads``) ``name``."""
    return Path(source) / "tests" / "cpu_sizes" / kind / f"{name}.json"


def _merge(data: dict, change: dict, where: str) -> None:
    """Set each key of ``change`` in ``data``, into nested dicts; every key must already be there."""
    for key, value in change.items():
        if key not in data:
            raise KeyError(f"{where}: no key {key!r} to change")
        if isinstance(value, dict):
            _merge(data[key], value, f"{where}.{key}")
        else:
            data[key] = value


def _apply(root: Path, source: Path, kind: str, name: str, field: str) -> None:
    sizes = cpu_sizes_file(source, kind, name)
    if not sizes.is_file():
        raise FileNotFoundError(f"no CPU sizes file {sizes} for {name!r}")
    path = root / kind / f"{name}.json"
    data = json.loads(path.read_text())
    target = data if field == "config" else data[field]
    _merge(target, json.loads(sizes.read_text())[field], str(sizes))
    path.write_text(json.dumps(data))


def make_tiny(tmp_path, *, source: Path = REPO / "rio_bench", spec: dict = SPEC):
    """``(registry, spec)`` of the benchmark's folder ``source`` copied at CPU sizes.

    Every configuration and every cell of ``spec`` takes the file of its
    name under ``source/tests/cpu_sizes/``. Each driver's test file
    (``tests/drivers/<driver>.py``) goes along, so that the copy's registry
    finds its own.
    """
    root = Path(tmp_path) / "rio_bench"
    shutil.copytree(source, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copytree(Path(source) / "tests" / "drivers", root / "tests" / "drivers",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for config in spec["configs"]:
        _apply(root, source, "configs", config["name"], "config")
    for cell in spec["workloads"]:
        _apply(root, source, "workloads", cell["name"], "traffic")
    return harness.Registry(root), json.loads(json.dumps(spec))


def run_tiny(tiny, cell, *, seconds=1.5, trace=False, program=None, seed=2**31 + 7):
    registry, spec = tiny
    return harness.run(cell, seed, seconds, trace, spec=spec, registry=registry,
                       device=torch.device("cpu"), t_start=time.perf_counter(), program=program)
