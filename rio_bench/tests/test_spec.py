"""``BENCHMARK.json`` keeps to the benchmark's contract: keys, names, units, bounds."""

import json
import re

import pytest

from . import tiny
from .tiny import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys():
    assert set(SPEC) == KEYS["top"]
    for kind, items in (("config", SPEC["configs"]), ("workload", SPEC["workloads"])):
        assert all(set(item) == KEYS[kind] for item in items), kind
    for kind in ("end_to_end", "per_layer"):
        assert all(set(m) - {"workloads"} == KEYS[kind] for m in SPEC[kind]), kind


def test_names_and_units():
    names = [x["name"] for kind in ("configs", "workloads", "end_to_end", "per_layer") for x in SPEC[kind]]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in SPEC["workloads"]] + [w["config"] for w in SPEC["workloads"]]:
        assert NAME.match(name), name
    for c in SPEC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_lines_and_paths():
    assert SPEC["paths"] == ["rio_bench"]
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/") for p in SPEC["paths"])
    assert 1 <= len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    for c in SPEC["configs"]:
        assert c["file"].startswith("rio_bench/") and _line(c["source"]) and _line(c["why"])
        assert c["source"].startswith("https://")
    assert len({c["file"] for c in SPEC["configs"]}) == len(SPEC["configs"])
    assert all(_line(w["why"]) for w in SPEC["workloads"])
    assert all(_line(m["layer"]) for m in SPEC["per_layer"])
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_cells_and_bounds():
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    cells = {w["name"]: w for w in SPEC["workloads"]}
    assert 1 <= len(cells) <= 24 and all(w["chips"] in (1, 4) for w in cells.values())
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    assert {w["config"] for w in cells.values()} == {c["name"] for c in SPEC["configs"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
    _each_cell_reports(SPEC)


def _each_cell_reports(spec: dict) -> None:
    """Every cell reports ``setup_s``, another end-to-end metric and a per-layer one that moves it."""
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for cell in cells:
        reported = [m for m in e2e.values() if cell in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2, cell
        layer = [m for m in spec["per_layer"] if cell in m.get("workloads", cells)]
        assert layer, cell
        for m in layer:  # the metric it moves is reported in every cell it lists
            assert cell in e2e[m["moves"]].get("workloads", cells), (m["name"], cell)


def test_pending_cells_report_as_a_cell_of_the_benchmark_does():
    """``pending.json``'s cells, merged into ``BENCHMARK.json``: each entry named once, each cell's metrics whole."""
    spec = tiny.SPEC
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in spec[kind]]
        assert len(names) == len(set(names)), kind
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert {"unit", "better", "source"} <= set(m), m["name"]
    assert {w["config"] for w in spec["workloads"]} == {c["name"] for c in spec["configs"]}
    _each_cell_reports(spec)


@pytest.mark.parametrize(
    ("kind", "name"),
    [("configs", c["name"]) for c in tiny.SPEC["configs"]]
    + [("workloads", w["name"]) for w in tiny.SPEC["workloads"]],
)
def test_every_config_and_cell_has_its_cpu_sizes_file(kind, name):
    """Each configuration and cell of ``BENCHMARK.json`` and ``pending.json`` has its CPU sizes."""
    path = tiny.cpu_sizes_file(REPO / "rio_bench", kind, name)
    assert path.is_file(), f"no CPU sizes file {path}"
    sizes = json.loads(path.read_text())
    field = "config" if kind == "configs" else "traffic"
    assert set(sizes) == {"why", field} and sizes["why"].strip(), path
