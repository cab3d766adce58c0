"""The harness finds every configuration, cell, driver and metric by its name."""

import json

import pytest

from rio_bench import harness

from .tiny import REPO, SPEC, run_tiny



@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_are_found_by_name(cell):
    registry = harness.Registry()
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    workload = registry.workload(cell)
    assert workload["config"] == entry["config"]
    assert registry.config(workload["config"])["name"] == entry["config"]
    assert hasattr(registry.driver(workload["driver"]), "Driver")


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_is_found_by_name(metric):
    assert callable(harness.Registry().metric(metric["name"]).read)


def test_a_qualified_metric_without_a_file_takes_its_readers(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "idle.py").write_text("def read(t):\n    return 1.0\n")
    (tmp_path / "metrics" / "idle.own.py").write_text("def read(t):\n    return 2.0\n")
    registry = harness.Registry(tmp_path)
    assert registry.metric("idle.any").read(None) == 1.0
    assert registry.metric("idle.own").read(None) == 2.0
    with pytest.raises(FileNotFoundError):
        registry.metric("other.any")


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_matches_its_entry(config):
    data = json.loads((REPO / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert all(key in data for key in config["reduced"])


def test_missing_names_raise():
    registry = harness.Registry()
    for find in (registry.config, registry.workload, registry.driver, registry.metric):
        with pytest.raises(FileNotFoundError):
            find("no-such-name")


def test_a_new_cell_is_one_json_file(tiny):
    registry, spec = tiny
    cell = "flat-1m-1k.place-pool1"
    workload = json.loads((registry.root / "workloads" / "flat-1m-1k.place.json").read_text())
    workload["traffic"]["pool"] = 1
    (registry.root / "workloads" / f"{cell}.json").write_text(json.dumps(workload))
    spec = json.loads(json.dumps(spec))
    spec["workloads"].append({
        "name": cell, "config": "flat-1m-1k", "traffic": "place-pool1", "chips": 1, "why": "test",
    })
    next(m for m in spec["end_to_end"] if m["name"] == "placements_per_s")["workloads"].append(cell)
    res = run_tiny((registry, spec), cell, seconds=0.5)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"setup_s", "placements_per_s"}
