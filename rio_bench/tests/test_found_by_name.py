"""The harness finds every configuration, cell, driver and metric by its name."""

import hashlib
import json
import shutil

import pytest

from rio_bench import harness

from .test_controls import broken_program, controls_for
from .test_stages import check_stages, stage_path
from .tiny import REPO, SPEC, full_spec, make_tiny, run_tiny


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


@pytest.mark.parametrize("kind", ["configs", "workloads"])
def test_a_name_without_its_cpu_sizes_file_is_refused(tmp_path, kind):
    spec = json.loads(json.dumps(SPEC))
    if kind == "configs":
        spec["configs"].append({"name": "no-such-config"})
    else:
        spec["workloads"].append({"name": "no-such-cell", "config": "flat-1m-1k"})
    missing = "no-such-config.json" if kind == "configs" else "no-such-cell.json"
    with pytest.raises(FileNotFoundError, match=missing):
        make_tiny(tmp_path, spec=spec)


NEW_CONFIG, NEW_CELL = "flat-1m-512", "flat-1m-512.place"


@pytest.fixture
def new_configuration(tmp_path):
    """``(registry, spec)`` at CPU sizes of a copy of the benchmark with a configuration and cell added as files.

    ``flat-1m-1k`` at another node count, its cell, their two CPU sizes
    files and their entries in ``BENCHMARK.json``; no test file is edited.
    """
    repo = tmp_path / "repo"
    bench = repo / "rio_bench"
    shutil.copytree(REPO / "rio_bench", bench, ignore=shutil.ignore_patterns("__pycache__"))
    config = json.loads((bench / "configs" / "flat-1m-1k.json").read_text())
    config.update(name=NEW_CONFIG, nodes=512)
    (bench / "configs" / f"{NEW_CONFIG}.json").write_text(json.dumps(config))
    workload = json.loads((bench / "workloads" / "flat-1m-1k.place.json").read_text())
    workload["config"] = NEW_CONFIG
    (bench / "workloads" / f"{NEW_CELL}.json").write_text(json.dumps(workload))
    sizes = bench / "tests" / "cpu_sizes"
    (sizes / "configs" / f"{NEW_CONFIG}.json").write_text(json.dumps(
        {"why": "test", "config": {"objects": 2048, "nodes": 16, "solve": {"round_chunk_rows": 512}}}
    ))
    (sizes / "workloads" / f"{NEW_CELL}.json").write_text(json.dumps(
        {"why": "test", "traffic": {"limits": {"seat_mismatch": 0.05, "cost_gap": 0.05}}}
    ))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": NEW_CONFIG, "source": config["source"],
                            "file": f"rio_bench/configs/{NEW_CONFIG}.json", "reduced": [], "why": "test"})
    spec["workloads"].append(
        {"name": NEW_CELL, "config": NEW_CONFIG, "traffic": "place-pool4", "chips": 1, "why": "test"}
    )
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "flat-1m-1k.place" in m.get("workloads", ()):
            m["workloads"].append(NEW_CELL)
    (repo / "BENCHMARK.json").write_text(json.dumps(spec))
    return make_tiny(tmp_path / "tiny", source=bench, spec=full_spec(repo))


def test_a_new_configuration_takes_its_cpu_sizes_and_runs_correct(new_configuration):
    registry = new_configuration[0]
    config = registry.config(NEW_CONFIG)
    assert (config["objects"], config["nodes"], config["solve"]["round_chunk_rows"]) == (2048, 16, 512)
    res = run_tiny(new_configuration, NEW_CELL, seconds=0.5)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"setup_s", "placements_per_s"}


def test_a_new_configuration_reports_the_stages_of_its_driver(new_configuration):
    check_stages(new_configuration, NEW_CELL)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_new_configuration_takes_the_faults_of_its_driver(new_configuration, fault):
    program = broken_program(new_configuration[0], NEW_CELL, fault)
    res = run_tiny(new_configuration, NEW_CELL, seconds=0.5, program=program)
    assert not res["correct"], res["checks"]


NEW_DRIVER, NEW_DRIVER_CELL = "place_flat_copy", "flat-1m-1k.flat-copy"


def _hashes(folder) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def new_driver(tmp_path):
    """``(registry, spec)`` at CPU sizes of a copy of the benchmark with a driver and its cell added as files.

    ``place_flat.py`` copied under a new name, its test file, one cell of
    it, the cell's CPU sizes file and its entries in ``BENCHMARK.json``;
    no file that the copy's benchmark folder already had is edited.
    """
    repo = tmp_path / "repo"
    bench = repo / "rio_bench"
    shutil.copytree(REPO / "rio_bench", bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = _hashes(bench)
    shutil.copy(bench / "drivers" / "place_flat.py", bench / "drivers" / f"{NEW_DRIVER}.py")
    shutil.copy(bench / "tests" / "drivers" / "place_flat.py", bench / "tests" / "drivers" / f"{NEW_DRIVER}.py")
    workload = json.loads((bench / "workloads" / "flat-1m-1k.place.json").read_text())
    workload["driver"] = NEW_DRIVER
    (bench / "workloads" / f"{NEW_DRIVER_CELL}.json").write_text(json.dumps(workload))
    sizes = bench / "tests" / "cpu_sizes" / "workloads"
    shutil.copy(sizes / "flat-1m-1k.place.json", sizes / f"{NEW_DRIVER_CELL}.json")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["workloads"].append(
        {"name": NEW_DRIVER_CELL, "config": "flat-1m-1k", "traffic": "flat-copy", "chips": 1, "why": "test"}
    )
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "flat-1m-1k.place" in m.get("workloads", ()):
            m["workloads"].append(NEW_DRIVER_CELL)
    (repo / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _hashes(bench)
    assert {name: after[name] for name in before} == before
    assert set(after) - set(before) == {
        f"drivers/{NEW_DRIVER}.py", f"tests/drivers/{NEW_DRIVER}.py",
        f"workloads/{NEW_DRIVER_CELL}.json", f"tests/cpu_sizes/workloads/{NEW_DRIVER_CELL}.json",
    }
    return make_tiny(tmp_path / "tiny", source=bench, spec=full_spec(repo))


def test_a_new_driver_runs_correct(new_driver):
    registry = new_driver[0]
    assert registry.workload(NEW_DRIVER_CELL)["driver"] == NEW_DRIVER
    assert hasattr(registry.driver(NEW_DRIVER), "Driver")
    res = run_tiny(new_driver, NEW_DRIVER_CELL, seconds=0.5)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"setup_s", "placements_per_s"}


def test_a_new_driver_takes_its_own_control(new_driver):
    controls = controls_for(new_driver[0], NEW_DRIVER_CELL)
    assert set(controls) == {"fp8"}
    res = run_tiny(new_driver, NEW_DRIVER_CELL, seconds=0.5, program=controls["fp8"])
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_new_driver_takes_its_own_faults(new_driver, fault):
    program = broken_program(new_driver[0], NEW_DRIVER_CELL, fault)
    res = run_tiny(new_driver, NEW_DRIVER_CELL, seconds=0.5, program=program)
    assert not res["correct"], res["checks"]


def test_a_new_driver_reports_its_stages(new_driver):
    check_stages(new_driver, NEW_DRIVER_CELL)


LOOKUPS = {
    "controls": controls_for,
    "faults": lambda registry, cell: broken_program(registry, cell, "half"),
    "stages": stage_path,
}


@pytest.mark.parametrize("lookup", LOOKUPS)
def test_a_driver_without_its_test_file_is_refused(tiny, lookup):
    registry = tiny[0]
    shutil.copy(registry.root / "drivers" / "place_flat.py", registry.root / "drivers" / "place_bare.py")
    workload = json.loads((registry.root / "workloads" / "flat-1m-1k.place.json").read_text())
    workload["driver"] = "place_bare"
    (registry.root / "workloads" / "flat-1m-1k.bare.json").write_text(json.dumps(workload))
    with pytest.raises(FileNotFoundError, match="tests/drivers/place_bare.py"):
        LOOKUPS[lookup](registry, "flat-1m-1k.bare")
