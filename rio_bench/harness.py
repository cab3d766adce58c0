"""One run of one cell: set-up, a measured window, the check, one result line.

Everything that belongs to one configuration, one traffic mix, one driver
or one per-layer metric is a file of its own, found by name:

* ``configs/<config>.json``: the deployment's sizes, its source and cuts;
* ``workloads/<cell>.json``: the cell's config, driver and traffic;
* ``drivers/<driver>.py``: a ``Driver`` class, one closed loop over one
  entry of the program (``rio_tpu_torch``);
* ``metrics/<metric>.py``: a per-layer metric's ``read(traced)``; a metric
  ``<reader>.<qualifier>`` without a file of its own is read by
  ``metrics/<reader>.py``.

``BENCHMARK.json`` says which end-to-end and per-layer metrics each cell
reports, with their units, layers and what each moves. A driver is built with ``(config, traffic, seed, device)``, drives
``program`` (None: the program's own entry), and gives ``setup()``, ``turn(i)`` for each turn of the window, ``paused_s``
(window seconds it spent keeping answers for the check), ``trace_turns``
(the first turn to trace and how many), ``end_to_end(window_s)``,
``counters()``, ``samples()``, ``release()`` and ``check()``, which
returns ``(name, value, limit)`` triples that pass when ``value <= limit``;
after ``setup()`` its ``min_turns`` is the fewest turns the check needs,
which the window runs past its end if need be.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path

import torch

from . import peaks
from .trace import Traced, Tracer, idle_report

ROOT = Path(__file__).resolve().parent
# Top-level module names the run may not hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "rio_tpu")


# A kernel's name in the breakdown is cut to this many characters (the
# demangled template arguments run to thousands).
NAME_CHARS = 160


def _warm_profiler(device: torch.device) -> None:
    """Pay the profiler's first start (CUPTI's set-up takes seconds) before the window."""
    warm = Tracer()
    warm.start()
    torch.ones(8, device=device).sum().item()
    warm.stop()


def forbidden_modules() -> list[str]:
    """Forbidden top-level names in ``sys.modules``, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _load(path: Path, kind: str):
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    modname = f"rio_bench_{kind}_" + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(modname, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Registry:
    """Configs, cells, drivers and metrics under ``root``, each found by its name."""

    def __init__(self, root: Path = ROOT) -> None:
        self.root = Path(root)

    def _json(self, folder: str, name: str) -> dict:
        path = self.root / folder / f"{name}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no {folder} file {path}")
        return json.loads(path.read_text())

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def workload(self, name: str) -> dict:
        return self._json("workloads", name)

    def driver(self, name: str):
        return _load(self.root / "drivers" / f"{name}.py", "driver")

    def driver_tests(self, name: str):
        """What the benchmark's tests know of driver ``name``: its controls, faults and stages; no run reads it."""
        return _load(self.root / "tests" / "drivers" / f"{name}.py", "driver_tests")

    def metric(self, name: str):
        path = self.root / "metrics" / f"{name}.py"
        if not path.is_file() and "." in name:
            path = path.with_name(name.split(".")[0] + ".py")
        return _load(path, "metric")


def cell_metrics(spec: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """The end-to-end and per-layer metrics that ``cell`` reports."""

    def applies(metric: dict) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    return (
        [m for m in spec["end_to_end"] if applies(m)],
        [m for m in spec["per_layer"] if applies(m)],
    )


def _device_fields(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type, "count": chips, "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": chips,
        "memory_peak_bytes": int(peak),
    }


def run(cell: str, seed: int, seconds: float, trace: bool, *, spec: dict, registry: Registry,
        device: torch.device, t_start: float, program=None, log=sys.stderr) -> dict:
    """One run of ``cell``; returns the result line as a dict (``checks`` last).

    ``program`` puts something else in the place of the entry the driver
    drives (the control, or a program broken on purpose in the tests).
    """
    entry = next((w for w in spec["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload {cell!r} in the benchmark")
    cfg = registry.workload(cell)
    if cfg["config"] != entry["config"]:
        raise ValueError(f"{cell}: config {cfg['config']!r} against {entry['config']!r}")
    end_to_end, per_layer = cell_metrics(spec, cell)
    readers = {m["name"]: registry.metric(m["name"]) for m in per_layer} if trace else {}
    driver = registry.driver(cfg["driver"]).Driver(
        registry.config(cfg["config"]), cfg["traffic"], seed, device
    )
    if program is not None:
        driver.program = program

    driver.setup()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    # A traced run profiles turns [first, first + count), past the window's
    # end if need be; starting and stopping the profiler is left out of it.
    first, count = driver.trace_turns
    tracer, traced_turns, tracer_s = None, 0, 0.0
    if trace:
        tracer = Tracer()
        _warm_profiler(device)
    attempted = failed = 0
    start = time.perf_counter()
    while True:
        if tracer is not None and attempted == first:
            t0 = time.perf_counter()
            tracer.start()
            tracer_s += time.perf_counter() - t0
        try:
            driver.turn(attempted)
        except Exception:  # noqa: BLE001 - a failed turn is counted and ends the window
            failed += 1
            traceback.print_exc(file=log)
        attempted += 1
        if tracer is not None and tracer.window is None and attempted > first and (
            attempted == first + count or failed
        ):
            t0 = time.perf_counter()
            tracer.stop()
            tracer_s += time.perf_counter() - t0
            traced_turns = attempted - first
        window_s = time.perf_counter() - start - driver.paused_s - tracer_s
        if failed or (
            window_s >= seconds and attempted >= driver.min_turns
            and (tracer is None or tracer.window is not None)
        ):
            break

    metrics: dict = {}
    if not trace:
        values = {"setup_s": setup_s, **driver.end_to_end(window_s)}
        for m in end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev_fields = _device_fields(device, entry["chips"])
    breakdown = None
    if trace:
        if tracer.window is None:
            raise RuntimeError("the run failed before its traced turns")
        traced = Traced(tracer.device, tracer.host, tracer.window, traced_turns, driver.counters())
        for m in per_layer:
            value = readers[m["name"]].read(traced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if device.type == "cuda":  # a CPU run traces no device, so it has no breakdown
            report = idle_report(tracer.device, tracer.host, tracer.window)
            dev_fields["busy_s"] = report["busy_us"] / 1e6
            dev_fields["window_s"] = report["window_us"] / 1e6
            breakdown = {
                "device_ops": [[n[:NAME_CHARS], us / 1e6] for n, us in report["top_ops"]],
                "idle_gaps": [[n, us / 1e6] for n, us in report["gaps"]],
            }
    print("# samples " + json.dumps(driver.samples()), flush=True)

    driver.release()  # drops the program's state and outputs the check may not read
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = driver.check()
    correct = failed == 0 and attempted > 0 and all(v <= lim for _, v, lim in checks)
    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": dev_fields,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result


def main(argv: list[str], t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python3 -m rio_bench", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = json.loads(Path("BENCHMARK.json").read_text())
    entry = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {entry['chips']} CUDA device(s), found {have}", file=sys.stderr)
        return 2
    print(f"# card: {peaks.power_limit()}", file=sys.stderr, flush=True)
    result = run(
        args.workload, args.seed, args.seconds, bool(args.trace), spec=spec,
        registry=Registry(), device=torch.device("cuda"), t_start=t_start,
    )
    found = forbidden_modules()
    if found:
        print(f"the run loaded forbidden modules: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
