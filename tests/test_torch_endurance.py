"""rio_tpu_torch.tools.endurance against tools/endurance.py, for seconds, on the CPU.

Both tools run side by side with the same flags: 3 servers, 8 client
workers over 2,000 counters, a cordon -> re-solve -> uncordon cycle every
second and a sample every second for 12 seconds, ``--route-small`` (every
flat re-solve through ``sinkhorn+hier_at_scale``); once on the plain
provider and once with ``--persistent`` on a fresh SQLite file. Both must
report ``ok``, 0 errors, RSS read, and with ``--persistent`` the backing
equal to the directory (``backing_convergence`` "exact").

The port must finish a churn cycle, with the routed mode in its samples.
The reference's first re-solve compiles its JAX programs, which on a
loaded host can outlast the run (a 6-worker test run saw it finish none
in 6 s), so its cycles are held to the same rule only where it finished
one. The final mode's solver is compared, not its suffix: which churn
step the run's clock ends on (a re-solve after a pure departure may take
the delta path) follows each package's speed.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
FLAGS = ["--minutes", "0.2", "--churn-every", "1", "--sample-every", "1", "--route-small", "--cordon"]
RUN_TIMEOUT_S = 150  # the tool's own limit is its minutes plus 120 s
ENV = {**os.environ, "JAX_PLATFORMS": "cpu"}


def _commands(extra: dict) -> dict:
    return {
        "rio_tpu": [sys.executable, str(ROOT / "tools" / "endurance.py"), *FLAGS, *extra["rio_tpu"]],
        "rio_tpu_torch": [sys.executable, "-m", "rio_tpu_torch.tools.endurance", *FLAGS,
                          "--device", "cpu", *extra["rio_tpu_torch"]],
    }


def _run_both(extra: dict) -> dict:
    procs = {pkg: subprocess.Popen(cmd, cwd=ROOT, env=ENV, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
             for pkg, cmd in _commands(extra).items()}
    out = {}
    try:
        for pkg, p in procs.items():
            stdout, stderr = p.communicate(timeout=RUN_TIMEOUT_S)
            assert p.returncode == 0, f"{pkg}: {stderr[-2000:]}"
            lines = [json.loads(ln) for ln in stdout.strip().splitlines() if ln.startswith("{")]
            out[pkg] = (lines[:-1], lines[-1])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


@pytest.mark.parametrize("persistent", [False, True], ids=["plain", "persistent"])
def test_the_port_tool_ends_as_the_references_does(persistent, tmp_path):
    extra = {pkg: ["--persistent", str(tmp_path / f"{pkg}.db")] if persistent else []
             for pkg in ("rio_tpu", "rio_tpu_torch")}
    runs = _run_both(extra)
    summaries = {}
    for pkg, (samples, summary) in runs.items():
        assert set(summary) == {"ok", "minutes", "requests", "errors", "churn_cycles", "rss_warm_mb",
                                "rss_final_mb", "route_small", "mode_final", "backing_convergence"}
        assert summary["ok"] is True and summary["errors"] == 0, (pkg, summary)
        assert summary["requests"] > 0, (pkg, summary)
        assert summary["rss_warm_mb"] > 0 and summary["rss_final_mb"] >= summary["rss_warm_mb"]
        assert summary["route_small"] is True
        assert all(s["directory"] <= 2000 and s["errors"] == 0 for s in samples)
        if pkg == "rio_tpu_torch" or summary["churn_cycles"]:
            assert summary["churn_cycles"] >= 1, (pkg, summary)
            assert any(s["solve_mode"] == "sinkhorn+hier_at_scale" for s in samples), (pkg, samples)
            assert summary["mode_final"].split("+")[0] == "sinkhorn", (pkg, summary)
        if persistent:
            assert all("dirty" in s for s in samples)
        summaries[pkg] = summary
    ref, port = summaries["rio_tpu"], summaries["rio_tpu_torch"]
    assert port["backing_convergence"] == ref["backing_convergence"] == ("exact" if persistent else None)
