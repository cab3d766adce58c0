"""The port's runtime harnesses give the reference's outcomes on the same arguments.

Each of the ten ``utils/*_live.py`` harnesses that ``bench.py``'s runtime
tiers run, and ``python -m rio_tpu_torch.autoscale --demo``, runs once on
the port and once on the reference at the same small sizes. Rates differ
run to run and are not compared; what each harness asserts or counts is:
the result's keys, the migration drain's moved, bursts and prefetch hits,
the hot-key stream's staleness violations, the streams' deliveries and
partitions, the QoS flood's interactive sheds, the journal's recorded
control events by kind (HEALTH left out), the fault ladder's armed lookups
and the span ring's retention. The autoscale ramp's contract (no lost write,
a scale-out, a scale-in and a retire in that order) is held on each
package's result: when its waits end follows the host's load.
"""

import asyncio
import collections
import importlib
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
# The echo A/B harnesses at a few batches of 8 senders.
ECHO = {"batches": 2, "n_workers": 8, "requests_per_batch": 16, "n_objects": 32}


def _harness(pkg: str, module: str):
    return importlib.import_module(f"{pkg}.utils.{module}")


def _chain_order(chain: list[str]) -> list[str]:
    """The first scale_out, scale_in and retired of a journal chain, in order."""
    firsts: list[str] = []
    for entry in chain:
        action = entry.split(":", 1)[0]
        if action in ("scale_out", "scale_in", "retired") and action not in firsts:
            firsts.append(action)
    return firsts


def _migration(pkg):
    out = asyncio.run(_harness(pkg, "migration_live").measure_migration_drain(
        n_objects=64, payload_bytes=256))
    return out, {
        mode: (out[mode]["moved"], out[mode]["bursts"], out[mode]["prefetch_hits"])
        for mode in ("per_key", "batched")
    }


def _hotkey(pkg):
    out = asyncio.run(_harness(pkg, "hotkey_live").measure_hotkey(
        n_keys=12, n_requests=120, rate=600.0))
    return out, {
        mode: (out[mode]["requests"], out[mode]["hot_reads"], out[mode]["hot_writes"],
               out[mode]["staleness_violations"])
        for mode in ("baseline", "replica_reads")
    }


def _tracing(pkg):
    out = asyncio.run(_harness(pkg, "tracing_live").measure_tracing_overhead(**ECHO))
    return out, (sorted(out["msgs_per_sec"]), out["n_requests_per_batch"], out["batches"])


def _journal(pkg):
    # The outcome is what the package decides: the kinds of control events
    # its echo loop records, tallied through Journal.record. HEALTH events
    # (loop_stall, loop_lag_rising) follow the test process's heap and the
    # loop's timing, not the package, so they are left out of the outcome;
    # the raw count stays in the result as events_recorded_on.
    journal = importlib.import_module(f"{pkg}.journal")
    kinds: collections.Counter = collections.Counter()
    record = journal.Journal.record

    def tally(self, kind, *args, **kwargs):
        kinds[kind] += 1
        return record(self, kind, *args, **kwargs)

    journal.Journal.record = tally
    try:
        out = asyncio.run(_harness(pkg, "journal_live").measure_journal_overhead(**ECHO))
    finally:
        journal.Journal.record = record
    decided = {k: v for k, v in kinds.items() if k != journal.HEALTH}
    return out, (decided, out["n_requests_per_batch"])


def _series(pkg):
    out = asyncio.run(_harness(pkg, "series_live").measure_series_overhead(**ECHO))
    # Alerts fired depend on the run's timing; that the ring sampled does not.
    return out, (out["samples_on"] > 0, out["sample_interval_s"])


def _spans(pkg):
    # A 10 us tail SLO: every request of this small run is slower, so the
    # ring retains what it tail-captures.
    out = asyncio.run(_harness(pkg, "spans_live").measure_spans_overhead(**ECHO, slo_ms=0.01))
    return out, (out["retained_on"] > 0, out["retained_on"] == out["tail_captured_on"])


def _faults(pkg):
    out = asyncio.run(_harness(pkg, "faults_live").measure_faults_overhead(
        **ECHO, lookup_ops=2000))
    return out, (sorted(out["lookup_ops_per_sec"]), out["lookup_ops_per_sec"]["armed_idle"] > 0)


def _streams(pkg):
    out = asyncio.run(_harness(pkg, "streams_live").measure_streams_overhead(
        batches=2, publishes_per_batch=24, n_keys=4))
    return out, (out["delivered"], out["partitions_active"])


def _qos(pkg):
    # measure_qos's two halves at small sizes (the bench tests run measure_qos itself).
    live = _harness(pkg, "qos_live")
    out = {"uniform": asyncio.run(live.measure_qos_overhead(**{**ECHO, "batches": 4})),
           "flood": asyncio.run(live.measure_qos_flood(bulk_workers=16, interactive_probes=16))}
    flood = out["flood"]
    return out, (flood["interactive_sheds_on"], flood["bulk_workers"], flood["max_concurrent_on"],
                 sorted(out["uniform"]))


def _autoscale(pkg):
    live = _harness(pkg, "autoscale_live")
    idle = asyncio.run(live.measure_autoscale_idle_overhead(
        batches=4, n_workers=8, requests_per_batch=64, n_objects=32))
    # The ramp scales out once its one node serves over 600 requests/s. On a
    # loaded host this process may not reach that rate for minutes, so the wait
    # for it is 300 s here, not the harness's 90; the warm-up (every key served)
    # keeps the harness's 3 s.
    ramp = asyncio.run(live.measure_autoscale_ramp(warm_secs=3.0, high_timeout=300.0))
    # The contract each package guarantees, held on its own result. The chain's
    # other entries (whether the drain request went through before the SIGKILL)
    # follow the clock, and killed_mid_drain is set whenever the ramp returns (it
    # raises otherwise): both stay in the result and are not compared.
    assert ramp["lost"] == 0 and ramp["duplicates"] >= 0, (pkg, ramp)
    assert _chain_order(ramp["chain"]) == ["scale_out", "scale_in", "retired"], (pkg, ramp["chain"])
    out = {"idle": idle, "ramp": ramp}
    return out, (idle["controller_ticks_on"] > 0, ramp["lost"], _chain_order(ramp["chain"]))


HARNESSES = {
    "migration_live": _migration,
    "hotkey_live": _hotkey,
    "tracing_live": _tracing,
    "journal_live": _journal,
    "series_live": _series,
    "spans_live": _spans,
    "faults_live": _faults,
    "streams_live": _streams,
    "qos_live": _qos,
    "autoscale_live": _autoscale,
}


def _keys(tree):
    """The nested key set of a result (dict keys, not values)."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items() if not isinstance(k, str) or ":" not in k}
    return None


@pytest.mark.parametrize("name", list(HARNESSES))
def test_the_port_harness_gives_the_references_outcome(name):
    ref, ref_outcome = HARNESSES[name]("rio_tpu")
    port, port_outcome = HARNESSES[name]("rio_tpu_torch")
    assert _keys(port) == _keys(ref)
    assert port_outcome == ref_outcome


def _demo(pkg: str) -> dict:
    out = subprocess.run(
        [sys.executable, "-m", f"{pkg}.autoscale", "--demo"],
        cwd=ROOT, capture_output=True, text=True, timeout=170,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "OK"
    return json.loads(lines[-2])


def test_the_autoscale_demo_gives_the_references_outcome():
    ref, port = _demo("rio_tpu"), _demo("rio_tpu_torch")
    assert set(port) == set(ref)
    counts = ("scale_outs", "scale_ins", "final_nodes")
    assert [port[k] for k in counts] == [ref[k] for k in counts] == [1, 1, 1]
    assert [e for e in port["chain"] if e.startswith("scale:")] == \
        [e for e in ref["chain"] if e.startswith("scale:")]


def test_ramp_trace_times_the_ramps_decisions():
    from rio_tpu_torch.utils import ramp_trace

    (out,) = ramp_trace.main(["--idle", json.dumps({**ECHO, "batches": 1}),
                              "--ramp", json.dumps({"high_timeout": 300.0})])
    assert "error" not in out, out["error"]
    ramp = out["result"]["ramp"]
    assert ramp["lost"] == 0
    actions = [action for action, _ in out["marks"]]
    assert actions[:2] == ["provision", "scale_out"], out["marks"]
    assert _chain_order(actions) == ["scale_out", "scale_in", "retired"], out["marks"]
    assert [a for a in actions if a != "provision"] == [e.split(":", 1)[0] for e in ramp["chain"]]
    seconds = [t for _, t in out["marks"]]
    assert seconds == sorted(seconds) and seconds[0] > 0
    assert out["launches"] == {"fused_scaling_iteration": 0, "fused_iteration": 0, "cdf_round": 0,
                               "kbuild": 0, "coarse_scores": 0, "potential_round": 0,
                               "logdomain_post": 0, "logdomain_post_finalize": 0}
