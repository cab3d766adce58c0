"""The port's runtime harnesses give the reference's outcomes on the same arguments.

Each of the ten ``utils/*_live.py`` harnesses that ``bench.py``'s runtime
tiers run, and ``python -m rio_tpu_torch.autoscale --demo``, runs once on
the port and once on the reference at the same small sizes. Rates differ
run to run and are not compared; what each harness asserts or counts is:
the result's keys, the migration drain's moved, bursts and prefetch hits,
the hot-key stream's staleness violations, the streams' deliveries and
partitions, the QoS flood's interactive sheds, the journal's recorded
control events by kind (HEALTH left out), the autoscale ramp's lost writes and its journal chain, the fault
ladder's armed lookups and the span ring's retention.
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
    ramp = asyncio.run(live.measure_autoscale_ramp(warm_secs=1.0))
    out = {"idle": idle, "ramp": ramp}
    return out, (idle["controller_ticks_on"] > 0, ramp["lost"], ramp["duplicates"] >= 0,
                 ramp["scale_outs"] >= 1, ramp["scale_ins"] >= 1,
                 bool(ramp["killed_mid_drain"]), _chain_order(ramp["chain"]))


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
