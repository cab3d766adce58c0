"""The affinity feedback loop on the port: ``rio_tpu_torch.utils.affinity_live``.

``measure_affinity_payoff`` boots two live servers of the port's runtime
on ``TorchObjectPlacement(device="cpu")``, runs multi-hop stream traffic
seated adversarially, feeds the scraped edge graph back and runs it again.
It meets the harness's own bar, and the reference harness on
``JaxObjectPlacement`` with the same inputs decides the same partitions,
co-locations, moves and installed edges. ``rio_tpu_torch.bench``'s
``affinity_payoff`` returns the reference's keys (both run here at a small
size, their harness functions cut down alike).

For the comparison both providers run with ``sync_load`` pinned off. The
two servers share one event loop, and on a loaded host its lag enters each
node's load vector (ROADMAP C.6); a derate that lands during the
reference's first solve (6-9 s of JAX compilation under load, 60-90 ms for
the port) moves the provider's epoch and the solve is discarded, so the
comparison would read the host's load rather than the two decisions.
"""

import asyncio
import functools

import pytest

pytest.importorskip("torch")

import rio_tpu.utils.affinity_live as ref_live  # noqa: E402
import rio_tpu_torch.utils.affinity_live as port_live  # noqa: E402

N_RECORDS = 64
LIMIT_S = 120.0
DECISIONS = ("partitions", "pairs_colocated", "moves", "edges_installed", "n_records", "delivered")


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=LIMIT_S))


@pytest.fixture(scope="module")
def port_payoff():
    return _run(port_live.measure_affinity_payoff(n_records=N_RECORDS, device="cpu"))


def test_the_ports_payoff_meets_the_harness_bar(port_payoff):
    out = port_payoff
    assert "+affinity" in str(out["solved_as"]), out
    assert out["pairs_colocated"] == out["partitions"], out
    assert out["bytes_ratio"] >= 2.0, out
    assert out["delivery_wire_spans"]["affinity"] < out["delivery_wire_spans"]["blind"], out
    assert out["delivered"] > 0


def _steady(cls):
    """``cls`` with ``sync_load`` a no-op: capacities stay at the nodes' own."""
    return type(f"Steady{cls.__name__}", (cls,), {"sync_load": lambda self, view: None})


def test_the_reference_harness_decides_the_same(monkeypatch):
    monkeypatch.setattr(ref_live, "JaxObjectPlacement", _steady(ref_live.JaxObjectPlacement))
    monkeypatch.setattr(port_live, "TorchObjectPlacement", _steady(port_live.TorchObjectPlacement))
    port = _run(port_live.measure_affinity_payoff(n_records=N_RECORDS, device="cpu"))
    ref = _run(ref_live.measure_affinity_payoff(n_records=N_RECORDS))
    assert {k: ref[k] for k in DECISIONS} == {k: port[k] for k in DECISIONS}
    assert ref["pairs_colocated"] == ref["partitions"]
    assert set(ref) == set(port)


def test_the_bench_tier_has_the_references_keys(monkeypatch):
    import bench as ref_bench
    from rio_tpu_torch import bench as port_bench

    for mod in (ref_live, port_live):
        monkeypatch.setattr(mod, "measure_affinity_payoff",
                            functools.partial(mod.measure_affinity_payoff, n_records=16))
        monkeypatch.setattr(mod, "measure_sampler_overhead", functools.partial(
            mod.measure_sampler_overhead, n_workers=4, requests_per_batch=16, n_objects=16, cycles=2))
    port = port_bench.affinity_payoff("cpu")
    ref = ref_bench.affinity_payoff()
    assert set(port) == set(ref)
    assert set(port["sampler"]) == set(ref["sampler"])
    assert set(port["host"]) == set(ref["host"]) | {"platform", "device", "power_limit"}
    assert port["host"]["device"] == "cpu"
