"""The port's own actor runtime, live on loopback, on the CPU.

* The runtimes speak one wire: a ``rio_tpu`` client gets answers from port
  servers, and a port client from ``rio_tpu`` servers.
* ``tests/test_route_hops.py``'s three scenarios on the port's
  ``utils.routing_live``, with the reference's bounds.
* The same 8 x 256 run on ``TorchObjectPlacement(device="cpu")`` beside the
  reference's on ``JaxObjectPlacement()``.
* The daemon churn scenario of ``tests/test_torch_placement_server.py`` on
  the port's own ``Server``, gossip and ``PlacementDaemon``, with its bounds.
* Port servers on the native transport answer both runtimes' clients.
* ``examples.tpu_placement``'s demo, on the CPU: the daemon's hierarchical
  re-solve after a death, and the tracker's 200 objects.
* ``bench.row2_torch_provider_live()`` without a device raises on a host
  without CUDA.
"""

import asyncio
import pathlib

import pytest

torch = pytest.importorskip("torch")

import rio_tpu  # noqa: E402
from rio_tpu.object_placement.jax_placement import JaxObjectPlacement  # noqa: E402
from rio_tpu.utils import routing_live as ref_live  # noqa: E402

import rio_tpu_torch  # noqa: E402
from rio_tpu_torch import bench as port_bench  # noqa: E402
from rio_tpu_torch import native as port_native  # noqa: E402
from rio_tpu_torch.cluster.membership_protocol.peer_to_peer import PeerToPeerClusterConfig  # noqa: E402
from rio_tpu_torch.examples.tpu_placement import N_OBJECTS as N_DEMO  # noqa: E402
from rio_tpu_torch.examples.tpu_placement import run_demo  # noqa: E402
from rio_tpu_torch.object_placement import TorchObjectPlacement  # noqa: E402
from rio_tpu_torch.utils import churn_live  # noqa: E402
from rio_tpu_torch.utils import routing_live as port_live  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


async def _ask_across(boot_live, client_cls, client_live, n_objects: int = 24, transport: str = "asyncio"):
    """Boot ``boot_live``'s echo cluster; ask it through ``client_cls`` with ``client_live``'s types."""
    members, _placement, tasks, servers = await boot_live.boot_echo_cluster(3, transport=transport)
    try:
        client = client_cls(members, transport=transport)
        try:
            seen = set()
            for i in range(n_objects):
                out = await client.send(
                    client_live.EchoActor, f"x{i}", client_live.Echo(value=i), returns=client_live.Echo
                )
                assert type(out) is client_live.Echo and out.value == i
                seen.add(await _placement.lookup(boot_live.ObjectId("EchoActor", f"x{i}")))
            assert seen <= {s.local_address for s in servers}
            return client.stats.requests
        finally:
            client.close()
    finally:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)


def test_a_reference_client_gets_answers_from_port_servers():
    assert type(port_live.Server) is type and port_live.Server is rio_tpu_torch.Server
    assert asyncio.run(_ask_across(port_live, rio_tpu.Client, ref_live)) == 24


def test_a_port_client_gets_answers_from_reference_servers():
    assert asyncio.run(_ask_across(ref_live, rio_tpu_torch.Client, port_live)) == 24


def test_directory_policy_beats_random_policy_p99():
    stats = asyncio.run(port_live.measure_route_hops_live(n_servers=8, n_objects=256))
    ref, ours = stats["reference"], stats["rio_tpu"]
    assert ours.n_requests == ref.n_requests == 256
    assert ours.p50 >= 1.0 and ref.p50 >= 1.0
    assert ours.p99 <= 0.8 * ref.p99, (ours, ref)
    assert ours.mean < ref.mean, (ours, ref)


def test_directory_policy_hops_are_exactly_one():
    stats = asyncio.run(port_live.measure_route_hops_live(n_servers=4, n_objects=64))
    ours = stats["rio_tpu"]
    assert ours.mean == 1.0 and ours.p99 == 1.0, ours


def test_stale_directory_degrades_gracefully():
    out = asyncio.run(port_live.measure_route_hops_scaled(n_servers=16, n_objects=2000, sample_size=800))
    assert out["stale_failures"] == 0
    assert out["directory"]["mean"] == 1.0
    assert out["stale"]["p99"] <= 4
    assert out["reference"]["mean"] > out["directory"]["mean"]
    assert out["displaced"] > 0 and out["wrong"] > 0


def test_hops_on_the_torch_provider_beside_the_jax_provider():
    port = asyncio.run(
        port_live.measure_route_hops_live(n_servers=8, n_objects=256, placement=TorchObjectPlacement(device="cpu"))
    )
    ref = asyncio.run(ref_live.measure_route_hops_live(n_servers=8, n_objects=256, placement=JaxObjectPlacement()))
    assert port["rio_tpu"].n_requests == ref["rio_tpu"].n_requests == 256
    assert port["reference"].n_requests == ref["reference"].n_requests == 256
    assert port["rio_tpu"].mean == ref["rio_tpu"].mean == 1.0
    assert port["rio_tpu"].p99 == ref["rio_tpu"].p99 == 1.0


def test_the_daemon_reseats_a_dead_nodes_objects_on_the_ports_own_server():
    n_echo, n_counters = 64, 96
    placement = TorchObjectPlacement(move_cost=0.5, device="cpu")  # auto: greedy on the CPU
    # tests/server_utils.py's fast gossip, as the reference scenario runs it.
    fast = PeerToPeerClusterConfig(
        interval_secs=0.25, num_failures_threshold=1, interval_secs_threshold=2.0,
        drop_inactive_after_secs=60.0, ping_timeout=0.2,
    )
    out = asyncio.run(
        churn_live.measure_daemon_churn(
            placement, n_servers=3, n_echo=n_echo, n_counters=n_counters, sample_size=64,
            gossip=fast, rebalance_timeout=15.0, reseat_timeout=15.0,
        )
    )
    n = n_echo + n_counters
    assert out["n_objects"] == n and placement.count() == n
    assert out["displaced"] > 0
    assert out["dead_rows"] == 0
    assert out["displaced"] <= out["moved"] <= out["displaced"] + n // 4, out
    assert 0 < out["planned_moves"] <= out["displaced"] + n // 4, out
    assert out["stats"]["mode"].startswith("greedy") and not out["stats"]["discarded"]
    assert out["counters"] == n_counters and out["lost"] == [], out["lost"]
    assert out["hops"]["mean"] == 1.0 and out["hops"]["n"] == 64
    assert out["victim"] not in out["live"] and len(out["live"]) == 2


def test_the_ports_server_builds_native_into_its_own_directory():
    assert port_native._SO == ROOT / "rio_tpu_torch" / "kernels" / "_build" / "librio_native.so"
    assert port_native._SRC == ROOT / "native" / "rio_native.cc"
    if port_native.get() is not None:
        assert port_native._SO.exists()


def test_port_servers_on_the_native_transport_answer_both_runtimes_clients():
    if port_native.get() is None:
        pytest.skip("no C++ compiler to build native/rio_native.cc")
    assert asyncio.run(_ask_across(port_live, rio_tpu_torch.Client, port_live, transport="native")) == 24
    assert asyncio.run(_ask_across(port_live, rio_tpu.Client, ref_live, transport="native")) == 24


def test_the_demo_resolves_after_a_death_on_the_cpu():
    out = asyncio.run(run_demo("cpu", verbose=False))
    assert out["device"] == "cpu"
    assert out["requests"] == N_DEMO and out["redirects"] == 0
    assert out["mode"].startswith("hierarchical") and not out["discarded"] and out["n_objects"]
    assert out["observed"] == N_DEMO
    assert out["reachable"] == N_DEMO


@pytest.mark.skipif(torch.cuda.is_available(), reason="the default device is CUDA here")
def test_row2_without_a_device_raises_on_a_host_without_cuda():
    with pytest.raises(RuntimeError):
        port_bench.row2_torch_provider_live()
