"""``python -m rio_tpu_torch.autoscale`` — elastic-node worker entry + demo smoke.

Two modes:

* ``--node`` — the :class:`~rio_tpu_torch.autoscale.provision.
  SubprocessProvisioner` child: read a JSON spec from stdin, join the
  shared storages, serve until drained (SIGTERM/SIGINT run the graceful
  drain exactly like a :mod:`rio_tpu_torch.sharded` worker).
* ``--demo`` — self-checking CI smoke: boot a one-node in-process
  cluster with autoscaling enabled, ramp synthetic load up and back
  down, and assert the full causal chain — sustained-overload HEALTH
  alarm → ``scale_out`` SCALE decision → (load off) → ``scale_in`` →
  drain → clean ``retired``. Prints one JSON line + ``OK`` and exits 0;
  any missing link exits 2 with the journal tail for diagnosis.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import signal
import sys
import time


# -- elastic-node worker entry (SubprocessProvisioner child) ------------------


async def _run_node(spec: dict) -> None:
    from .. import Server
    from ..cluster.membership_protocol import LocalClusterProvider
    from ..commands import AdminCommand
    from ..sharded import _load_factory

    members = _load_factory(spec["members"])(spec["data_dir"])
    placement = _load_factory(spec["placement"])(spec["data_dir"])
    registry = _load_factory(spec["registry"])()

    app_data = None
    if spec.get("state"):
        # Shared durable state provider: what lets this node die (even by
        # SIGKILL) without losing a single acked write — survivors reload
        # the state at reseat-activation.
        from ..app_data import AppData
        from ..state import StateProvider

        provider = _load_factory(spec["state"])(spec["data_dir"])
        await provider.prepare()
        app_data = AppData()
        app_data.set(provider, as_type=StateProvider)

    server = Server(
        address=f"{spec['bind_host']}:{spec['identity_port']}",
        advertise_address=spec["advertise"],
        registry=registry,
        cluster_provider=LocalClusterProvider(members),
        object_placement_provider=placement,
        app_data=app_data,
        reuse_port=bool(spec.get("reuse_port")),
        **spec.get("server_kwargs", {}),
    )
    await server.prepare()
    await server.bind()
    # Drain-then-exit on supervisor (or operator) signals: the admin queue
    # runs the full graceful path — cordon, lifecycle shutdown for seated
    # objects, release of local directory rows, membership set_inactive.
    loop = asyncio.get_running_loop()
    admin = server.admin_sender()
    for signum in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(
            signum, lambda: admin.send(AdminCommand.drain())
        )
    print(f"READY {server.local_address}", flush=True)
    await server.run()


def _node_main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    spec = json.loads(sys.stdin.read())
    asyncio.run(_run_node(spec))
    return 0


# -- the self-checking demo smoke ---------------------------------------------


async def _run_demo() -> dict:
    from .. import Client, LocalObjectPlacement, LocalStorage, Server
    from ..cluster.membership_protocol import LocalClusterProvider
    from ..commands import AdminCommand
    from ..journal import HEALTH, SCALE
    from ..utils.routing_live import Echo, EchoActor, build_echo_registry
    from . import AutoscaleConfig, ScalePolicy
    from .provision import InProcessProvisioner

    members = LocalStorage()
    placement = LocalObjectPlacement()
    provisioner = InProcessProvisioner(
        members,
        placement,
        registry_builder=build_echo_registry,
        server_kwargs={"load_interval": 0.1},
    )
    # Pure request-rate pressure: deterministic on any CI box (loop lag
    # and inflight snapshots are scheduler-dependent; req/s under a
    # steady driver is not).
    # Bands sized against the demo driver (~2000 req/s up, ~0 down) with
    # the low band well clear of the controller's own poke traffic —
    # ticks and heartbeats are requests too (~3 req/s of floor).
    policy = ScalePolicy(
        min_nodes=1,
        max_nodes=2,
        high_pressure=50.0,
        low_pressure=8.0,
        sustain=2,
        ema_alpha=0.7,
        inflight_weight=0.0,
        lag_weight=0.0,
        rate_weight=1.0,
        shed_weight=0.0,
        out_cooldown_s=0.5,
        in_cooldown_s=0.5,
        cooldown_max_s=2.0,
        drain_timeout_s=30.0,
    )
    supervisor = Server(
        address="127.0.0.1:0",
        registry=build_echo_registry(),
        cluster_provider=LocalClusterProvider(members),
        object_placement_provider=placement,
        load_interval=0.1,
        autoscale_config=AutoscaleConfig(
            provisioner=provisioner, policy=policy, interval=0.2
        ),
    )
    await supervisor.prepare()
    await supervisor.bind()
    serve = asyncio.ensure_future(supervisor.run())
    runtime = supervisor.autoscale
    client = Client(members)
    stop_load = asyncio.Event()

    async def writer(i: int) -> None:
        while not stop_load.is_set():
            with contextlib.suppress(Exception):
                await client.send(EchoActor, f"demo-{i % 16}", Echo(value=i))
            await asyncio.sleep(0.005)

    async def wait_for(pred, timeout: float, what: str) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if pred():
                return
            await asyncio.sleep(0.1)
        raise TimeoutError(f"demo: no {what} within {timeout:.0f}s")

    writers: list[asyncio.Task] = []
    try:
        # Ramp up: sustained load must produce exactly one scale-out
        # (max_nodes caps further growth).
        writers = [asyncio.ensure_future(writer(i)) for i in range(24)]
        await wait_for(
            lambda: runtime.scale_outs >= 1, 45.0, "scale-out decision"
        )
        # Ramp down: rate decays under the low band → scale-in → drain →
        # clean retire of the provisioned node.
        stop_load.set()
        for w in writers:
            w.cancel()
        await asyncio.gather(*writers, return_exceptions=True)
        writers = []
        await wait_for(
            lambda: runtime.scale_ins >= 1, 60.0, "completed scale-in"
        )
    finally:
        stop_load.set()
        for w in writers:
            w.cancel()
        await asyncio.gather(*writers, return_exceptions=True)
        with contextlib.suppress(Exception):
            client.close()

    # The causal chain, from the supervisor's journal: the sustained
    # alarm precedes the decision, the decision precedes the retire.
    assert supervisor.journal is not None
    events = supervisor.journal.events(kinds=[HEALTH, SCALE])
    labels = [
        (ev.kind, ev.attrs.get("action", "") or ev.key) for ev in events
    ]

    def index_of(kind: str, name: str) -> int:
        for i, (k, n) in enumerate(labels):
            if k == kind and n == name:
                return i
        raise AssertionError(
            f"demo: no {kind}/{name} event in journal: {labels}"
        )

    alarm_i = index_of(HEALTH, "scale_out_sustained")
    out_i = index_of(SCALE, "scale_out")
    in_i = index_of(SCALE, "scale_in")
    retired_i = index_of(SCALE, "retired")
    assert alarm_i < out_i < in_i < retired_i, (
        f"demo: causal chain out of order: {labels}"
    )
    retired_ev = events[retired_i]
    assert not retired_ev.attrs.get("forced"), (
        f"demo: scale-in was forced, not a clean drain: {retired_ev.attrs}"
    )
    result = {
        "scale_outs": runtime.scale_outs,
        "scale_ins": runtime.scale_ins,
        "final_nodes": runtime.last_nodes,
        "pressure": round(runtime.pressure, 3),
        "chain": [f"{k}:{n}" for k, n in labels],
    }

    supervisor.admin_sender().send(AdminCommand.server_exit())
    with contextlib.suppress(Exception):
        await asyncio.wait_for(serve, timeout=10.0)
    await provisioner.close()
    await runtime.close()
    return result


def _demo_main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    try:
        result = asyncio.run(asyncio.wait_for(_run_demo(), timeout=150.0))
    except BaseException as e:  # noqa: BLE001 — smoke must exit nonzero, loudly
        print(f"DEMO FAILED: {e!r}", file=sys.stderr)
        return 2
    print(json.dumps(result))
    print("OK")
    return 0


def _main() -> int:
    argv = sys.argv[1:]
    if "--node" in argv:
        return _node_main()
    if "--demo" in argv:
        return _demo_main()
    print(
        "usage: python -m rio_tpu_torch.autoscale (--demo | --node < spec.json)",
        file=sys.stderr,
    )
    return 2


if __name__ == "__main__":
    sys.exit(_main())
