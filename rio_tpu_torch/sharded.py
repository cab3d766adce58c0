"""Sharded multi-process data plane: one node, N worker processes.

:class:`ShardedServer` is rung 2 of the data-plane ladder (ROADMAP): a
parent supervisor spawns N worker processes that all accept on ONE
front-door address via ``SO_REUSEPORT`` (fallback where the option is
unavailable: a parent-bound listener whose fd every child inherits), while
each worker ALSO listens on a unique *identity* port. The identity address
is what enters membership and the placement directory, so the existing
directory machinery — client redirect-follow, ``ObjectPlacement`` rows,
migration, replication — routes cross-shard traffic unchanged: a request
accepted by the wrong worker is answered with the standard ``Redirect`` to
the owner's identity address and the client's placement cache converges.
No new wire values; golden-wire bytes are identical to a plain server's.

Ownership is a deterministic slice of the object space::

    shard = crc32(f"{type_name}/{id}") % n_workers      # commands.shard_of

enforced lazily by the service layer's :class:`~rio_tpu_torch.commands.
ShardRouter` seam: an unplaced object is seated only by its preferred
worker while that worker is alive. A dead worker's slice degrades to lazy
self-assign by whichever worker is asked (after the supervisor marks the
death in membership), so availability never hinges on the hash map — and a
``MigrationManager`` move OVERRIDES the map, because seated directory rows
are honored before the router is consulted.

Workers are separate OS processes — the multi-core unlock for a Python
host (the reference's tokio worker threads, ``rio-rs/src/service.rs:
370-459``, have no GIL to design around). They are spawned with a clean
environment and joined only through shared membership/placement storage:
the same topology as a multi-host cluster, collapsed onto one box.

CLI::

    python -m rio_tpu_torch.sharded --address 0.0.0.0:9000 --workers 4 \
        --registry myapp.actors:build_registry --data-dir /var/lib/rio
    python -m rio_tpu_torch.sharded --smoke          # 2-worker loopback self-test
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

from .commands import ShardMap, ShardRouter, shard_of  # re-exported: the shard map

__all__ = ["ShardedServer", "ShardMap", "ShardRouter", "shard_of",
           "sqlite_members", "sqlite_placement"]

_HAS_REUSEPORT = hasattr(socket, "SO_REUSEPORT")


# ----------------------------------------------------------------------
# Storage factories (importable by worker processes by dotted name)
# ----------------------------------------------------------------------

def sqlite_members(data_dir: str):
    """Default shared membership: one sqlite file under ``data_dir``."""
    from .cluster.storage.sqlite import SqliteMembershipStorage

    return SqliteMembershipStorage(os.path.join(data_dir, "members.db"))


def sqlite_placement(data_dir: str):
    """Default shared directory: one sqlite file under ``data_dir``."""
    from .object_placement.sqlite import SqliteObjectPlacement

    return SqliteObjectPlacement(os.path.join(data_dir, "placement.db"))


def _load_factory(spec: str):
    """Resolve a ``module:callable`` factory spec."""
    import importlib

    mod, sep, attr = spec.partition(":")
    if not sep or not attr:
        raise ValueError(f"factory spec must be 'module:callable', got {spec!r}")
    obj = importlib.import_module(mod)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def _split_address(address: str) -> tuple[str, int]:
    host, sep, port = address.rpartition(":")
    if not sep:
        raise ValueError(f"address must be 'host:port', got {address!r}")
    return host or "0.0.0.0", int(port)


def _reserve_port(host: str) -> tuple[socket.socket | None, int]:
    """Reserve an ephemeral port a child can later bind.

    With ``SO_REUSEPORT`` the reservation socket stays OPEN (bound, never
    listening — the kernel only distributes connections among *listening*
    sockets, so an unlistened holder just pins the port) and the child
    re-binds the same port with the flag set. Without it, bind-then-close:
    racy against the rest of the host, but the only portable option.
    """
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    if _HAS_REUSEPORT:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        s.bind((host, 0))
        return s, s.getsockname()[1]
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return None, port


class ShardedServer:
    """Parent supervisor for N worker processes sharing one front door.

    Parameters are JSON-able on purpose — they cross a process boundary:

    * ``registry`` / ``members`` / ``placement`` are ``module:callable``
      factory specs, resolved INSIDE each worker (a live Registry can't be
      pickled across an exec boundary; storage must be re-opened per
      process anyway). ``members``/``placement`` factories take
      ``data_dir``; the registry factory takes no arguments.
    * ``server_kwargs`` is a dict of JSON-able :class:`~rio_tpu_torch.server.
      Server` kwargs applied to every worker (e.g. ``{"metrics": False}``).

    ``router=False`` / ``front_door=False`` disable the shard map / shared
    listener — ``workers=1`` with both off is exactly one plain server
    child, which is what ``python -m rio_tpu_torch.bench --sharded`` pairs
    against to price the
    sharding machinery itself.
    """

    def __init__(
        self,
        *,
        address: str = "127.0.0.1:0",
        workers: int | None = None,
        registry: str,
        data_dir: str,
        members: str = "rio_tpu_torch.sharded:sqlite_members",
        placement: str = "rio_tpu_torch.sharded:sqlite_placement",
        reuseport: bool | None = None,
        router: bool = True,
        front_door: bool = True,
        server_kwargs: dict | None = None,
        env: dict | None = None,
        python: str | None = None,
    ) -> None:
        self.address = address
        self.workers = workers if workers is not None else (os.cpu_count() or 1)
        if self.workers < 1:
            raise ValueError("workers must be >= 1")
        self.registry_spec = registry
        self.data_dir = data_dir
        self.members_spec = members
        self.placement_spec = placement
        self.reuseport = _HAS_REUSEPORT if reuseport is None else reuseport
        self.router = router
        self.front_door = front_door
        self.server_kwargs = dict(server_kwargs or {})
        self.env_override = env
        self.python = python or sys.executable

        self.procs: list[subprocess.Popen] = []
        self.worker_addresses: list[str] = []
        self.map_epoch: int = 0
        self.front_address: str | None = None
        self._front_sock: socket.socket | None = None  # fd-fallback listener
        self._reservations: list[socket.socket] = []
        self._logs: list = []
        self._stopping = False
        self._monitors: list[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "ShardedServer":
        """Reserve ports, spawn every worker, start the death monitor.

        Returns immediately; await :meth:`wait_ready` (or call
        :meth:`start_and_wait` from sync code) before sending traffic.
        """
        if self.procs:
            raise RuntimeError("already started")
        os.makedirs(self.data_dir, exist_ok=True)
        host, front_port = _split_address(self.address)
        from .server import _routable_host

        adv_host = host if host not in ("", "0.0.0.0", "::") else _routable_host()

        front_spec = None
        pass_fds: tuple = ()
        if self.front_door:
            if self.reuseport:
                res, front_port = self._reserve_front(host, front_port)
                self._reservations.append(res)
                front_spec = {"mode": "reuseport", "host": host,
                              "port": front_port}
            else:
                s = socket.socket()
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                s.bind((host, front_port))
                s.listen(512)
                s.set_inheritable(True)
                front_port = s.getsockname()[1]
                self._front_sock = s
                front_spec = {"mode": "fd", "fd": s.fileno()}
                pass_fds = (s.fileno(),)
        self.front_address = f"{adv_host}:{front_port}" if front_spec else None

        ports: list[int] = []
        for _ in range(self.workers):
            res, p = _reserve_port(host)
            if res is not None:
                self._reservations.append(res)
            ports.append(p)
        self.worker_addresses = [f"{adv_host}:{p}" for p in ports]

        # Map epoch: a persisted per-data_dir counter bumped every start, so
        # a supervisor restart (new worker ports, reseated slices) publishes
        # a map shard-aware clients can tell apart from the one they adopted
        # — the signal that drops their stale direct-dial state.
        use_router = self.router and self.workers > 1
        shard_map = ""
        if use_router:
            self.map_epoch = self._next_epoch()
            shard_map = ShardMap(
                epoch=self.map_epoch, slots=tuple(self.worker_addresses)
            ).encode()

        env = self._child_env()
        for i in range(self.workers):
            spec = {
                "slot": i,
                "slots": self.worker_addresses,
                "bind_host": host,
                "identity_port": ports[i],
                "advertise": self.worker_addresses[i],
                "reuse_port": self.reuseport,
                "front": front_spec,
                "registry": self.registry_spec,
                "members": self.members_spec,
                "placement": self.placement_spec,
                "data_dir": self.data_dir,
                "router": use_router,
                "shard_map": shard_map,
                "server_kwargs": self.server_kwargs,
            }
            log_f = open(os.path.join(self.data_dir, f"worker{i}.log"), "wb")
            self._logs.append(log_f)
            proc = subprocess.Popen(
                [self.python, "-m", "rio_tpu_torch.sharded", "--worker"],
                stdin=subprocess.PIPE,
                stdout=log_f,
                stderr=subprocess.STDOUT,
                env=env,
                pass_fds=pass_fds,
                close_fds=True,
            )
            assert proc.stdin is not None
            proc.stdin.write(json.dumps(spec).encode())
            proc.stdin.close()
            self.procs.append(proc)
        for i, proc in enumerate(self.procs):
            t = threading.Thread(
                target=self._monitor, args=(i, proc), daemon=True
            )
            t.start()
            self._monitors.append(t)
        return self

    def _next_epoch(self) -> int:
        """Increment the persisted map epoch for this data_dir."""
        path = os.path.join(self.data_dir, "shard_epoch")
        try:
            with open(path) as f:
                epoch = int(f.read().strip() or 0)
        except (OSError, ValueError):
            epoch = 0
        epoch += 1
        with open(path, "w") as f:
            f.write(str(epoch))
        return epoch

    def _reserve_front(
        self, host: str, port: int
    ) -> tuple[socket.socket, int]:
        """Pin the front-door port without receiving traffic (see
        :func:`_reserve_port`); a requested port of 0 resolves here so every
        worker is told the same concrete port."""
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        s.bind((host, port))
        return s, s.getsockname()[1]

    def _child_env(self) -> dict:
        if self.env_override is not None:
            return dict(self.env_override)
        # Clean environment, the multihost-test discipline: an ambient
        # sitecustomize (e.g. an accelerator plugin registration) must not
        # leak into data-plane workers; they pin CPU unless told otherwise.
        repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        return {
            "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
            "HOME": os.environ.get("HOME", "/tmp"),
            "PYTHONPATH": repo_root,
            "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu"),
        }

    async def wait_ready(self, timeout: float = 60.0) -> None:
        """Poll shared membership until every worker identity is active."""
        members = _load_factory(self.members_spec)(self.data_dir)
        try:
            deadline = time.monotonic() + timeout
            want = set(self.worker_addresses)
            while time.monotonic() < deadline:
                dead = [
                    i for i, p in enumerate(self.procs) if p.poll() is not None
                ]
                if dead and not self._stopping:
                    raise RuntimeError(
                        f"worker(s) {dead} exited during bring-up; see "
                        + ", ".join(
                            os.path.join(self.data_dir, f"worker{i}.log")
                            for i in dead
                        )
                    )
                try:
                    active = {m.address for m in await members.active_members()}
                except Exception:
                    active = set()
                if want <= active:
                    return
                await asyncio.sleep(0.05)
            raise TimeoutError(
                f"workers never became active members (want {sorted(want)})"
            )
        finally:
            with contextlib.suppress(Exception):
                members.close()

    def start_and_wait(self, timeout: float = 60.0) -> "ShardedServer":
        self.start()
        asyncio.run(self.wait_ready(timeout))
        return self

    # -- death handling ------------------------------------------------

    def _monitor(self, i: int, proc: subprocess.Popen) -> None:
        """Mark a dead worker inactive in membership.

        This is the supervisor half of worker-death reseat: once the
        identity is inactive, any worker touching one of the dead slice's
        objects takes the dead-owner branch (``clean_server`` + lazy
        self-assign) and traffic converges onto the survivors. A graceful
        worker marks itself on exit; doing it again here is idempotent.
        """
        proc.wait()
        if self._stopping:
            return
        addr = self.worker_addresses[i]
        with contextlib.suppress(Exception):
            asyncio.run(self._mark_inactive(addr))

    async def _mark_inactive(self, address: str) -> None:
        members = _load_factory(self.members_spec)(self.data_dir)
        try:
            host, _, port = address.rpartition(":")
            await members.set_inactive(host, int(port))
        finally:
            with contextlib.suppress(Exception):
                members.close()

    def terminate_worker(self, i: int, sig: int = signal.SIGKILL) -> None:
        """Kill one worker (chaos / tests). The monitor thread records the
        death in membership exactly as it would for a real crash."""
        with contextlib.suppress(ProcessLookupError):
            self.procs[i].send_signal(sig)

    # -- shutdown ------------------------------------------------------

    def stop(self, graceful: bool = True, timeout: float = 20.0) -> list[int]:
        """Stop every worker; returns their exit codes.

        ``graceful`` sends SIGTERM first — each worker's signal handler
        enqueues ``AdminCommand.drain()``, so seated objects run their
        shutdown lifecycle and local directory rows are released before
        exit. Stragglers past ``timeout`` are SIGKILLed.
        """
        self._stopping = True
        sig = signal.SIGTERM if graceful else signal.SIGKILL
        for p in self.procs:
            if p.poll() is None:
                with contextlib.suppress(ProcessLookupError):
                    p.send_signal(sig)
        deadline = time.monotonic() + timeout
        codes = []
        for p in self.procs:
            left = max(0.1, deadline - time.monotonic())
            try:
                codes.append(p.wait(timeout=left))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(p.wait())
        for s in self._reservations:
            with contextlib.suppress(OSError):
                s.close()
        self._reservations.clear()
        if self._front_sock is not None:
            with contextlib.suppress(OSError):
                self._front_sock.close()
            self._front_sock = None
        for f in self._logs:
            with contextlib.suppress(OSError):
                f.close()
        self._logs.clear()
        return codes

    def worker_log(self, i: int) -> str:
        path = os.path.join(self.data_dir, f"worker{i}.log")
        try:
            with open(path, "rb") as f:
                return f.read().decode(errors="replace")
        except OSError:
            return ""


# ----------------------------------------------------------------------
# Worker process entry
# ----------------------------------------------------------------------

async def _run_worker(spec: dict) -> None:
    from . import Server
    from .cluster.membership_protocol import LocalClusterProvider
    from .commands import AdminCommand

    members = _load_factory(spec["members"])(spec["data_dir"])
    placement = _load_factory(spec["placement"])(spec["data_dir"])
    registry = _load_factory(spec["registry"])()

    extra_socks = []
    front = spec.get("front")
    if front is not None:
        if front["mode"] == "reuseport":
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            s.bind((front["host"], front["port"]))
        else:
            # Inherited parent-bound listener: every worker epolls the same
            # fd (accept herd — the portability fallback, not the fast path).
            s = socket.socket(fileno=front["fd"])
        extra_socks.append(s)

    server = Server(
        address=f"{spec['bind_host']}:{spec['identity_port']}",
        advertise_address=spec["advertise"],
        registry=registry,
        cluster_provider=LocalClusterProvider(members),
        object_placement_provider=placement,
        reuse_port=bool(spec.get("reuse_port")),
        extra_listen_socks=extra_socks,
        **spec.get("server_kwargs", {}),
    )
    if spec.get("router"):
        server.app_data.set(
            ShardRouter(
                self_address=spec["advertise"], slots=tuple(spec["slots"])
            )
        )
    if spec.get("shard_map"):
        # Publish the supervisor's map (epoch + slots) on every heartbeat
        # row, so shard-aware clients can compute crc32 % N locally and
        # dial this worker's identity address with zero redirects.
        server.cluster_provider.set_shard_map(spec["shard_map"])
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


def _worker_main() -> int:
    spec = json.loads(sys.stdin.read())
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    asyncio.run(_run_worker(spec))
    return 0


# ----------------------------------------------------------------------
# Load-generator child (``rio_tpu_torch.bench --sharded`` drives N of these)
# ----------------------------------------------------------------------

async def _run_loadgen(spec: dict) -> dict:
    """Warm the actor population, wait for GO on stdin, measure a window.

    A separate process per load generator keeps the client's CPU off the
    workers' cores on multi-core hosts; the parent starts every generator,
    waits for all WARM lines, then broadcasts GO so the measured windows
    coincide.
    """
    from .client import Client
    from .utils.routing_live import Echo, EchoActor

    members = _load_factory(spec["members"])(spec["data_dir"])
    client = Client(members, shard_aware=bool(spec.get("shard_aware")))
    try:
        n_objects = spec.get("n_objects", 256)
        n_workers = spec.get("n_workers", 32)
        per = spec.get("requests_per_worker", 200)
        prefix = spec.get("prefix", "lg")
        ids = [f"{prefix}-{i}" for i in range(n_objects)]
        for oid in ids:
            await client.send(EchoActor, oid, Echo(value=1), returns=Echo)
        print("WARM", flush=True)
        await asyncio.get_running_loop().run_in_executor(
            None, sys.stdin.readline
        )

        async def worker(w: int) -> None:
            for r in range(per):
                oid = ids[(w * per + r) % n_objects]
                await client.send(EchoActor, oid, Echo(value=r), returns=Echo)

        t0 = time.perf_counter()
        await asyncio.gather(*[worker(w) for w in range(n_workers)])
        dt = time.perf_counter() - t0
        total = n_workers * per
        return {
            "rate": total / dt,
            "total": total,
            "secs": dt,
            "redirects": client.stats.redirects,
            "shard_routes": client.stats.shard_routes,
        }
    finally:
        client.close()
        with contextlib.suppress(Exception):
            members.close()


def _loadgen_main() -> int:
    spec = json.loads(sys.stdin.readline())
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    out = asyncio.run(_run_loadgen(spec))
    print("RESULT " + json.dumps(out), flush=True)
    return 0


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------

def _smoke_main(shard_aware: bool = False) -> int:
    """2-worker loopback self-test (the CI tier-1 sharded smoke).

    With ``shard_aware`` the client adopts the published shard map and the
    smoke additionally asserts the audit counters: every unplaced send was
    direct-dialed (``shard_routes > 0``) and none paid a redirect hop
    (``redirects == 0``).
    """
    import tempfile

    async def drive(node: ShardedServer) -> dict:
        from .client import Client
        from .registry import ObjectId, type_id
        from .utils.routing_live import Echo, EchoActor

        await node.wait_ready(45.0)
        members = _load_factory(node.members_spec)(node.data_dir)
        placement = _load_factory(node.placement_spec)(node.data_dir)
        client = Client(members, shard_aware=shard_aware)
        try:
            tname = type_id(EchoActor)
            n = 16
            for i in range(n):
                out = await client.send(
                    EchoActor, f"smoke-{i}", Echo(value=i), returns=Echo
                )
                assert out.value == i
            owners = {}
            for i in range(n):
                row = await placement.lookup(ObjectId(tname, f"smoke-{i}"))
                assert row in node.worker_addresses, row
                expect = node.worker_addresses[
                    shard_of(tname, f"smoke-{i}", len(node.worker_addresses))
                ]
                assert row == expect, (row, expect)
                owners[row] = owners.get(row, 0) + 1
            result = {"ok": True, "n": n, "spread": owners}
            if shard_aware:
                assert client.stats.redirects == 0, client.stats
                assert client.stats.shard_routes > 0, client.stats
                result["redirects"] = client.stats.redirects
                result["shard_routes"] = client.stats.shard_routes
            return result
        finally:
            client.close()
            with contextlib.suppress(Exception):
                members.close()
            with contextlib.suppress(Exception):
                placement.close()

    with tempfile.TemporaryDirectory() as tmp:
        node = ShardedServer(
            address="127.0.0.1:0",
            workers=2,
            registry="rio_tpu_torch.utils.routing_live:build_echo_registry",
            data_dir=tmp,
        )
        node.start()
        try:
            result = asyncio.run(drive(node))
        except BaseException:
            for i in range(node.workers):
                sys.stderr.write(
                    f"--- worker{i}.log ---\n{node.worker_log(i)}\n"
                )
            raise
        finally:
            node.stop()
        print("SMOKE OK " + json.dumps(result), flush=True)
    return 0


def _supervise_main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m rio_tpu_torch.sharded")
    ap.add_argument("--address", default="127.0.0.1:0")
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--registry", required=True,
                    help="module:callable returning a Registry")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--members", default="rio_tpu_torch.sharded:sqlite_members")
    ap.add_argument("--placement", default="rio_tpu_torch.sharded:sqlite_placement")
    ap.add_argument("--no-reuseport", action="store_true")
    args = ap.parse_args(argv)

    node = ShardedServer(
        address=args.address,
        workers=args.workers,
        registry=args.registry,
        data_dir=args.data_dir,
        members=args.members,
        placement=args.placement,
        reuseport=False if args.no_reuseport else None,
    )
    node.start_and_wait()
    print(
        f"front={node.front_address} workers={node.worker_addresses}",
        flush=True,
    )
    done = threading.Event()
    for signum in (signal.SIGTERM, signal.SIGINT):
        signal.signal(signum, lambda *_: done.set())
    done.wait()
    node.stop(graceful=True)
    return 0


def _main() -> int:
    argv = sys.argv[1:]
    if argv[:1] == ["--worker"]:
        return _worker_main()
    if argv[:1] == ["--loadgen"]:
        return _loadgen_main()
    if argv[:1] == ["--smoke"]:
        return _smoke_main(shard_aware="--shard-aware" in argv[1:])
    return _supervise_main(argv)


if __name__ == "__main__":
    sys.exit(_main())
