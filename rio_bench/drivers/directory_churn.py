"""A directory under turnover and a rolling restart, through the ``ObjectPlacement``
surface that ``PlacementDaemon`` calls, on
``rio_tpu_torch.object_placement.torch_placement.TorchObjectPlacement``.

Set-up registers the members, seats the population with ``assign_batch``
and runs one full ``rebalance(delta=False)``. Each turn of the window is
one caller's closed loop, as the daemon handles one change at a time:

1. ``assign_batch`` of a batch of new objects (timed as ``alloc``), then
   ``remove`` of as many of the oldest, so the population stays the same;
2. one membership change of a rolling restart (a node leaves, then it
   returns), each ``sync_members`` then ``rebalance()`` at its default
   (timed as ``resolve``, from the ``sync_members`` call to the return).

The driver keeps every allocation's seats and every rebalance's reported
counts. It also reads every object's seat after the rebalance of the
turns around every ``check_every``-th full solve, from one drawn from the
seed on, so that these blocks spread over the whole window; that time is
left out of the window. A turn whose previous turn was read is judged
whole (the read after one turn is the state before the next), three turns
a block: a delta, the full solve, a delta. ``check_every`` is an odd
multiple of the full solve's period, so the full solves judged alternate
between a node leaving and one returning. After the window it reads every
seat once more.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np
import torch

from rio_bench import traffic
from rio_bench.reference import directory as reference


class Member:
    """What ``sync_members`` reads of a membership row."""

    def __init__(self, address: str) -> None:
        self.address = address
        self.active = True


class Driver:
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device) -> None:
        self.n, self.m = config["objects"], config["nodes"]
        self.provider = config["provider"]
        self.batch = mix["alloc_batch"]
        self.type_name = mix["type_name"]
        self.warm_turns = mix["warm_turns"]
        self.check_every = mix["check_every"]
        period = self.provider["max_delta_solves"] + 1
        if self.check_every % period or not (self.check_every // period) % 2:
            raise ValueError(f"check_every {self.check_every} is not an odd multiple of {period}")
        self.limits = mix["limits"]
        self.trace_turns = (mix["trace_from"], mix["trace_turns"])
        self.seed, self.device = seed, device
        self.program = None  # a factory of the directory; the program's by default
        self.paused_s = 0.0
        self.alloc_ms: list[float] = []
        self.resolve_ms: list[float] = []
        self.events: list[dict] = []  # the program's stats after each window turn
        self.turns: list[reference.Turn] = []

    # -- set-up ------------------------------------------------------------
    def setup(self) -> None:
        from rio_tpu_torch.registry import ObjectId

        self._object_id = ObjectId
        if self.program is None:
            from rio_tpu_torch.object_placement.torch_placement import TorchObjectPlacement

            self.program = lambda: TorchObjectPlacement(device=self.device, **self.provider)
        self._loop = asyncio.new_event_loop()
        self._p = self.program()
        self.addresses = [f"10.{i // 256}.{i % 256}.1:5000" for i in range(self.m)]
        self.index = {a: i for i, a in enumerate(self.addresses)}
        self.members = [Member(a) for a in self.addresses]
        self.ids = [ObjectId(self.type_name, str(i)) for i in range(self.n)]
        self.head = 0  # the oldest live object
        self._changes = traffic.rolling_restart(self.seed, self.m)
        self._since_full = 0
        self._p.sync_members(self.members)
        self._run(self._p.assign_batch(self.ids))
        self._run(self._p.rebalance(delta=False))
        for _ in range(self.warm_turns):
            self._run(self._turn(None))
        self._first_full = self._plan_reads()
        self.min_turns = self._first_full + self.check_every + 2  # two blocks judged
        self._after = None  # seats read after the previous turn, if it was read

    def _plan_reads(self) -> int:
        """The first full solve judged: the first at or after a window turn drawn from the seed.

        Every block reads turns ``F - 2 .. F + 1`` around a full solve ``F``
        and judges ``F - 1 .. F + 1``.
        """
        period = self.provider["max_delta_solves"] + 1
        rng = np.random.default_rng(traffic.sub_seed(self.seed, "sample"))
        start = 2 + int(rng.integers(2 * period))
        first = max(self.provider["max_delta_solves"] - self._since_full, 0)
        return first + -(-(start - first) // period) * period

    def _read_after(self, i: int) -> bool:
        return i >= self._first_full - 2 and (i - self._first_full + 2) % self.check_every <= 3

    def _run(self, coro):
        return self._loop.run_until_complete(coro)

    async def _read(self, lo: int, hi: int) -> np.ndarray:
        """Every seat of objects ``[lo, hi)`` by ``lookup_batch``, as node indices (-1: none)."""
        t0 = time.perf_counter()
        seats = await self._p.lookup_batch(self.ids[lo:hi])
        out = np.fromiter((self.index.get(a, -1) for a in seats), np.int32, count=hi - lo)
        self.paused_s += time.perf_counter() - t0
        return out

    # -- the window ----------------------------------------------------------
    async def _turn(self, i: int | None) -> None:
        """One turn; ``i`` is the window turn, None for a warm-up turn."""
        p, b = self._p, self.batch
        lo = self.head + self.n
        t0 = time.perf_counter()
        self.ids.extend(self._object_id(self.type_name, str(k)) for k in range(lo, lo + b))
        self.paused_s += time.perf_counter() - t0
        alive_at_alloc = np.array([mb.active for mb in self.members])

        t0 = time.perf_counter()
        with torch.profiler.record_function("rio_bench.assign_batch"):
            seats = await p.assign_batch(self.ids[lo : lo + b])
        alloc_ms = (time.perf_counter() - t0) * 1e3
        with torch.profiler.record_function("rio_bench.remove"):
            for oid in self.ids[self.head : self.head + b]:
                await p.remove(oid)

        kind, node = next(self._changes)
        self.members[node].active = kind == "return"
        t0 = time.perf_counter()
        with torch.profiler.record_function("rio_bench.resolve"):
            p.sync_members(self.members)
            moved = await p.rebalance()
        resolve_ms = (time.perf_counter() - t0) * 1e3

        expect_full = self._since_full >= self.provider["max_delta_solves"]
        self._since_full = 0 if expect_full else self._since_full + 1
        removed = self.ids[self.head : self.head + b]
        self.head += b
        if i is None:
            return
        st = p.stats
        self.alloc_ms.append(alloc_ms)
        self.resolve_ms.append(resolve_ms)
        self.events.append({"turn": i, "mode": st.mode, "solve_ms": st.solve_ms, "apply_ms": st.apply_ms})
        turn = reference.Turn(
            alloc_seats=np.fromiter((self.index.get(a, -1) for a in seats), np.int64, count=b),
            alive_at_alloc=alive_at_alloc,
            alive_after=np.array([mb.active for mb in self.members]), change=kind,
            expect_full=expect_full, mode=st.mode, moved_returned=int(moved),
            moved=int(st.moved), displaced=int(st.displaced), discarded=bool(st.discarded),
        )
        before, self._after = self._after, None
        if self._read_after(i):
            self._after = await self._read(self.head, self.head + self.n)
            if before is not None:
                turn.before, turn.after = before, self._after
                t0 = time.perf_counter()
                turn.removed_found = sum(a is not None for a in await p.lookup_batch(removed))
                self.paused_s += time.perf_counter() - t0
        self.turns.append(turn)

    def turn(self, i: int) -> None:
        self._run(self._turn(i))

    # -- results -------------------------------------------------------------
    def end_to_end(self, window_s: float) -> dict:
        return {
            "resolve_p50_ms": float(np.percentile(self.resolve_ms, 50)),
            "resolve_p95_ms": float(np.percentile(self.resolve_ms, 95)),
            "alloc_p95_ms": float(np.percentile(self.alloc_ms, 95)),
        }

    def counters(self) -> dict:
        return {"events": self.events, "traced_turns": self.trace_turns}

    def samples(self) -> dict:
        full = sum(not e["mode"].endswith("+delta") for e in self.events)
        return {"resolve": len(self.resolve_ms), "alloc": len(self.alloc_ms),
                "full": full, "delta": len(self.events) - full}

    def release(self) -> None:
        """Reads every seat once more, then drops the directory and stops its threads."""
        self.final = self._run(self._read(self.head, self.head + self.n))
        removed = self.ids[self.head - self.batch : self.head]
        self.final_removed_found = sum(a is not None for a in self._run(self._p.lookup_batch(removed)))
        self.final_alive = np.array([mb.active for mb in self.members])
        del self._p, self.program
        self._loop.run_until_complete(self._loop.shutdown_default_executor())
        self._loop.close()

    def check(self) -> list[tuple[str, float, float]]:
        judged = reference.judge(
            self.turns, self.final, self.final_alive, self.final_removed_found, self.n, self.batch,
        )
        return [(name, judged[name], limit) for name, limit in self.limits.items()]
