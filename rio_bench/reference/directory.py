"""Plain reference of the directory under churn: its guarantees, and a plain directory.

The configuration states what a directory of unit-capacity nodes owes its
users after every change, and :func:`judge` works it out again from the
event log and the answers the driver kept:

* an allocation seats every new object on a node that is alive;
* a removed object is gone, and every other object has a seat;
* after a membership change and ``rebalance()``, every node holds an
  integer share of the objects, the floor or the ceiling of its fair share
  (a node that is down holds none): ``quota_gap`` is the farthest a node
  lies outside that;
* a delta rebalance moves exactly what has to move: every seat of a node
  that left, and each node's excess over its largest-remainder quota
  (:func:`fair_quotas`, ties to the lower index), and nothing else, and
  lands every node on that quota; ``max_delta_solves`` deltas are followed
  by one full solve;
* a full rebalance moves no more than it must: beyond the seats forced
  by the change in each node's count, its moves (``full_excess_moves``,
  a share of the objects) are rounding of the solve, not a reshuffle;
* the counts the directory reports (``moved``, ``displaced``) are those
  of its answer.

Every seat is read after the rebalance of a few turns spread over the
window (the driver's blocks); a turn whose previous turn was read too is
judged whole, and ``unjudged_kinds`` counts the kinds of turn (a delta or
a full solve, a node leaving or returning) that no judged turn covered.

:class:`PlainDirectory` is a straightforward directory with the same
surface and keeps every guarantee. With ``keep_all=True`` it takes the
shortcut a faster rebalance would: only the objects of nodes that left
move (to the least-loaded live nodes), and no node gives up its excess, so
a node that returns stays empty: the control, which breaks the quotas.
With ``reshuffle=True`` its full rebalances seat every object anew, in
order, without regard to where it sits (a solve from scratch, the
shortcut a faster full solve would take), and break the bound on moves.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np


def fair_quotas(alive: np.ndarray, n: int) -> np.ndarray:
    """Largest-remainder integer shares of ``n`` seats over unit-capacity ``alive`` nodes.

    Floors of ``n / live`` and one more seat for the lowest-index live
    nodes until the shares sum to ``n``; nodes that are down get none.
    """
    alive = np.asarray(alive, bool)
    live = int(alive.sum())
    quota = np.zeros(alive.shape[0], np.int64)
    if live == 0 or n <= 0:
        return quota
    quota[alive] = n // live
    extra = np.nonzero(alive)[0][: n - live * (n // live)]
    quota[extra] += 1
    return quota


def share_gap(counts: np.ndarray, alive: np.ndarray, n: int) -> float:
    """How far the farthest node's count lies outside ``[floor, ceil]`` of its fair share."""
    alive = np.asarray(alive, bool)
    live = max(int(alive.sum()), 1)
    lo = np.where(alive, n // live, 0)
    hi = np.where(alive, -(-n // live), 0)
    return float(np.maximum(np.maximum(lo - counts, counts - hi), 0).max())


@dataclass
class Turn:
    """One turn of the window as the driver saw it."""

    alloc_seats: np.ndarray  # (batch,) node index of each new object, -1 if unknown
    alive_at_alloc: np.ndarray  # (m,) bool
    alive_after: np.ndarray  # (m,) bool, after the membership change
    change: str  # "leave" or "return"
    expect_full: bool
    mode: str
    moved_returned: int
    moved: int
    displaced: int
    discarded: bool
    # Kept on judged turns only: seats of the live objects before the
    # allocation and after the rebalance, and removed objects still found.
    before: np.ndarray | None = None
    after: np.ndarray | None = None
    removed_found: int = 0


def judge(turns: list[Turn], final: np.ndarray, final_alive: np.ndarray, final_removed_found: int,
          n: int, batch: int) -> dict:
    """The numbers compared for a churn window; each passes at or under its limit."""
    m = final_alive.shape[0]
    out = {
        "alloc_off_live": 0.0, "missing_ids": 0.0, "quota_gap": 0.0, "delta_extra_moves": 0.0,
        "full_excess_moves": 0.0, "mode_mismatch": 0.0, "count_gap": 0.0,
    }
    kinds = {(full, change) for full in (False, True) for change in ("leave", "return")}
    for t in turns:
        seats = t.alloc_seats
        out["alloc_off_live"] += float(np.sum((seats < 0) | ~t.alive_at_alloc[np.clip(seats, 0, m - 1)]))
        is_delta = t.mode.endswith("+delta")
        out["mode_mismatch"] += float(t.discarded or is_delta == t.expect_full)
        out["count_gap"] += abs(t.moved_returned - t.moved) + (abs(t.moved - t.displaced) if is_delta else 0)
        if t.before is None:
            continue
        kinds.discard((t.expect_full, t.change))
        pre = np.concatenate([t.before[batch:], seats])
        after = t.after
        out["missing_ids"] += float(np.sum(after < 0) + np.sum(pre < 0) + t.removed_found)
        quota = fair_quotas(t.alive_after, n)
        counts_after = np.bincount(after[after >= 0], minlength=m)
        out["quota_gap"] = max(out["quota_gap"], share_gap(counts_after, t.alive_after, n))
        counts = np.bincount(pre[pre >= 0], minlength=m)
        movers = after != pre
        moved_out = np.bincount(pre[movers & (pre >= 0)], minlength=m)
        out["count_gap"] += abs(int(movers.sum()) - t.moved)
        if is_delta:
            required = np.where(t.alive_after, np.maximum(counts - quota, 0), counts)
            out["delta_extra_moves"] += float(
                np.abs(moved_out - required).sum() + np.abs(counts_after - quota).sum()
            )
        else:
            forced = int(np.maximum(counts - counts_after, 0).sum())
            out["full_excess_moves"] = max(out["full_excess_moves"], (int(movers.sum()) - forced) / n)
    out["unjudged_kinds"] = float(len(kinds))
    out["missing_ids"] += float(np.sum(final < 0) + final_removed_found)
    final_counts = np.bincount(final[final >= 0], minlength=m)
    out["quota_gap"] = max(out["quota_gap"], share_gap(final_counts, final_alive, n))
    return out


class _Stats:
    def __init__(self) -> None:
        self.mode, self.moved, self.displaced = "none", 0, 0
        self.solve_ms = self.apply_ms = 0.0
        self.discarded = False


class PlainDirectory:
    """A straightforward directory with the surface the churn driver calls.

    Seats live in an insertion-ordered dict; a new object goes to the
    least-loaded live node (lowest index first). ``rebalance()`` keeps, on
    each live node, its earliest-placed objects up to the node's quota,
    and seats the rest into each node's remaining quota in node order.
    With ``keep_all`` it keeps every object of a live node and seats the
    departed nodes' objects on the least-loaded live nodes; with
    ``reshuffle`` a full rebalance seats every object anew in order. Every
    ``max_delta_solves + 1``-th rebalance is reported as a full one.
    """

    def __init__(self, *, keep_all: bool = False, reshuffle: bool = False, max_delta_solves: int = 8) -> None:
        self._keep_all, self._reshuffle = keep_all, reshuffle
        self._max_delta = max_delta_solves
        self._since_full: int | None = None
        self._seats: dict[str, int] = {}
        self._index: dict[str, int] = {}
        self._order: list[str] = []
        self._alive: list[bool] = []
        self._load: list[int] = []
        self.stats = _Stats()

    def sync_members(self, members) -> None:
        for mb in members:
            addr = mb.address
            if addr not in self._index:
                self._index[addr] = len(self._order)
                self._order.append(addr)
                self._alive.append(True)
                self._load.append(0)
            self._alive[self._index[addr]] = bool(mb.active)

    def _least_loaded(self, count: int) -> list[int]:
        heap = [(self._load[j], j) for j in range(len(self._order)) if self._alive[j]]
        heapq.heapify(heap)
        out = []
        for _ in range(count):
            load, j = heapq.heappop(heap)
            out.append(j)
            heapq.heappush(heap, (load + 1, j))
        return out

    async def assign_batch(self, object_ids) -> list[str]:
        keys = [str(o) for o in object_ids]
        new = [k for k in keys if k not in self._seats]
        for k, j in zip(new, self._least_loaded(len(new))):
            self._seats[k] = j
            self._load[j] += 1
        return [self._order[self._seats[k]] for k in keys]

    async def remove(self, object_id) -> None:
        j = self._seats.pop(str(object_id), None)
        if j is not None:
            self._load[j] -= 1

    async def lookup_batch(self, object_ids) -> list[str | None]:
        return [
            None if (j := self._seats.get(str(o))) is None else self._order[j] for o in object_ids
        ]

    async def rebalance(self, *, delta: bool | None = None) -> int:
        full = delta is False or self._since_full is None or self._since_full >= self._max_delta
        self._since_full = 0 if full else self._since_full + 1
        m, n = len(self._order), len(self._seats)
        alive = np.asarray(self._alive, bool)
        quota = fair_quotas(alive, n)
        if full and self._reshuffle:
            targets = np.repeat(np.arange(m), quota).tolist()
            moved = sum(j != t for j, t in zip(self._seats.values(), targets))
            self._seats = dict(zip(self._seats, targets))
            self._load = quota.tolist()
            self.stats = _Stats()
            self.stats.mode = "plain+collapsed"
            self.stats.moved = self.stats.displaced = moved
            return moved
        kept = np.zeros(m, np.int64)
        displaced = []
        for key, j in self._seats.items():
            if alive[j] and (self._keep_all or kept[j] < quota[j]):
                kept[j] += 1
            else:
                displaced.append(key)
        self._load = kept.tolist()
        if self._keep_all:
            targets = self._least_loaded(len(displaced))
        else:
            targets = np.repeat(np.arange(m), quota - kept).tolist()
        for key, j in zip(displaced, targets):
            self._seats[key] = j
            self._load[j] += 1
        self.stats = _Stats()
        self.stats.mode = "plain+collapsed" if full else "plain+delta"
        self.stats.moved = self.stats.displaced = len(displaced)
        return len(displaced)
