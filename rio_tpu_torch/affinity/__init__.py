"""Communication-affinity edge sampling (the graph the solver co-locates by).

``AffinityTracker`` (``object_placement/torch_placement.py``) counts
per-object *rates* — how hot an actor is — but placement stayed blind to
*who talks to whom*: a stream cursor hammering its consumer across TCP
looked exactly like two unrelated hot actors. This module samples the
``(src_object | "client", dst_object)`` edge graph at the dispatch path so
:class:`~rio_tpu_torch.object_placement.torch_placement.TorchObjectPlacement` can
price co-location (Distributed Data Placement via Graph Partitioning,
arXiv:1312.0285; DreamShard, arXiv:2210.02023 for measured cost models).

Design constraints, in order:

1. **The dispatch hot path pays almost nothing.** Observations are
   stride-sampled (1-in-``stride``, the same power-of-2 mask the RED
   histograms and span tail capture use) and the skipped branch is one
   integer add + mask + compare. Sampled counts are scaled by the stride
   so rates stay unbiased.
2. **Memory is bounded.** The accumulator and the folded edge map are
   both capped at ``top_k`` edges; cold edges (lowest EMA byte rate) are
   evicted at fold time and counted in ``evictions``.
3. **Source identity never touches the wire.** A handler-to-handler send
   carries its source key in-process only: :func:`sending_from` binds a
   contextvar around the send, ``InternalClientSender`` snapshots it into
   the queued command, and the dispatch path stamps it onto the (non-wire)
   ``RequestEnvelope.source`` field. Frames on TCP are byte-identical to
   before — no codec or native change, old peers unaffected.

The sampler also keeps plain TCP byte counters (``tcp_in_bytes`` /
``tcp_out_bytes``, fed by both transports) — those are the honest
numerator of the ``bench.py --affinity`` bytes-over-TCP A/B: co-locating a
chatty pair must move real frames off the socket, not just reclassify
edges.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time

__all__ = [
    "EdgeSampler",
    "current_source",
    "sending_from",
    "merge_edges",
]

# The in-process source identity of the actor (or subsystem) issuing a
# send. Set by the dispatch path around handler execution and by explicit
# `sending_from` blocks in streams/sagas; captured by InternalClientSender
# at enqueue (the same discipline trace_ctx uses).
_SOURCE: contextvars.ContextVar[str] = contextvars.ContextVar(
    "rio_affinity_source", default=""
)


def current_source() -> str:
    """The object key currently issuing sends ("" = external client)."""
    return _SOURCE.get()


@contextlib.contextmanager
def sending_from(key: str):
    """Bind the affinity source identity for sends inside the block.

    Used by subsystems whose sends don't pass through a dispatched
    handler's context (stream cursor deliveries, saga step sends) so the
    receiving dispatch path attributes the edge to the real source actor
    instead of ``"client"``.
    """
    token = _SOURCE.set(key)
    try:
        yield
    finally:
        _SOURCE.reset(token)


def _pow2(n: int) -> int:
    """Round up to a power of two (>= 1)."""
    n = max(1, int(n))
    p = 1
    while p < n:
        p <<= 1
    return p


class EdgeSampler:
    """Per-node communication-edge sketch with EMA byte/call rates.

    One instance per server process. ``observe`` runs on the event loop
    (dispatch path); ``fold`` runs on the load loop; ``edges`` may be read
    from admin handlers. Folded state is swapped atomically (whole-dict
    replacement) so concurrent readers never see a half-built map.
    """

    __slots__ = (
        "stride",
        "top_k",
        "beta",
        "min_fold_dt",
        "_mask",
        "_tick",
        "_acc",
        "_edges",
        "_fold_t",
        "_lock",
        "sampled",
        "evictions",
        "tcp_in_bytes",
        "tcp_out_bytes",
        "_cross_win",
        "cross_bytes_per_s",
    )

    def __init__(
        self,
        *,
        stride: int = 8,
        top_k: int = 512,
        beta: float = 0.3,
        min_fold_dt: float = 0.05,
    ) -> None:
        self.stride = _pow2(stride)
        self.top_k = max(1, int(top_k))
        self.beta = float(beta)
        self.min_fold_dt = float(min_fold_dt)
        self._mask = self.stride - 1
        self._tick = -1
        # (src, dst) -> [bytes, calls, local_calls] — stride-scaled window
        # accumulator, drained at fold.
        self._acc: dict[tuple[str, str], list] = {}
        # (src, dst) -> (bytes_per_s EMA, calls_per_s EMA, local_frac EMA)
        self._edges: dict[tuple[str, str], tuple[float, float, float]] = {}
        self._fold_t = time.monotonic()
        self._lock = threading.Lock()  # folds only (loop + admin readers)
        self.sampled = 0
        self.evictions = 0
        self.tcp_in_bytes = 0
        self.tcp_out_bytes = 0
        self._cross_win = 0.0  # stride-scaled cross-node bytes this window
        self.cross_bytes_per_s = 0.0

    # -- hot path ----------------------------------------------------------

    def observe(self, src: str, dst: str, nbytes: int, local: bool) -> None:
        """Record one dispatch on the (src → dst) edge (stride-sampled).

        ``local`` means the send never crossed TCP (internal in-process
        delivery). Callers pass the raw payload size; the stride scale is
        applied here so rates stay unbiased.
        """
        self._tick = tick = (self._tick + 1) & self._mask
        if tick:
            return
        self.observe_sampled(src, dst, nbytes, local)

    def observe_sampled(self, src: str, dst: str, nbytes: int, local: bool) -> None:
        """The post-stride-gate slow path.

        The dispatch hot path (``service.py``) inlines the gate itself —
        ``self._tick = t = (self._tick + 1) & self._mask`` — and calls
        this only on the 1-in-``stride`` hit: the method call alone was
        the sampler's single largest measured per-request cost. Keep the
        gate arithmetic here and there in sync.
        """
        if src == dst:
            return
        scale = self.stride
        self.sampled += 1
        e = self._acc.get((src, dst))
        if e is None:
            if len(self._acc) >= self.top_k * 2:
                # Window accumulator under key churn: drop the smallest
                # entry rather than grow without bound between folds.
                victim = min(self._acc, key=lambda k: self._acc[k][0])
                del self._acc[victim]
                self.evictions += 1
            self._acc[(src, dst)] = e = [0.0, 0.0, 0.0]
        e[0] += nbytes * scale
        e[1] += scale
        if local:
            e[2] += scale
        else:
            self._cross_win += nbytes * scale

    # -- fold / read -------------------------------------------------------

    def fold(self, now: float | None = None, *, force: bool = False) -> bool:
        """Fold the window accumulator into the EMA edge map.

        Time-gated (``min_fold_dt``) so admin reads and the load loop can
        both call it without double-decaying; returns True when a fold
        actually ran.
        """
        if now is None:
            now = time.monotonic()
        with self._lock:
            dt = now - self._fold_t
            if dt < self.min_fold_dt and not force:
                return False
            dt = max(dt, 1e-6)
            self._fold_t = now
            acc, self._acc = self._acc, {}
            cross, self._cross_win = self._cross_win, 0.0
            beta = self.beta
            keep = 1.0 - beta
            new: dict[tuple[str, str], tuple[float, float, float]] = {}
            for key, (b_ema, c_ema, l_ema) in self._edges.items():
                win = acc.pop(key, None)
                if win is None:
                    b = keep * b_ema
                    c = keep * c_ema
                    lf = l_ema
                else:
                    b = keep * b_ema + beta * (win[0] / dt)
                    c = keep * c_ema + beta * (win[1] / dt)
                    lf = keep * l_ema + beta * (win[2] / max(win[1], 1e-9))
                if b >= 1e-6 or c >= 1e-6:
                    new[key] = (b, c, lf)
            for key, win in acc.items():  # edges first seen this window
                new[key] = (
                    beta * (win[0] / dt),
                    beta * (win[1] / dt),
                    win[2] / max(win[1], 1e-9),
                )
            if len(new) > self.top_k:
                ranked = sorted(new, key=lambda k: new[k][0], reverse=True)
                self.evictions += len(ranked) - self.top_k
                new = {k: new[k] for k in ranked[: self.top_k]}
            self._edges = new  # atomic swap
            self.cross_bytes_per_s = (
                keep * self.cross_bytes_per_s + beta * (cross / dt)
            )
        return True

    def edges(self, limit: int = 0) -> list[list]:
        """Folded edge rows ``[src, dst, bytes_per_s, calls_per_s, local_frac]``.

        Sorted by byte rate, hottest first; ``limit`` 0 = all tracked.
        """
        self.fold()
        snap = self._edges
        rows = sorted(snap.items(), key=lambda kv: kv[1][0], reverse=True)
        if limit:
            rows = rows[:limit]
        return [
            [src, dst, round(b, 3), round(c, 3), round(lf, 4)]
            for (src, dst), (b, c, lf) in rows
        ]

    def gauges(self) -> dict[str, float]:
        """Gauge snapshot for ``server_gauges`` / otel export."""
        return {
            "rio.affinity.edges": float(len(self._edges)),
            "rio.affinity.evictions": float(self.evictions),
            "rio.affinity.sampled": float(self.sampled),
            "rio.affinity.cross_bytes_per_s": round(self.cross_bytes_per_s, 3),
            "rio.affinity.tcp_in_bytes": float(self.tcp_in_bytes),
            "rio.affinity.tcp_out_bytes": float(self.tcp_out_bytes),
        }


def merge_edges(per_node_rows: list[list[list]]) -> list[list]:
    """Merge per-node edge rows into one cluster-wide graph.

    Each actor-to-actor edge is observed exactly once cluster-wide
    (dst-side for in-process sends, sender-side for remote ones — the
    receiving node attributes wire arrivals to ``"client"``), so a plain
    sum is the correct merge; summing also covers a dst actor that moved
    between scrapes. Returns ``[src, dst, bytes_per_s, calls_per_s,
    local_frac]`` rows sorted by byte rate (local_frac becomes
    byte-weighted). Rows are read positionally and may GROW trailing
    fields (wire compatibility contract; extras are ignored here).
    """
    agg: dict[tuple[str, str], list] = {}
    for rows in per_node_rows:
        for src, dst, b, c, lf, *_extra in rows:
            e = agg.get((src, dst))
            if e is None:
                agg[(src, dst)] = [float(b), float(c), float(lf) * float(b)]
            else:
                e[0] += float(b)
                e[1] += float(c)
                e[2] += float(lf) * float(b)
    out = [
        [src, dst, round(b, 3), round(c, 3), round(lw / b, 4) if b > 0 else 0.0]
        for (src, dst), (b, c, lw) in agg.items()
    ]
    out.sort(key=lambda r: r[2], reverse=True)
    return out
