"""Per-handler RED metrics: mergeable log-bucketed latency histograms.

The reference exports counters-only gauges; every distributional target on
the roadmap (bounded p99 during resize, node-death→plan latency) needs the
framework to measure latency *distributions* about itself. This module is
the zero-dependency instrument:

* :class:`HandlerHistogram` — one (rate, errors-by-kind, duration)
  histogram per ``(handler_type, message_type)``. Buckets are log2 over
  microseconds so 1 µs…2 min collapses into a few dozen ints; ``record``
  is O(1) with no locks (single-threaded under the event loop, GIL-atomic
  int bumps elsewhere). The slowest *traced* sample stashes its trace id
  as an **exemplar**, so a p99 spike links straight to its trace.
* :class:`MetricsRegistry` — the per-server container the dispatch path
  records into (resolved once per connection from AppData), with a key
  cardinality cap (an id-explosion in message names lands in one overflow
  row rather than an unbounded dict).
* Wire rows — ``snapshot_rows``/:func:`hist_from_row`/:func:`merge_rows`:
  plain positional lists a ``DUMP_STATS`` admin scrape ships and a
  cluster-wide scraper merges across nodes (histograms add bucket-wise;
  quantiles are computed only after the merge).

Quantiles come from the buckets (upper bound of the bucket where the
cumulative count crosses ``q``), so a p99 is accurate to one power of two
— the right fidelity for a self-measuring framework at zero record cost.
"""

from __future__ import annotations

from typing import Any, Iterable

#: log2-of-microseconds buckets: bucket ``i`` holds durations whose
#: microsecond count has bit_length ``i`` (i.e. ``[2^(i-1), 2^i)`` µs;
#: bucket 0 is sub-µs). 28 buckets span sub-µs to ~134 s — anything
#: slower saturates the top bucket.
N_BUCKETS = 28

#: Cardinality cap for distinct (handler_type, message_type) keys; overflow
#: lands in one shared row so a pathological workload can't grow the
#: registry without bound.
MAX_KEYS = 512
OVERFLOW_KEY = ("_overflow", "_overflow")


class HandlerHistogram:
    """RED counters + log-bucketed durations for one handler/message pair."""

    __slots__ = (
        "count",
        "error_count",
        "errors",
        "buckets",
        "sum_s",
        "max_s",
        "exemplar_trace",
        "exemplar_s",
    )

    def __init__(self) -> None:
        self.count = 0
        self.error_count = 0
        self.errors: dict[int, int] = {}  # ErrorKind int -> count
        self.buckets = [0] * N_BUCKETS
        self.sum_s = 0.0
        self.max_s = 0.0
        self.exemplar_trace = ""
        self.exemplar_s = 0.0

    def record(
        self,
        duration_s: float,
        error_kind: int | None = None,
        trace_id: str | None = None,
    ) -> None:
        self.count += 1
        self.sum_s += duration_s
        idx = int(duration_s * 1e6).bit_length()
        if idx >= N_BUCKETS:
            idx = N_BUCKETS - 1
        self.buckets[idx] += 1
        if duration_s > self.max_s:
            self.max_s = duration_s
        if error_kind is not None:
            self.error_count += 1
            self.errors[error_kind] = self.errors.get(error_kind, 0) + 1
        if trace_id and duration_s >= self.exemplar_s:
            # The slowest traced sample: by construction it sits in the
            # highest traced bucket, so the exemplar IS the top-bucket
            # outlier a p99 spike should link to.
            self.exemplar_trace = trace_id
            self.exemplar_s = duration_s

    def quantile(self, q: float) -> float:
        """Approximate quantile in seconds (upper bound of the q-bucket).

        Quantiles run over the TIMED population (``sum(buckets)``), not
        ``count``: the dispatch path stride-samples durations on the
        untraced path while counting every request, so the two totals may
        legitimately differ.
        """
        timed = sum(self.buckets)
        if timed == 0:
            return 0.0
        target = q * timed
        cum = 0
        for i, c in enumerate(self.buckets):
            cum += c
            if c and cum >= target:
                # Bucket i's upper bound is 2^i µs; clamp to the observed
                # max so a lone sample never reports above reality.
                return min((1 << i) / 1e6, self.max_s) if self.max_s else (1 << i) / 1e6
        return self.max_s

    def merge(self, other: "HandlerHistogram") -> None:
        self.count += other.count
        self.error_count += other.error_count
        for kind, n in other.errors.items():
            self.errors[kind] = self.errors.get(kind, 0) + n
        for i, c in enumerate(other.buckets):
            self.buckets[i] += c
        self.sum_s += other.sum_s
        if other.max_s > self.max_s:
            self.max_s = other.max_s
        if other.exemplar_trace and other.exemplar_s >= self.exemplar_s:
            self.exemplar_trace = other.exemplar_trace
            self.exemplar_s = other.exemplar_s


def hist_to_row(key: tuple[str, str], h: HandlerHistogram) -> list[Any]:
    """One mergeable wire row (plain positional list — codec-friendly)."""
    return [
        key[0],
        key[1],
        h.count,
        h.error_count,
        dict(h.errors),
        list(h.buckets),
        h.sum_s,
        h.max_s,
        h.exemplar_trace,
        h.exemplar_s,
    ]


def hist_from_row(row: list[Any]) -> tuple[tuple[str, str], HandlerHistogram]:
    h = HandlerHistogram()
    h.count = int(row[2])
    h.error_count = int(row[3])
    h.errors = {int(k): int(v) for k, v in dict(row[4]).items()}
    buckets = [int(c) for c in row[5]]
    # Tolerate a bucket-count drift across versions: a shorter row
    # zero-fills, a longer one folds the tail into the top bucket.
    if len(buckets) < N_BUCKETS:
        buckets.extend([0] * (N_BUCKETS - len(buckets)))
    elif len(buckets) > N_BUCKETS:
        buckets[N_BUCKETS - 1] = sum(buckets[N_BUCKETS - 1 :])
        del buckets[N_BUCKETS:]
    h.buckets = buckets
    h.sum_s = float(row[6])
    h.max_s = float(row[7])
    h.exemplar_trace = str(row[8])
    h.exemplar_s = float(row[9])
    return (str(row[0]), str(row[1])), h


def merge_rows(
    row_sets: Iterable[Iterable[list[Any]]],
) -> dict[tuple[str, str], HandlerHistogram]:
    """Merge many nodes' ``snapshot_rows`` into one cluster-wide view."""
    merged: dict[tuple[str, str], HandlerHistogram] = {}
    for rows in row_sets:
        for row in rows:
            key, h = hist_from_row(row)
            have = merged.get(key)
            if have is None:
                merged[key] = h
            else:
                have.merge(h)
    return merged


class MetricsRegistry:
    """Per-server histogram container the dispatch path records into."""

    def __init__(self, max_keys: int = MAX_KEYS) -> None:
        self._hist: dict[tuple[str, str], HandlerHistogram] = {}
        # Nested mirror of _hist for the hot path: two str-keyed gets
        # instead of building a (ht, mt) tuple per request — record() runs
        # once per dispatch and must not allocate on the steady state.
        self._fast: dict[str, dict[str, HandlerHistogram]] = {}
        self._max_keys = max_keys

    def record(
        self,
        handler_type: str,
        message_type: str,
        duration_s: float,
        error_kind: int | None = None,
        trace_id: str | None = None,
    ) -> None:
        by_mt = self._fast.get(handler_type)
        if by_mt is not None:
            h = by_mt.get(message_type)
            if h is not None:
                h.record(duration_s, error_kind, trace_id)
                return
        self._seat(handler_type, message_type).record(
            duration_s, error_kind, trace_id
        )

    def resolve(self, handler_type: str, message_type: str) -> HandlerHistogram:
        """The histogram for a key, seating it on first touch.

        The dispatch path memoizes the returned object per connection and
        bumps ``count``/``errors`` on it inline (its stride-sampled untimed
        branch): rate and errors stay exact on every request while clock
        reads and bucket updates happen only on the timed subset
        (:meth:`record`). Direct bumps are safe — single-threaded under the
        event loop, same as :meth:`HandlerHistogram.record`.
        """
        by_mt = self._fast.get(handler_type)
        if by_mt is not None:
            h = by_mt.get(message_type)
            if h is not None:
                return h
        return self._seat(handler_type, message_type)

    def count(
        self,
        handler_type: str,
        message_type: str,
        error_kind: int | None = None,
    ) -> None:
        """Exact count/error bookkeeping WITHOUT a duration sample."""
        h = self.resolve(handler_type, message_type)
        h.count += 1
        if error_kind is not None:
            h.error_count += 1
            h.errors[error_kind] = h.errors.get(error_kind, 0) + 1

    def _seat(self, handler_type: str, message_type: str) -> HandlerHistogram:
        """First touch of a key: seat it in both maps (or overflow)."""
        key = (handler_type, message_type)
        h = self._hist.get(key)
        if h is None:
            if len(self._hist) >= self._max_keys:
                key = OVERFLOW_KEY
                h = self._hist.get(key)
            if h is None:
                h = self._hist[key] = HandlerHistogram()
        if key is not OVERFLOW_KEY:
            # Overflowed keys stay on the slow path: seating every novel
            # name in _fast would grow it without bound — the exact
            # cardinality blowup max_keys exists to stop.
            self._fast.setdefault(handler_type, {})[message_type] = h
        return h

    def get(self, handler_type: str, message_type: str) -> HandlerHistogram | None:
        return self._hist.get((handler_type, message_type))

    def snapshot_rows(self) -> list[list[Any]]:
        """Every histogram as a mergeable wire row (DUMP_STATS payload)."""
        return [hist_to_row(key, h) for key, h in self._hist.items()]

    def exemplars(self) -> dict[str, str]:
        """``"<handler_type>.<message_type>" -> trace_id`` for traced outliers."""
        return {
            f"{ht}.{mt}": h.exemplar_trace
            for (ht, mt), h in self._hist.items()
            if h.exemplar_trace
        }

    def gauges(self) -> dict[str, float]:
        """Flatten into the :func:`rio_tpu_torch.otel.stats_gauges` shape."""
        out: dict[str, float] = {}
        for (ht, mt), h in self._hist.items():
            p = f"rio.handler.{ht}.{mt}"
            out[f"{p}.count"] = float(h.count)
            out[f"{p}.errors"] = float(h.error_count)
            out[f"{p}.p50_ms"] = h.quantile(0.5) * 1e3
            out[f"{p}.p90_ms"] = h.quantile(0.9) * 1e3
            out[f"{p}.p99_ms"] = h.quantile(0.99) * 1e3
            out[f"{p}.max_ms"] = h.max_s * 1e3
        return out
