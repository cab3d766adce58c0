"""Mean ``stats.apply_ms`` of the directory's full rebalances (mode without ``+delta``).

A program counter of ``TorchObjectPlacement``: the host apply of the
movers under the provider's lock. Read over the window's turns outside
the traced ones, so that the profiler's cost is left out.
"""


def read(t):
    first, count = t.counters["traced_turns"]
    vals = [
        e["apply_ms"] for e in t.counters["events"]
        if not e["mode"].endswith("+delta") and not first <= e["turn"] < first + count
    ]
    return sum(vals) / len(vals) if vals else None
