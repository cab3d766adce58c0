"""Mean ``stats.solve_ms`` of the directory's delta rebalances (mode ``+delta``).

A program counter of ``TorchObjectPlacement``: the displaced objects'
solve, host snapshot work and the class refresh on the device included.
Read over the window's turns outside the traced ones.
"""


def read(t):
    first, count = t.counters["traced_turns"]
    vals = [
        e["solve_ms"] for e in t.counters["events"]
        if e["mode"].endswith("+delta") and not first <= e["turn"] < first + count
    ]
    return sum(vals) / len(vals) if vals else None
