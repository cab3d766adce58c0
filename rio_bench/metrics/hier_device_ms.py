"""Device-busy milliseconds per chunked two-level solve (``parallel/hierarchical.py``)."""

from rio_bench.trace import busy_us


def read(t):
    lo, hi = t.window
    if not t.device or not t.turns:
        return None
    return busy_us(t.device, lo, hi) / 1e3 / t.turns
