"""Per-stage milliseconds from the program's own spans (``rio_tpu_torch.tracing``).

While the profiler records, each span of the program opens a profiler range
of its name and times its stage into a ring of the newest entries per name:
on a card, the device wall from a CUDA event at the span's start to one at
its end (its device work plus any idle inside it that waits for the host).
A stage metric counts the ranges ``k`` of its span inside the traced
window, sums the ``k`` newest ring entries, and divides by the traced
turns. Tying ``k`` to the trace takes exactly the traced turns' entries,
however many traced runs one process has made. A program without such
spans leaves no range in the trace: the metric is then absent.
"""

from __future__ import annotations


def stage_ms(t, name: str) -> float | None:
    """Milliseconds a traced turn spends in the span ``name``, or None."""
    lo, hi = t.window
    k = sum(1 for h in t.host if h.name == name and h.start >= lo and h.end <= hi)
    if not k or not t.turns:
        return None
    from rio_tpu_torch import tracing

    read = getattr(tracing, "device_stage_ms", None)
    return None if read is None else read(name, k) / t.turns
