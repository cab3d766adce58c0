"""The share of the traced window in which the card ran nothing.

Read for every ``device_idle.<cell kind>`` metric: each cell reports its
own, since the idle share of one cell moves that cell's end-to-end metric.
"""

from rio_bench.trace import idle_percent as read  # noqa: F401
