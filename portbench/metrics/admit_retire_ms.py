"""admit_retire_ms: host time a tick spends in the program's
``serving.admit`` and ``serving.retire`` profiler ranges
(``core/serve.py`` over ``serving/queue.py``), ms.

Summed over the ranges that open inside the profiled stretch of the
traced run, divided by its periods.  Source: the program's spans.
Moves ``periods_per_s``.
"""

RANGES = ("serving.admit", "serving.retire")


def read(data):
    if "window" not in data:
        return None
    lo, hi = data["window"]
    tot = sum(e - s for name, s, e in data["host_events"]
              if name in RANGES and lo <= s < hi)
    if tot <= 0:
        return None
    return 1e3 * tot / data["profiled_periods"]
