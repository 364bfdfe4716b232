"""engine_iters: iterations of the contention engine's event loop a
period (``sim/engine.py::_event_loop``).

The program's count ``engine.iterations`` (one a call, kept only while a
profiler runs, stamped on the profiler's clock) summed over the profiled
stretch of the traced run, divided by its periods.  Source: the
program's spans and counts.  Moves ``tick_p95_ms``.
"""
from portbench import spans


def read(data):
    vals = spans.stretch_counts(data, "engine.iterations")
    if not vals:
        return None
    return sum(vals) / data["profiled_periods"]
