"""engine_kernel_share: share of the contention engine's calls in the
profiled stretch that ran on the hand-written event-loop kernel
(``kernels/event_loop``, ``sim/engine.py::_event_loop``), %.

The program's count ``engine.kernel`` (1 a call on the kernel, 0 on the
eager loop; kept only while a profiler runs, stamped on the profiler's
clock) averaged over the stretch's engine calls, times 100.  None for a
program that keeps no such count.  Source: the program's counts.  Moves
``periods_per_s``.
"""
from portbench import spans


def read(data):
    vals = spans.stretch_counts(data, "engine.kernel")
    if not vals:
        return None
    return 100.0 * sum(vals) / len(vals)
