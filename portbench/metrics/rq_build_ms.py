"""rq_build_ms: host time a period spends building the ready queue and
its features (``sim/env.py::SchedulingEnv.period``: the drop pass, the
slots, the encode), ms.

The program's ``env.drops``, ``env.slots`` and ``env.encode`` spans in
the profiled stretch of the traced run, summed and divided by its
periods.  Source: the program's spans.  Moves ``periods_per_s``.
"""
from portbench import spans


def read(data):
    return spans.host_ms_per_period(
        data, {"env.drops", "env.slots", "env.encode"}, "env.slots")
