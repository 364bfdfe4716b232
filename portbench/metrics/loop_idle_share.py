"""loop_idle_share: share of the profiled stretch in which no operation
ran on the device while the service loop held the host
(``serving/service.py::serve_stream``): the innermost open program span
was ``serving.stage``, ``serving.readback`` or ``serving.record``, or no
program span was open, %.

As ``engine_idle_share`` (``spans.idle_by_span``).  Source: the
program's spans against the device trace.  Moves ``periods_per_s``.
"""
from portbench import spans


def read(data):
    return spans.idle_share(data, lambda n: n in spans.LOOP
                            or n == spans.NONE, "serving.stage")
