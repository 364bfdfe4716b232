"""loop_host_ms: host time a period spends in the service loop
(``serving/service.py::serve_stream``) outside the tick call, ms.

Each period's latency (one tick call's entry to the next's, the last
ending when ``serve_stream`` returns) less the tick call's own time, the
tick call timed by the benchmark's wrapper to its end on the device
(``torch.cuda.synchronize()``), averaged over the traced run's periods
outside the profiled stretch.  It holds the staging of admissions, the
read-back of the completion record, the completion records themselves
and, after the last period, the flush.  Source: host clock.  Moves
``periods_per_s``.
"""


def read(data):
    per, tick = data.get("periods_s"), data.get("tick_call_s")
    if not per:
        return None
    return 1e3 * sum(p - t for p, t in zip(per, tick)) / len(per)
