"""stage_ms: host time a period spends staging its admission rows and
copying them to the device (``serving/service.py::serve_stream``), ms.

The program's ``serving.stage`` spans in the profiled stretch of the
traced run, summed and divided by its periods.  Source: the program's
spans.  Moves ``periods_per_s``.
"""
from portbench import spans


def read(data):
    return spans.host_ms_per_period(data, {"serving.stage"},
                                    "serving.stage")
