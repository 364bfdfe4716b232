"""record_ms: host time a period spends writing its completion records
(``serving/service.py::MultiTenantService._record``), ms.

The program's ``serving.record`` spans (one in each period that has
completions) in the profiled stretch of the traced run, summed and
divided by its periods; 0 where no period of the stretch completed a
job.  Source: the program's spans.  Moves ``periods_per_s``.
"""
from portbench import spans


def read(data):
    return spans.host_ms_per_period(data, {"serving.record"},
                                    "serving.readback")
