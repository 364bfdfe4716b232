"""engine_ms_p95: the 95th percentile over the traced run's periods of
the time inside the contention engine (``sim/engine.py::simulate``,
called from ``sim/env.py::period``), ms.

The benchmark wraps ``engine.simulate`` at the module attribute that
``SchedulingEnv`` reads at call time, synchronising the device before
and after; periods of the profiled stretch are left out.  Source: host
clock.  Moves ``tick_p95_ms``.
"""
from portbench import yardstick as ys


def read(data):
    eng = data.get("engine_s")
    if not eng:
        return None
    return 1e3 * ys.percentile(eng, 95)
