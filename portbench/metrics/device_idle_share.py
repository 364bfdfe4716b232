"""device_idle_share: share of the profiled stretch in which no
operation ran on the device, %.

One less the union of the device's kernel, copy and set intervals over
the stretch's length, from ``torch.profiler`` over a few periods of the
traced run's first call (``yardstick.busy_seconds``).  Source: device
trace.  Moves ``periods_per_s``.
"""
from portbench import yardstick as ys


def read(data):
    if "window" not in data:
        return None
    lo, hi = data["window"]
    busy = ys.busy_seconds(data["device_events"], lo, hi)
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / (hi - lo))
