"""engine_idle_share: share of the profiled stretch in which no
operation ran on the device while the innermost open program span was
the engine's (a name that starts with ``engine.``: ``engine.simulate``
and ``engine.check``, ``sim/engine.py::_event_loop``), %.

The device's idle gaps (``yardstick.idle_gaps``) cut at every program
span's bounds and put down to the innermost program span open over each
piece (``spans.idle_by_span``).  Source: the program's spans against
the device trace.  Moves ``periods_per_s``.
"""
from portbench import spans


def read(data):
    return spans.idle_share(data, lambda n: n.startswith(spans.ENGINE),
                            "engine.simulate")
