"""engine_iter_host_us: host time an iteration of the contention
engine's event loop spends outside its host checks, us.

The program's ``engine.simulate`` spans in the profiled stretch of the
traced run, less the ``engine.check`` spans inside them (the host
waiting on the device for the loop's condition), over the iterations
the program counted there (``engine.iterations``).  Source: the
program's spans and counts.  Moves ``tick_p95_ms``.
"""
from portbench import spans


def read(data):
    iters = spans.stretch_counts(data, "engine.iterations")
    if not iters or sum(iters) <= 0:
        return None
    sims = spans.stretch_spans(data, {"engine.simulate"})
    checks = spans.stretch_spans(data, {"engine.check"})
    host = 0.0
    for _, s, e in sims:
        host += (e - s) - sum(ce - cs for _, cs, ce in checks
                              if s <= cs and ce <= e)
    return 1e6 * host / sum(iters)
