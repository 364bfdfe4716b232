"""The program's spans and counts in the traced run's profiled stretch:
host time a period in named spans, the device's idle time put down to
the innermost program span open while it lasts, and the counts the
program kept inside the stretch.

Idle time goes to a layer, and the yardstick fixes what a layer is, so
that a span the program adds later moves no metric: every span whose
name starts with :data:`ENGINE` is the engine's, :data:`LOOP` names the
service loop's spans, and :data:`OTHER` the rest of the serving path's
(the tick's and the period's).  Those are the program spans here; any
other name (a later span of the program, an ATen operation, a CUDA
runtime call, the benchmark's own ``portbench.window``) is passed over
when the innermost one is sought, so its time stays with the span
around it.  Host events are ``(name, start_s, end_s)``.
"""
from __future__ import annotations

from portbench import yardstick as ys

ENGINE = "engine."
LOOP = ("serving.stage", "serving.readback", "serving.record")
OTHER = ("serving.resolve", "serving.flush", "serving.admit",
         "serving.period", "serving.retire", "serving.telemetry",
         "env.drops", "env.slots", "env.encode", "env.act", "env.commit")
NONE = "(none)"


def is_program_span(name: str) -> bool:
    return name.startswith(ENGINE) or name in LOOP or name in OTHER


def stretch_spans(data, names):
    """The host events named in ``names`` that open inside the window."""
    lo, hi = data["window"]
    return [ev for ev in data["host_events"]
            if ev[0] in names and lo <= ev[1] < hi]


def host_ms_per_period(data, names, marker: str):
    """Host ms a period in the spans ``names``; None unless the stretch
    holds a ``marker`` span (a program without the spans)."""
    if "window" not in data or not stretch_spans(data, {marker}):
        return None
    tot = sum(e - s for _, s, e in stretch_spans(data, names))
    return 1e3 * tot / data["profiled_periods"]


def innermost_timeline(host_events, lo: float, hi: float):
    """``[(start, end, name), ...]``: ``[lo, hi]`` cut where a program
    span opens or closes, each piece named by the innermost (latest
    opened) program span open over it, :data:`NONE` where none is."""
    evs = [(s, e, n) for n, s, e in host_events
           if is_program_span(n) and e > lo and s < hi]
    cuts = sorted({lo, hi} | {min(max(x, lo), hi)
                              for s, e, _ in evs for x in (s, e)})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        mid = 0.5 * (a + b)
        open_ = [(s, n) for s, e, n in evs if s <= mid < e]
        out.append((a, b, max(open_)[1] if open_ else NONE))
    return out


def idle_by_span(data) -> dict:
    """Seconds of the window with no device operation running, by the
    innermost program span open meanwhile (:data:`NONE`: none open).
    The values sum to the window's idle seconds."""
    lo, hi = data["window"]
    gaps = ys.idle_gaps(data["device_events"], lo, hi)
    segs = innermost_timeline(data["host_events"], lo, hi)
    tot: dict[str, float] = {}
    j = 0
    for g0, g1 in gaps:
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < g1:
            a, b, name = segs[k]
            d = min(b, g1) - max(a, g0)
            if d > 0:
                tot[name] = tot.get(name, 0.0) + d
            k += 1
    return tot


def idle_share(data, layer, marker: str):
    """Share of the window, %, with the device idle while the innermost
    program span is of ``layer`` (a predicate on its name); None unless
    the stretch holds a ``marker`` span."""
    if "window" not in data or not stretch_spans(data, {marker}):
        return None
    lo, hi = data["window"]
    tot = idle_by_span(data)
    return 100.0 * sum(v for n, v in tot.items() if layer(n)) / (hi - lo)


def stretch_counts(data, name: str):
    """The values the program counted under ``name`` inside the window
    (``repro_torch.telemetry.profiler.counts()``, stamped with
    ``time.time_ns()``, the profiler's clock); None where the program
    keeps no counts or none fell inside."""
    if "window" not in data:
        return None
    try:
        from repro_torch.telemetry.profiler import counts
    except ImportError:
        return None
    lo, hi = data["window"]
    vals = [n for nm, t, n in counts() if nm == name and lo <= t * 1e-9 < hi]
    return vals or None
