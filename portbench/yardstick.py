"""The benchmark's arithmetic: the card's published peaks, the operations
and bytes of the ``lstm_seq`` kernel, percentiles, and the reduction of
a profiler trace to busy time, idle gaps and per-name device time.

It lives with the benchmark so that a change to the program cannot move
the yardstick.  Nothing here imports the program.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit.
# The actor runs in float32 with TF32 off, so its peak is the float32
# rate outside the tensor cores.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def lstm_seq_flops(live_steps: int, feat: int, hidden: int) -> int:
    """Gate products of the steps the inputs need: ``2 (F + H) 4H`` per
    unmasked (step, row).  The port's formula
    (``kernels/lstm_seq/ops.py::flops``) counts every step of every row;
    a masked step keeps its carry and needs no product, and the kernel
    stops each tile at its last live step, so only live steps count."""
    return 2 * live_steps * (feat + hidden) * 4 * hidden


def lstm_seq_bytes(steps: int, rows: int, live_steps: int, feat: int,
                   hidden: int) -> int:
    """Bytes the call needs: the live rows of ``xs`` (float32), the mask
    (one byte a step and row), the weights ``wx``, ``wh``, ``b`` read
    once, and ``hs`` (T, B, H) float32 written once (the port's
    ``bytes_moved`` with ``xs`` counted by live steps)."""
    weights = (feat * 4 * hidden + hidden * 4 * hidden + 4 * hidden) * 4
    return (live_steps * feat * 4 + steps * rows + weights
            + steps * rows * hidden * 4)


def heads_flops(valid_slots: int, hidden: int, act_dim: int) -> int:
    """The actor's two dense heads on the slots the scheduler reads:
    ``2 (H * H/2 + H/2 * G)`` per valid slot."""
    return 2 * valid_slots * (hidden * (hidden // 2)
                              + (hidden // 2) * act_dim)


def least_seconds(flops: float, nbytes: float) -> float:
    """Roofline time: the larger of operations at the float32 peak and
    bytes at the HBM rate."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default method)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def merge_intervals(intervals):
    """Sorted, disjoint union of ``(start, end)`` pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip_intervals(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def busy_seconds(device_events, lo: float, hi: float) -> float:
    """Seconds of ``[lo, hi]`` in which some device operation ran: the
    union of the operations' intervals (``(name, start, end)``, seconds)
    clipped to the window."""
    merged = merge_intervals(clip_intervals(
        [(s, e) for _, s, e in device_events], lo, hi))
    return sum(e - s for s, e in merged)


def idle_gaps(device_events, lo: float, hi: float):
    """The gaps of ``[lo, hi]`` in which no device operation ran."""
    merged = merge_intervals(clip_intervals(
        [(s, e) for _, s, e in device_events], lo, hi))
    gaps, t = [], lo
    for s, e in merged:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def device_time_by_name(device_events, lo: float, hi: float,
                        top: int = 10):
    """``[[name, seconds], ...]``: device time per operation name inside
    the window, the largest ``top``."""
    tot: dict[str, float] = {}
    for name, s, e in device_events:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            tot[name] = tot.get(name, 0.0) + (e - s)
    return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:top]]


def gaps_by_host_op(gaps, host_events, top: int = 10):
    """``[[name, seconds], ...]``: idle device time summed by the
    innermost host range (``(name, start, end)``) that was open when each
    gap began; ``"(none)"`` where none was.  The largest ``top``."""
    evs = sorted(host_events, key=lambda ev: (ev[1], -ev[2]))
    tot: dict[str, float] = {}
    stack: list = []
    i = 0
    for g0, g1 in sorted(gaps):
        while i < len(evs) and evs[i][1] <= g0:
            stack.append(evs[i])
            i += 1
        stack = [ev for ev in stack if ev[2] > g0]
        name = max(stack, key=lambda ev: ev[1])[0] if stack else "(none)"
        tot[name] = tot.get(name, 0.0) + (g1 - g0)
    return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:top]]
