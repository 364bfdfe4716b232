"""Bandwidth-contention schedule executor.

Semantics (paper Sec. 3):
- Each sub-accelerator (SA) executes one sub-job (SJ) at a time,
  non-preemptively, in descending priority order among *ready* SJs
  (ready = predecessor finished, ready-time reached, SA idle).
- All SJs active at an instant share the off-chip bandwidth ``B``. When
  total demand ``D = sum(b_i) > B``, every active SJ progresses at the
  uniform rate ``rho = B / D`` — each demands bandwidth proportional to
  its requirement and all overlapping SJs suffer the *same stall
  cycles*, exactly the contention model of the paper.
- Time advances event-by-event (finish events + enabling times).

Two implementations with identical semantics:
- ``simulate_np`` — float64 NumPy oracle, one schedule at a time.
- ``simulate``    — float32 PyTorch engine over a leading stream axis
  ``(S, n)``, the counterpart of the JAX package's ``simulate_jax``
  vmapped over streams.  On CUDA tensors its event loop is one
  hand-written kernel, ``kernels/event_loop``: a warp a stream, each
  looping on its own stream's condition until that stream is done, with
  no host check.  On CPU tensors it is the kernel's plain twin in eager
  PyTorch, ``kernels/event_loop/ref.py::loop`` (here :func:`_loop`).

``simulate_segments`` is the same loop with the per-SA reductions
written as segment reductions (``scatter_reduce`` over the SA index)
instead of the ``(S, n, M)`` one-hot: the counterpart of the JAX
package's ``simulate_jax_segments``, the seed engine that its rollout
benchmark times as the "before" arm.  It takes ``simulate``'s
signature, so a caller swaps it in at module level
(``engine.simulate = engine.simulate_segments``: ``SchedulingEnv``
reads ``engine.simulate`` at call time).

Times are in microseconds, bandwidths in GB/s.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.event_loop import ops as event_loop_ops
from repro_torch.kernels.event_loop.ref import INF, _EPS
from repro_torch.kernels.event_loop.ref import loop as _loop
from repro_torch.telemetry.profiler import count, profiling, span


# --------------------------------------------------------------------------
# NumPy oracle
# --------------------------------------------------------------------------
def simulate_np(valid, assign, prio, cost, bw, dep, ready, sa_free, B):
    """Run the ready queue to completion. Returns (start, finish) float64.

    valid:  (n,) bool   slot holds a real SJ
    assign: (n,) int    SA index per SJ
    prio:   (n,) float  higher runs first (tie: lower slot index)
    cost:   (n,) float  contention-free execution time on assigned SA (us)
    bw:     (n,) float  bandwidth demand on assigned SA (GB/s)
    dep:    (n,) int    predecessor slot (-1 = none)
    ready:  (n,) float  earliest start time (us, external constraints)
    sa_free:(M,) float  time each SA becomes idle
    B:      float       shared DRAM bandwidth (GB/s)
    """
    valid = np.asarray(valid, bool)
    assign = np.asarray(assign, np.int64)
    prio = np.asarray(prio, np.float64)
    cost = np.asarray(cost, np.float64)
    bw = np.asarray(bw, np.float64)
    dep = np.asarray(dep, np.int64)
    ready = np.asarray(ready, np.float64)
    sa_free = np.asarray(sa_free, np.float64).copy()
    n, M = len(valid), len(sa_free)

    started = np.zeros(n, bool)
    finished = np.zeros(n, bool)
    progress = np.zeros(n)
    start = np.full(n, INF)
    finish = np.full(n, INF)
    t = 0.0

    def dep_ok():
        ok = dep < 0
        has = ~ok
        ok[has] = finished[dep[has]]
        return ok

    for _ in range(2 * n + M + 8):
        if not (valid & ~finished).any():
            break
        # ---- start phase: each idle SA admits its best ready candidate
        active = started & ~finished & valid
        for m in range(M):
            if t + _EPS < sa_free[m] or (active & (assign == m)).any():
                continue
            cand = valid & ~started & (assign == m) & dep_ok() & (ready <= t + _EPS)
            if cand.any():
                idxs = np.flatnonzero(cand)
                # identical scoring rule as the JAX engine: priorities are
                # tie-broken by slot index at 1e-6 granularity
                score = prio[idxs] - idxs * 1e-6
                i = idxs[np.argmax(score)]
                started[i] = True
                start[i] = t
                active[i] = True
        # ---- advance to next event
        next_t = INF
        if active.any():
            D = bw[active].sum()
            rho = min(1.0, B / D) if D > 0 else 1.0
            rem = (cost[active] - progress[active]) / max(rho, 1e-12)
            next_t = t + max(rem.min(), 0.0)
        else:
            rho = 1.0
        # enabling times (SA becoming free per config, or SJ ready-times)
        pend = valid & ~started & dep_ok()
        if pend.any():
            enab = np.maximum(sa_free[assign[pend]], ready[pend])
            enab = enab[enab > t + _EPS]
            if enab.size:
                next_t = min(next_t, enab.min())
        if next_t >= INF:
            break  # nothing can make progress (should not happen)
        if active.any():
            progress[active] += (next_t - t) * rho
            done = active & (progress >= cost - _EPS)
            finish[done] = next_t
            finished |= done
        t = next_t
    return start, finish


def commit_period_np(start, finish, valid, assign, t_s, num_sas):
    """Split a simulated schedule at the period boundary ``t_s`` (a copy
    of the JAX package's NumPy helper).

    Committed = SJs that *started* before t_s (non-preemptive: they run to
    completion).  Returns (committed mask, residual mask, new sa_free
    relative to the next period start).
    """
    committed = valid & (start < t_s)
    residual = valid & ~committed
    sa_free = np.zeros(num_sas)
    for m in range(num_sas):
        f = finish[committed & (assign == m)]
        if f.size:
            sa_free[m] = max(0.0, f.max() - t_s)
    return committed, residual, sa_free


# --------------------------------------------------------------------------
# PyTorch engine (batched over streams)
# --------------------------------------------------------------------------
def simulate(valid, assign, prio, cost, bw, dep, ready, sa_free, B, *,
             num_sas: int, stop_start_after: float | None = None):
    """Batched float32 engine. All per-SJ inputs are ``(S, n)``,
    ``sa_free`` is ``(S, M)``, ``B`` a float or ``(S,)``.
    Returns ``(start, finish)``, each ``(S, n)`` float32.

    Stream ``s`` follows the same event sequence as the JAX package's
    ``simulate_jax`` on row ``s``: the loop state advances only where the
    stream's condition holds (``it < max_iters``, some valid SJ
    unfinished, and, with ``stop_start_after``, the clock short of the
    horizon or an early starter still owed a finish), up to the same
    bound ``max_iters = 3n + M + 16``.  Freezing a stream whose
    condition failed is exact: its state no longer changes, so its
    condition stays false.  ``stop_start_after`` is the serving tick's
    early exit: SJs that start before it get exact start and finish
    times, later starters may keep ``finish = INF``.  CUDA tensors take
    at most 256 slots on 32 SAs (the event-loop kernel's limits; beyond
    them a ValueError), CPU tensors any shape.
    """
    return _event_loop(valid, assign, prio, cost, bw, dep, ready, sa_free,
                       B, num_sas=num_sas, stop_start_after=stop_start_after,
                       segments=False)


def simulate_segments(valid, assign, prio, cost, bw, dep, ready, sa_free, B,
                      *, num_sas: int, stop_start_after: float | None = None):
    """:func:`simulate` with its per-SA reductions (busy SAs, each SA's
    best candidate, the lowest tied slot) as ``scatter_reduce`` over the
    SA index, the counterpart of the JAX package's
    ``simulate_jax_segments``.  The same event sequence, so the same
    start and finish times.  As in the reference, the serving-only
    ``stop_start_after`` early exit is not implemented: any value other
    than None raises before any work."""
    if stop_start_after is not None:
        raise ValueError("simulate_segments has no stop_start_after "
                         "early exit (legacy engine; training/benchmark "
                         "paths only)")
    return _event_loop(valid, assign, prio, cost, bw, dep, ready, sa_free,
                       B, num_sas=num_sas, stop_start_after=None,
                       segments=True)


def _event_loop(valid, assign, prio, cost, bw, dep, ready, sa_free, B, *,
                num_sas: int, stop_start_after: float | None,
                segments: bool):
    """The event loop of :func:`simulate` and :func:`simulate_segments`
    inside the span ``engine.simulate``, routed on the device alone:
    :func:`simulate`'s CUDA tensors run the kernel (which raises a
    ValueError naming its limits for a shape it does not take), CPU
    tensors and the segment engine :func:`_loop`.  The count
    ``engine.kernel`` is 1 a call on the kernel and 0 on :func:`_loop`;
    ``engine.iterations`` keeps the iterations run: on :func:`_loop` the
    batch's (each host check of its condition is the span
    ``engine.check``), on the kernel the most any stream ran, read back
    inside one ``engine.check``.  Spans, counts and that read-back
    happen only while a profiler runs (``telemetry.profiler``), so an
    untraced kernel call never syncs."""
    args = (valid, assign, prio, cost, bw, dep, ready, sa_free, B)
    with span("engine.simulate"):
        if not segments and valid.device.type == "cuda":
            count("engine.kernel", 1)
            start, finish, iters = event_loop_ops.event_loop(
                *args, num_sas=num_sas, stop_start_after=stop_start_after)
            if profiling() and iters.numel():
                with span("engine.check"):
                    count("engine.iterations", int(iters.max()))
            return start, finish
        count("engine.kernel", 0)
        start, finish, _ = _loop(*args, num_sas=num_sas,
                                 stop_start_after=stop_start_after,
                                 segments=segments)
        return start, finish
