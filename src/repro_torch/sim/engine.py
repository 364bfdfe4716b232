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
  vmapped over streams.  Its event loop has no device-side ``while``:
  every iteration runs the body on all streams and commits it only
  where that stream's loop condition holds, so a stream that has
  finished is frozen exactly as the vmapped ``lax.while_loop`` freezes
  it.  The host asks whether any stream is still live only every
  ``CHECK_EVERY`` iterations (each check is a device-to-host sync).

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
import torch

from repro_torch.telemetry.profiler import count, span

INF = 1e30
_EPS = 1e-5
CHECK_EVERY = 16


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
    times, later starters may keep ``finish = INF``.
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


def _event_loop(*args, **kw):
    """The event loop of :func:`simulate` and :func:`simulate_segments`
    (:func:`_loop`) inside the span ``engine.simulate``; each host check
    of the loop's condition is the span ``engine.check``, and the count
    ``engine.iterations`` keeps the iterations run (both only while a
    profiler runs, ``telemetry.profiler``)."""
    with span("engine.simulate"):
        return _loop(*args, **kw)


def _loop(valid, assign, prio, cost, bw, dep, ready, sa_free, B, *,
          num_sas: int, stop_start_after: float | None, segments: bool):
    """``segments`` picks how the per-SA max / min over the slots
    assigned to each SA are taken: ``scatter_reduce`` over the SA index,
    or a masked reduction over the ``(S, n, M)`` one-hot."""
    S, n = valid.shape
    M = num_sas
    dev = valid.device
    f32 = torch.float32
    max_iters = 3 * n + M + 16
    valid = valid.to(torch.bool)
    assign = assign.to(torch.int64)
    prio = prio.to(f32)
    cost = cost.to(f32)
    bw = bw.to(f32)
    dep = dep.to(torch.int64)
    ready = ready.to(f32)
    sa_free = sa_free.to(f32)
    B = torch.as_tensor(B, dtype=f32, device=dev).expand(S)[:, None]
    idx = torch.arange(n, device=dev)
    # loop invariants: the per-SA reductions (busy SAs, each SA's best
    # score, each SA's lowest starting slot), tie-broken scores, the
    # per-slot time its SA becomes free, the dependency gather index
    if segments:
        def per_sa(x, fill, how):
            return torch.full((S, M), fill, dtype=x.dtype,
                              device=dev).scatter_reduce(1, assign, x, how)
        sa_busy = lambda active: per_sa(active.to(torch.int32), 0,
                                        "amax") > 0
        sa_best = lambda score: per_sa(score, -INF, "amax")
        sa_first = lambda starts: per_sa(torch.where(starts, idx, n), n,
                                         "amin")
    else:
        onehot = assign[..., None] == torch.arange(M, device=dev)
        sa_busy = lambda active: (active[..., None] & onehot).any(1)
        sa_best = lambda score: torch.where(onehot, score[..., None],
                                            -INF).amax(1)
        sa_first = lambda starts: torch.where(starts[..., None] & onehot,
                                              idx[:, None], n).amin(1)
    prio_tb = prio - idx.to(f32) * 1e-6
    enab_static = torch.maximum(torch.gather(sa_free, 1, assign), ready)
    has_dep = dep >= 0
    dep_idx = dep.clamp(min=0)
    stop = INF if stop_start_after is None else float(stop_start_after)

    it = torch.zeros((S,), dtype=torch.int64, device=dev)
    t = torch.zeros((S,), dtype=f32, device=dev)
    started = torch.zeros((S, n), dtype=torch.bool, device=dev)
    finished = torch.zeros_like(started)
    progress = torch.zeros((S, n), dtype=f32, device=dev)
    start = torch.full((S, n), INF, dtype=f32, device=dev)
    finish = torch.full_like(start, INF)

    def cond():
        live = (valid & ~finished).any(1)
        early_open = (valid & started & (start < stop) & ~finished).any(1)
        return (it < max_iters) & live & ((t < stop) | early_open)

    for i in range(max_iters):
        go = cond()
        if i % CHECK_EVERY == 0:
            with span("engine.check"):
                live = bool(go.any())
            if not live:
                break
        tc = t[:, None]
        active = started & ~finished & valid
        dep_done = ~has_dep | torch.gather(finished, 1, dep_idx)
        # ---- start phase: per-SA best ready candidate on idle SAs
        sa_open = ~sa_busy(active) & (sa_free <= tc + _EPS)
        cand = (valid & ~started & dep_done & (ready <= tc + _EPS)
                & torch.gather(sa_open, 1, assign))
        score = torch.where(cand, prio_tb, -INF)
        best = sa_best(score)
        starts_now = (cand & (score >= torch.gather(best, 1, assign) - 1e-9)
                      & (score > -INF / 2))
        # guard against float ties admitting 2 SJs on one SA: lowest idx
        first_idx = sa_first(starts_now)
        starts_now = starts_now & (idx == torch.gather(first_idx, 1, assign))
        n_started = started | starts_now
        n_start = torch.where(starts_now, tc, start)
        active = active | starts_now
        # ---- next event (tolerance scales with |t|, as in simulate_jax)
        tol = _EPS + 4e-6 * tc
        D = torch.where(active, bw, 0.0).sum(1, keepdim=True)
        rho = torch.where(D > B, B / torch.clamp(D, min=1e-9), 1.0)
        rem = torch.where(active, torch.clamp(cost - progress, min=0.0)
                          / torch.clamp(rho, min=1e-12), INF)
        t_fin = tc + torch.maximum(rem.amin(1, keepdim=True), tol)
        pend = valid & ~n_started & dep_done
        enab = torch.where(pend & (enab_static > tc + _EPS), enab_static, INF)
        next_t = torch.minimum(t_fin, enab.amin(1, keepdim=True))
        next_t = torch.where(torch.isfinite(next_t) & (next_t < INF / 2),
                             next_t, tc)
        # ---- progress update
        dt = next_t - tc
        n_progress = torch.where(active, progress + dt * rho, progress)
        done = active & (n_progress >= cost - tol)
        n_finish = torch.where(done, next_t, finish)
        n_finished = finished | done
        # ---- commit only where the stream's loop condition held
        g = go[:, None]
        started = torch.where(g, n_started, started)
        start = torch.where(g, n_start, start)
        progress = torch.where(g, n_progress, progress)
        finish = torch.where(g, n_finish, finish)
        finished = torch.where(g, n_finished, finished)
        t = torch.where(go, next_t[:, 0], t)
        it = it + go.to(torch.int64)
    else:
        i = max_iters
    count("engine.iterations", i)
    return start, finish
