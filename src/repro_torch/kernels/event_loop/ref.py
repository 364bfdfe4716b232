"""Plain PyTorch version of the event-loop kernel: the contention
engine's event loop in eager PyTorch over a leading stream axis, which
``sim/engine.py`` runs on CPU tensors (and, with ``segments``, as its
segment engine) and which the tests hold the kernel to on the card."""
from __future__ import annotations

import torch

from repro_torch.telemetry.profiler import count, span

INF = 1e30
_EPS = 1e-5
CHECK_EVERY = 16


def loop(valid, assign, prio, cost, bw, dep, ready, sa_free, B, *,
         num_sas: int, stop_start_after: float | None, segments: bool):
    """The event loop with ``engine.simulate``'s arguments.  Eager
    PyTorch has no device-side ``while``: every iteration runs the body
    on all streams and commits it only where that stream's loop
    condition holds, so a stream that has finished is frozen exactly as
    the vmapped ``lax.while_loop`` freezes it.  The host asks whether
    any stream is still live only every ``CHECK_EVERY`` iterations (each
    check is a device-to-host sync, the span ``engine.check``); the
    count ``engine.iterations`` is the batch's iterations.

    ``segments`` picks how the per-SA max / min over the slots assigned
    to each SA are taken: ``scatter_reduce`` over the SA index, or a
    masked reduction over the ``(S, n, M)`` one-hot.  Returns
    ``(start, finish, it)``, ``it`` ``(S,)`` the iterations each stream
    committed."""
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
    return start, finish, it


def event_loop_ref(valid, assign, prio, cost, bw, dep, ready, sa_free,
                   b_stream, b_all, num_sas, stop):
    """The operator's arguments (``b_stream`` an ``(S,)`` bandwidth or
    None for ``b_all`` on every stream, ``stop`` the early exit's horizon
    or ``INF``) -> ``(start, finish, iters)``, ``iters`` each stream's
    iterations as int32."""
    start, finish, it = loop(
        valid, assign, prio, cost, bw, dep, ready, sa_free,
        b_all if b_stream is None else b_stream, num_sas=num_sas,
        stop_start_after=stop, segments=False)
    return start, finish, it.to(torch.int32)
