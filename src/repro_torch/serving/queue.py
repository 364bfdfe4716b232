"""Device-resident request queues: a preallocated job table per stream.

A fixed-capacity table of ``max_jobs`` job slots per stream lives on the
device, batch-first ``(S, J)``: the environment's ``trace`` (arrival,
deadline, q, model, njl) and per-job ``state`` rows, plus queue
bookkeeping (``occupied`` mask, host request ids, cumulative SLA
accumulators).

- :func:`queue_init`    allocate ``streams`` empty queues;
- :func:`queue_admit`   write up to K packed admission rows per stream
  into its lowest free slots; rows beyond the free count are *rejected*
  and reported through ``n_admitted`` so the host re-stages them;
- :func:`queue_retire`  drain completed jobs (done | missed): fold them
  into the global and per-tenant SLA accumulators, free their slots
  (arrival reset to ``INF`` hides them from ``build_slots`` and
  ``mark_drops``), and emit a fixed-shape completion record;
- :func:`queue_metrics` final metrics from the accumulators, with the
  dtypes of ``SchedulingEnv.metrics``.

``queue_init(..., telemetry=True)`` attaches a per-stream ``tele``
block (:func:`queue_telemetry_init`); ``queue_admit`` and
``queue_retire`` never touch it, the tick folds into it
(``core.serve``) and the flush surfaces it.

``queue_admit`` and ``queue_retire`` update the queue dict in place:
PyTorch tensors are mutable, and writing in place takes the role of the
JAX package's buffer donation.  A freed slot's stale per-job state is
harmless: every consumer of job rows gates on ``arrival <= t`` (INF for
free slots) or on the done/missed flags, and admission rewrites the
whole row.

:func:`pack_admissions` stages validated request rows into the fixed
``(K,)`` arrays of one stream's tick on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.sim.engine import INF
from repro_torch.sim.env import SchedulingEnv
from repro_torch.telemetry.metrics import counter_init, hist_init

I32 = torch.int32


def queue_telemetry_init(max_jobs: int, streams: int, device) -> dict:
    """Device telemetry block of ``streams`` serving queues.

    Lives as a ``"tele"`` subdict of the queue dict, so across-tick
    aggregates (a queue-depth histogram per stream, committed sub-jobs,
    tick count) accumulate on the device with no extra host transfer:
    ``depth_hist`` counts (S, 8) over edges at eighths of the capacity,
    ``committed`` and ``ticks`` (S,) int32 counters (the JAX package's
    ``queue_telemetry_init``, one row per stream)."""
    edges = [max_jobs * f for f in
             (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875)]
    return dict(depth_hist=hist_init(edges, device, shape=(streams,)),
                committed=counter_init(device=device, shape=(streams,)),
                ticks=counter_init(device=device, shape=(streams,)))


def queue_init(env: SchedulingEnv, streams: int,
               telemetry: bool = False) -> dict:
    """``streams`` empty queues for ``env`` (capacity ``cfg.max_jobs``).

    The job table doubles as the env's ``trace``/``state``: free slots
    carry ``arrival = INF`` (never active, never overdue), so
    ``env.period`` runs on the queue unchanged.  ``telemetry=True``
    attaches the :func:`queue_telemetry_init` block.
    """
    S, J, dev = streams, env.cfg.max_jobs, env.device
    trace = dict(
        arrival=torch.full((S, J), INF, dtype=torch.float32, device=dev),
        deadline=torch.full((S, J), INF, dtype=torch.float32, device=dev),
        q=torch.ones((S, J), dtype=torch.float32, device=dev),
        model=torch.zeros((S, J), dtype=torch.int64, device=dev),
        njl=torch.zeros((S, J), dtype=torch.int64, device=dev),
    )
    z = lambda *shape: torch.zeros(shape, dtype=I32, device=dev)
    qs = dict(
        trace=trace,
        state=env.init_state(trace),
        occupied=torch.zeros((S, J), dtype=torch.bool, device=dev),
        rid=torch.full((S, J), -1, dtype=I32, device=dev),
        acc=dict(admitted=z(S), rejected=z(S), counted=z(S), hits=z(S),
                 ten_counted=z(S, env.num_models),
                 ten_hit=z(S, env.num_models)),
    )
    if telemetry:
        qs["tele"] = queue_telemetry_init(J, S, dev)
    return qs


def _put(arr, target, val):
    """In place: ``arr[s, target[s, k]] = val[s, k]``; a target equal to
    the capacity J is dropped (written to a spare column)."""
    S, J = arr.shape
    ext = torch.cat([arr, arr.new_zeros((S, 1))], dim=1)
    val = torch.as_tensor(val, device=arr.device).to(arr.dtype)
    ext.scatter_(1, target, val.expand(target.shape))
    arr.copy_(ext[:, :J])


def queue_admit(env: SchedulingEnv, qs: dict, adm: dict) -> torch.Tensor:
    """Write packed admission rows into free slots, in place.

    ``adm`` holds ``model``/``arrival``/``deadline``/``q``/``rid``/
    ``valid`` tensors of shape ``(S, K)``, valid rows packed first
    (``deadline`` travels explicitly: it was computed in float64 before
    the float32 cast).  The first ``min(n_valid, n_free)`` rows land in
    the lowest-index free slots in row order; the rest are dropped and
    counted in ``acc["rejected"]``.  Returns ``n_admitted`` ``(S,)``.
    """
    J = qs["occupied"].shape[1]
    K = adm["valid"].shape[1]
    free = ~qs["occupied"]
    # stable: free slots first, each group in ascending slot order
    order = torch.argsort((~free).to(torch.uint8), dim=1, stable=True)
    k = torch.arange(K, device=free.device)
    take = adm["valid"] & (k < free.sum(1, keepdim=True))
    target = torch.where(take, torch.gather(order, 1, k.clamp(max=J - 1)
                                            .expand_as(take)), J)
    tr, st = qs["trace"], qs["state"]
    _put(tr["arrival"], target, adm["arrival"])
    _put(tr["deadline"], target, adm["deadline"])
    _put(tr["q"], target, adm["q"])
    _put(tr["model"], target, adm["model"])
    _put(tr["njl"], target, env.n_layers[adm["model"].to(torch.int64)])
    _put(st["nls"], target, 0)
    _put(st["jready"], target, adm["arrival"])
    _put(st["missed"], target, False)
    _put(st["done"], target, False)
    _put(st["hit"], target, False)
    _put(st["fjob"], target, INF)
    _put(qs["occupied"], target, True)
    _put(qs["rid"], target, adm["rid"])
    n_adm = take.sum(1).to(I32)
    acc = qs["acc"]
    acc["admitted"] += n_adm
    acc["rejected"] += adm["valid"].sum(1).to(I32) - n_adm
    return n_adm


def queue_retire(env: SchedulingEnv, qs: dict) -> dict:
    """Drain completed jobs into the accumulators and free their slots,
    in place.  Completed = occupied & (done | missed).  Returns the
    completion record: ``completed`` mask plus each slot's ``rid``/
    ``hit``/``missed``/``finish_us`` at retire time, and ``depth``."""
    st, tr, acc = qs["state"], qs["trace"], qs["acc"]
    completed = qs["occupied"] & (st["done"] | st["missed"])
    hit = st["hit"] & completed
    mhot = tr["model"][..., None] == torch.arange(env.num_models,
                                                  device=env.device)
    acc["counted"] += completed.sum(1).to(I32)
    acc["hits"] += hit.sum(1).to(I32)
    acc["ten_counted"] += (completed[..., None] & mhot).sum(1).to(I32)
    acc["ten_hit"] += (hit[..., None] & mhot).sum(1).to(I32)
    out = dict(completed=completed, rid=qs["rid"].clone(),
               hit=st["hit"].clone(), missed=st["missed"].clone(),
               finish_us=st["fjob"].clone(),
               depth=(qs["occupied"].sum(1) - completed.sum(1)).to(I32))
    tr["arrival"] = torch.where(completed, INF, tr["arrival"])
    qs["occupied"] = qs["occupied"] & ~completed
    return out


def queue_metrics(qs: dict) -> dict:
    """Episode-style metrics from the cumulative accumulators (int32
    counts, float32 rate, as ``SchedulingEnv.metrics``).  ``arrived``
    counts admissions."""
    acc = qs["acc"]
    return dict(
        hits=acc["hits"], counted=acc["counted"], arrived=acc["admitted"],
        sla_rate=(acc["hits"].to(torch.float32)
                  / torch.clamp(acc["counted"], min=1).to(torch.float32)),
        energy_uj=qs["state"]["energy"],
        rejected=acc["rejected"],
        ten_counted=acc["ten_counted"], ten_hit=acc["ten_hit"],
    )


def pack_admissions(rows, tick_k: int) -> dict[str, np.ndarray]:
    """Host-side staging: pack validated request rows into the fixed
    ``(K,)`` admission buffer of one stream's tick.

    ``rows`` is a sequence of ``(rid, model_id, arrival_us, deadline_us,
    q_us)`` tuples (at most ``tick_k``).  Stack one dict per stream and
    move it to the device to get the ``adm`` of :func:`queue_admit`.
    """
    n = len(rows)
    if n > tick_k:
        raise ValueError(f"{n} admission rows > tick_k {tick_k}")
    adm = dict(model=np.zeros((tick_k,), np.int32),
               arrival=np.full((tick_k,), INF, np.float32),
               deadline=np.full((tick_k,), INF, np.float32),
               q=np.ones((tick_k,), np.float32),
               rid=np.full((tick_k,), -1, np.int32),
               valid=np.zeros((tick_k,), bool))
    for i, (rid, mid, arr, dl, q) in enumerate(rows):
        adm["rid"][i] = rid
        adm["model"][i] = mid
        adm["arrival"][i] = arr
        adm["deadline"][i] = dl
        adm["q"][i] = q
        adm["valid"][i] = True
    return adm
