"""Serving ticks: one scheduling period across every stream at once.

The counterpart of the JAX package's ``core/serve.py``.  A tick advances
``S`` independent serving queues one period each:

    admit (up to K staged requests per stream into free slots)
      -> one actor (or heuristic) pass over every pending sub-job of
         every stream, then the contention engine (``env.period`` with
         ``commit_only=True``: the transition is never built)
      -> retire (drain completed jobs into the SLA accumulators)

All of it runs on the env's device over the leading stream axis; the
host stages ``(S, K)`` admission rows in and reads a fixed-shape
completion record out.  The queue dict is updated in place.

The specialist and generalist actors run at sigma 0 and the
heuristics draw nothing, so a tick takes no random key.

A queue dict with a ``tele`` block (``queue_init(..., telemetry=True)``)
also folds the tick's depth, committed sub-jobs and tick count into it
(``serving.telemetry``); the flush surfaces the block as flat
``tele_*`` leaves.  The block only reads what the tick computes, so a
queue without it runs the same ops otherwise.  The tick's phases are
spans (``telemetry.profiler.span``: ``torch.profiler`` ranges while a
profiler runs) under the JAX package's scope names: ``serving.admit``,
``serving.period``, ``serving.retire``, ``serving.telemetry``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.serving.queue import (queue_admit, queue_metrics,
                                       queue_retire)
from repro_torch.sim.env import SchedulingEnv
from repro_torch.telemetry.metrics import counter_add, hist_add
from repro_torch.telemetry.profiler import span


def specialist_act(actor):
    """Deterministic RELMAS actor: priority = a[..., 0], SA = argmax of
    the remaining channels (the sigma-0 policy period)."""
    def act(feats, mask, slots, st):
        a = actor(feats, mask)
        return a, a[..., 0], torch.argmax(a[..., 1:], dim=-1)
    return act


def generalist_act(env, actor):
    """Descriptor-conditioned actor on a padded env at sigma 0: the
    function of ``generalist.make_generalist_period`` at sigma 0 (the
    same clip and channel mask; a zero block adds nothing), with the
    serving actor's ``lstm_seq`` route: one launch per tick."""
    from repro_torch.core.generalist.features import generalist_act_fn
    seq_cfg = dataclasses.replace(actor.cfg, use_pallas=True)
    fn = generalist_act_fn(actor.params(), seq_cfg, env.descriptors,
                           env.sa_mask)

    def act(feats, mask, slots, st):
        return fn(feats, mask, slots, st, None)
    return act


def baseline_act(env, baseline_fn):
    """Heuristic baselines act on raw slot data."""
    def act(feats, mask, slots, st):
        return baseline_fn(slots, st, env)
    return act


def build_act(env, kind: str, actor=None, baseline_fn=None):
    if kind == "specialist":
        if actor is None:
            raise ValueError("kind='specialist' needs an actor")
        return specialist_act(actor)
    if kind == "heuristic":
        if baseline_fn is None:
            raise ValueError("kind='heuristic' needs baseline_fn")
        return baseline_act(env, baseline_fn)
    if kind == "generalist":
        if actor is None:
            raise ValueError("kind='generalist' needs an actor")
        return generalist_act(env, actor)
    raise ValueError(f"unknown serving policy kind {kind!r}")


def make_serving_tick(env: SchedulingEnv, *, kind: str = "specialist",
                      actor=None, baseline_fn=None):
    """Build ``tick(queues, adm) -> out``.

    ``queues`` is a :func:`~repro_torch.serving.queue.queue_init` dict
    (updated in place), ``adm`` the ``(S, K)`` admission tensors.
    ``out`` holds the retire record (``completed``/``rid``/``hit``/
    ``missed``/``finish_us``/``depth``), ``n_admitted``, the period's
    committed-SJ count and the post-tick clock ``t_us``, per stream.
    """
    act = build_act(env, kind, actor, baseline_fn)

    @torch.no_grad()
    def tick(queues, adm):
        with span("serving.admit"):
            n_adm = queue_admit(env, queues, adm)
        # commit_only: the transition is discarded, so the engine may
        # stop at the period-boundary start horizon
        with span("serving.period"):
            state, _, info = env.period(queues["state"], queues["trace"],
                                        act, commit_only=True)
        queues["state"] = state
        with span("serving.retire"):
            out = queue_retire(env, queues)
        out.update(n_admitted=n_adm, committed=info["committed"],
                   t_us=state["t"])
        if "tele" in queues:
            # new tensors, never written into what the tick returns
            with span("serving.telemetry"):
                t = queues["tele"]
                queues["tele"] = dict(
                    depth_hist=hist_add(t["depth_hist"], out["depth"]),
                    committed=counter_add(t["committed"], info["committed"]),
                    ticks=counter_add(t["ticks"], 1))
        return out

    return tick


def make_serving_flush(env: SchedulingEnv):
    """End-of-stream drain: a final drop pass at the current clock, one
    last retire, and the cumulative metrics.  Returns
    ``flush(queues) -> out`` (retire record + :func:`queue_metrics`, and
    with a ``tele`` block its flat leaves ``tele_depth_hist`` (S, 8),
    ``tele_depth_edges`` (S, 7), ``tele_committed`` and ``tele_ticks``
    (S,): flat, so the host moves ``out`` leaf by leaf)."""

    @torch.no_grad()
    def flush(queues):
        queues["state"] = env.mark_drops(queues["state"], queues["trace"],
                                         queues["state"]["t"])
        out = queue_retire(env, queues)
        out.update(queue_metrics(queues))
        if "tele" in queues:
            t = queues["tele"]
            S = t["ticks"].shape[0]
            out.update(tele_depth_hist=t["depth_hist"]["counts"],
                       tele_depth_edges=t["depth_hist"]["edges"].expand(
                           S, -1),
                       tele_committed=t["committed"], tele_ticks=t["ticks"])
        return out

    return flush
