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
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.serving.queue import (queue_admit, queue_metrics,
                                       queue_retire)
from repro_torch.sim.env import SchedulingEnv


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
        n_adm = queue_admit(env, queues, adm)
        state, _, info = env.period(queues["state"], queues["trace"], act,
                                    commit_only=True)
        queues["state"] = state
        out = queue_retire(env, queues)
        out.update(n_admitted=n_adm, committed=info["committed"],
                   t_us=state["t"])
        return out

    return tick


def make_serving_flush(env: SchedulingEnv):
    """End-of-stream drain: a final drop pass at the current clock, one
    last retire, and the cumulative metrics.  Returns
    ``flush(queues) -> out`` (retire record + :func:`queue_metrics`)."""

    @torch.no_grad()
    def flush(queues):
        queues["state"] = env.mark_drops(queues["state"], queues["trace"],
                                         queues["state"]["t"])
        out = queue_retire(env, queues)
        out.update(queue_metrics(queues))
        return out

    return flush
