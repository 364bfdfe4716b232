"""Batched rollout / eval runners for the fleet-conditioned policy.

A thin layer over ``repro_torch.core.rollout``: the same period loop
over the leading episode axis, with the descriptor-conditioned act_fn of
``repro_torch.core.generalist.features`` swapped in.  One generalist
parameter set evaluates on any
:class:`~repro_torch.core.generalist.env.PaddedEnv`: the env's own
``descriptors`` / ``sa_mask`` condition the policy.
"""
from __future__ import annotations

import os

import torch

from repro_torch.ckpt import read_checkpoint_meta, restore_checkpoint
from repro_torch.core import policy as P
from repro_torch.core.generalist.env import PaddedEnv
from repro_torch.core.generalist.features import (GeneralistSpec,
                                                  generalist_act_fn)
from repro_torch.core.rollout import (_eval_churn_schedules, _means,
                                      collect_episodes, stack_episodes)
from repro_torch.costmodel.descriptors import DESC_DIM
from repro_torch.device import resolve_device
from repro_torch.telemetry.console import console_line

Metrics = dict[str, torch.Tensor]


def collect_generalist(env: PaddedEnv, pcfg: P.PolicyConfig, params,
                       states, traces, gen, sigma, desc, sa_mask,
                       collect: bool = True, churn=None, noise=None):
    """The generalist counterpart of ``rollout.collect_episodes``:
    exploration noise at the padded env's ``1 + M_max`` action width
    (drawn from ``gen`` or passed in as ``noise``), padding channels masked
    after the clip; ``desc`` / ``sa_mask`` are the fleet's (a multi-fleet
    round passes the sampled fleet's); ``churn`` a compiled schedule
    with ``(batch, periods, M_max)`` leaves."""
    return collect_episodes(
        env, pcfg, params, states, traces, gen, sigma, collect,
        noise=noise, act_fn=generalist_act_fn(params, pcfg, desc, sa_mask),
        churn=churn)


def make_generalist_evaluate_batch(env: PaddedEnv, pcfg: P.PolicyConfig):
    """``eval_fn(params, states, traces, churn_scheds=None)`` -> metrics
    stacked over the batch axis, conditioned on the env's descriptors
    and mask, under a compiled churn schedule when given."""
    @torch.no_grad()
    def eval_fn(params, states, traces, churn_scheds=None) -> Metrics:
        *_, metrics = env.episode(
            states, traces,
            generalist_act_fn(params, pcfg, env.descriptors, env.sa_mask),
            collect=False, churn=churn_scheds)
        return metrics
    return eval_fn


def evaluate_generalist_batch(env: PaddedEnv, pcfg: P.PolicyConfig,
                              params, seeds, arrivals=None,
                              churn=None) -> dict[str, float]:
    """Mean generalist metrics across seeds; ``churn`` threads the
    deterministic per-seed schedules drawn over the fleet's *real* SAs
    and compiled at ``m_max`` width."""
    traces, states = stack_episodes(env, seeds, arrivals)
    return _means(make_generalist_evaluate_batch(env, pcfg)(
        params, states, traces,
        None if churn is None else _eval_churn_schedules(env, churn, seeds)))


def make_generalist_period(env: PaddedEnv, pcfg: P.PolicyConfig):
    """One period with the generalist actor, the counterpart of the JAX
    ``make_generalist_period``: ``period(params, state, trace, gen=None,
    sigma=0.0)`` -> ``(new_state, transition, info)``; at ``sigma > 0``
    the actions get ``sigma`` times standard-normal noise from ``gen``
    (at sigma 0 a zero block, through the same clip and mask)."""
    @torch.no_grad()
    def period(params, state, trace, gen=None, sigma: float = 0.0):
        shape = (state["t"].shape[0], env.cfg.max_rq, pcfg.act_dim)
        noise = (sigma * torch.randn(shape, generator=gen,
                                     device=env.device)
                 if sigma > 0.0 else torch.zeros(shape, device=env.device))
        act = generalist_act_fn(params, pcfg, env.descriptors, env.sa_mask)
        return env.period(state, trace,
                          lambda feats, mask, slots, st: act(
                              feats, mask, slots, st, noise))
    return period


def restore_spec(meta: dict) -> GeneralistSpec:
    """Rebuild the policy's fleet-independent shape from ckpt meta."""
    return GeneralistSpec(m_max=int(meta["m_max"]),
                          desc_dim=int(meta.get("desc_dim", DESC_DIM)))


def load_generalist_checkpoint(ckpt_dir: str | None, *,
                               min_num_sas: int = 0,
                               default_hidden: int = 64,
                               device: str | torch.device = "cuda"):
    """Restore a generalist actor checkpoint (the JAX package's or this
    package's: the format is shared, ``repro_torch.ckpt``).

    Returns ``(params, pcfg, spec, restored)`` when ``ckpt_dir`` holds a
    generalist checkpoint (``policy_kind: "generalist"`` in its meta)
    wide enough for ``min_num_sas``: ``params`` a dict of tensors on
    ``device``; ``restored`` False when the meta matched but the weights
    did not (``params`` are then the untrained init of that
    architecture, seed 0).  Returns None when the directory holds no
    usable generalist checkpoint.
    """
    if not ckpt_dir or not os.path.isdir(ckpt_dir):
        return None
    meta = read_checkpoint_meta(ckpt_dir)
    if (meta or {}).get("policy_kind") != "generalist" \
            or int(meta["m_max"]) < min_num_sas:
        return None
    dev = resolve_device(device)
    spec = restore_spec(meta)
    pcfg = spec.pcfg(hidden=int(meta.get("hidden", default_hidden)))
    restored = True
    try:
        tree, _, _ = restore_checkpoint(ckpt_dir)
        arrays = P.checked_numpy(tree, P.net_shapes(pcfg.feat_dim,
                                                    pcfg.hidden,
                                                    pcfg.act_dim))
        params = P.tree_to_device(arrays, dev)
    except (ValueError, KeyError, FileNotFoundError) as e:
        console_line(f"[generalist] checkpoint in {ckpt_dir} matched but "
                     f"failed to restore ({e}); params are untrained")
        params = P.init_actor(torch.Generator().manual_seed(0), pcfg, dev)
        restored = False
    return params, pcfg, spec, restored
