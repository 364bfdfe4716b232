"""Episode rollout runners: batched collection and evaluation.

The counterpart of the JAX package's ``core/rollout.py``.  One call runs
``batch`` episodes end to end on the env's device: the period loop of
:meth:`SchedulingEnv.episode` over the leading stream axis (the JAX
package's ``lax.scan`` inside ``vmap``), with the final drop pass and
the metrics.  Collection returns transitions shaped
``(batch, periods, ...)``, ready for the replay buffer.

The whole batch's exploration noise is one ``(batch, periods, max_rq,
G)`` standard-normal block drawn up front from a ``torch.Generator``
(or passed in), as the JAX package draws it from one key.  The
``make_*`` functions return callables, as the JAX ones return jitted
runners; here there is nothing to compile, so nothing is cached.
Everything runs under ``torch.no_grad``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core import policy as P
from repro_torch.sim.arrivals import generate_trace
from repro_torch.sim.env import SchedulingEnv

Metrics = dict[str, torch.Tensor]


def _policy_act_fn(params, pcfg: P.PolicyConfig):
    """Per-period actor; ``noise`` (the period's slice of the episode
    block, already scaled by sigma, or None) is added to the actions,
    which are then clipped to [-1, 1]."""
    def act_fn(feats, mask, slots, st, noise):
        a = P.actor_apply(params, pcfg, feats, mask)
        if noise is not None:
            a = torch.clamp(a + noise, -1.0, 1.0)
        return a, a[..., 0], torch.argmax(a[..., 1:], dim=-1)
    return act_fn


def noise_block(env: SchedulingEnv, batch: int,
                gen: torch.Generator) -> torch.Tensor:
    """Standard-normal exploration noise (batch, periods, max_rq, G)."""
    return torch.randn((batch, env.cfg.periods, env.cfg.max_rq,
                        env.act_dim), generator=gen, device=env.device)


@torch.no_grad()
def collect_episodes(env: SchedulingEnv, pcfg: P.PolicyConfig, params,
                     states, traces, gen: torch.Generator | None, sigma,
                     collect: bool = True, noise=None):
    """Batched policy collection: ``sigma`` times one standard-normal
    noise block (``noise`` if given, else drawn from ``gen``), then
    every episode through ``env.episode``.  Returns ``(final_states,
    transitions, infos, metrics)``."""
    if noise is None:
        noise = noise_block(env, states["t"].shape[0], gen)
    return env.episode(states, traces, _policy_act_fn(params, pcfg),
                       aux=sigma * noise, collect=collect)


def make_rollout_batch(env: SchedulingEnv, pcfg: P.PolicyConfig,
                       collect: bool = True):
    """``rollout_batch(params, states, traces, gen, sigma)`` ->
    (final_states, transitions, infos, metrics), stacked over the
    leading batch axis (transitions over (batch, periods, ...))."""
    def rollout_batch(params, states, traces, gen, sigma):
        return collect_episodes(env, pcfg, params, states, traces, gen,
                                sigma, collect)
    return rollout_batch


def make_evaluate_batch(env: SchedulingEnv, pcfg: P.PolicyConfig):
    """``eval_fn(params, states, traces)`` -> metrics stacked over the
    batch axis (no noise, no transitions kept)."""
    @torch.no_grad()
    def eval_fn(params, states, traces) -> Metrics:
        *_, metrics = env.episode(states, traces,
                                  _policy_act_fn(params, pcfg),
                                  collect=False)
        return metrics
    return eval_fn


def make_baseline_episode_batch(env: SchedulingEnv, baseline_fn: Callable):
    """``eval_fn(states, traces)`` -> metrics for a heuristic baseline
    ``baseline_fn(slots, state, env)`` (FCFS-H, PREMA-H, Herald; they
    draw nothing, so no key is threaded)."""
    @torch.no_grad()
    def eval_fn(states, traces) -> Metrics:
        def act_fn(feats, mask, slots, st, aux):
            return baseline_fn(slots, st, env)
        *_, metrics = env.episode(states, traces, act_fn, collect=False)
        return metrics
    return eval_fn


def stack_episodes(env: SchedulingEnv, seeds, arrivals=None):
    """One fresh episode per seed (NumPy ``default_rng(seed)``, as the JAX
    package's ``new_episode``), stacked over the batch axis."""
    trs = [generate_trace(env.min_lat, arrivals or env.arrivals,
                          np.random.default_rng(int(s))) for s in seeds]
    traces = env.to_trace({k: np.stack([t[k] for t in trs])
                           for k in trs[0]})
    return traces, env.init_state(traces)


def _means(metrics: Metrics) -> dict[str, float]:
    return {k: float(v.double().mean()) for k, v in metrics.items()}


def evaluate_batch(env: SchedulingEnv, pcfg: P.PolicyConfig, params,
                   seeds, arrivals=None) -> dict[str, float]:
    """Mean policy metrics across seeds."""
    traces, states = stack_episodes(env, seeds, arrivals)
    return _means(make_evaluate_batch(env, pcfg)(params, states, traces))


def evaluate_batch_baseline(env: SchedulingEnv, baseline_fn: Callable,
                            seeds, arrivals=None) -> dict[str, float]:
    """Mean baseline metrics across seeds."""
    traces, states = stack_episodes(env, seeds, arrivals)
    return _means(make_baseline_episode_batch(env, baseline_fn)(states,
                                                                traces))
