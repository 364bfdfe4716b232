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

Fleet churn (``repro_torch.sim.churn``) is data: the runners take a
compiled schedule with ``(batch, periods, M)`` leaves; the policy masks
the SAs a period's row marks invalid out of its allocation.  Eval
schedules come from the NumPy ``churn_schedules`` per eval seed, as in
the JAX package, so both packages evaluate under the same churn.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core import policy as P
from repro_torch.sim.arrivals import generate_trace
from repro_torch.sim.churn import churn_schedules
from repro_torch.sim.env import SchedulingEnv

Metrics = dict[str, torch.Tensor]


def _policy_act_fn(params, pcfg: P.PolicyConfig):
    """Per-period actor; ``noise`` (the period's slice of the episode
    block, already scaled by sigma, or None) is added to the actions,
    which are then clipped to [-1, 1].

    Under churn the period's state carries ``sa_valid`` (S, M): the SA
    argmax then takes ``-inf`` at invalid SAs, so a failed (or not yet
    joined) SA is never selected.  With an all-valid row the mask is
    the bit-exact identity."""
    def act_fn(feats, mask, slots, st, noise):
        a = P.actor_apply(params, pcfg, feats, mask)
        if noise is not None:
            a = torch.clamp(a + noise, -1.0, 1.0)
        logits = a[..., 1:]
        sv = st.get("sa_valid")
        if sv is not None:
            logits = torch.where(sv[:, None, :], logits, -torch.inf)
        return a, a[..., 0], torch.argmax(logits, dim=-1)
    return act_fn


def noise_block(env: SchedulingEnv, batch: int,
                gen: torch.Generator) -> torch.Tensor:
    """Standard-normal exploration noise (batch, periods, max_rq, G),
    ``G = env.act_dim`` (``1 + M_max`` on a padded env)."""
    return torch.randn((batch, env.cfg.periods, env.cfg.max_rq,
                        env.act_dim), generator=gen, device=env.device)


@torch.no_grad()
def collect_episodes(env: SchedulingEnv, pcfg: P.PolicyConfig, params,
                     states, traces, gen: torch.Generator | None, sigma,
                     collect: bool = True, noise=None, act_fn=None,
                     churn=None):
    """Batched policy collection: ``sigma`` times one standard-normal
    noise block (``noise`` if given, else drawn from ``gen``), then
    every episode through ``env.episode``.  ``act_fn`` overrides the
    specialist actor (the fleet-conditioned generalist's); ``churn`` is
    a compiled schedule with ``(batch, periods, M)`` leaves.  Returns
    ``(final_states, transitions, infos, metrics)``."""
    if noise is None:
        noise = noise_block(env, states["t"].shape[0], gen)
    return env.episode(states, traces,
                       act_fn or _policy_act_fn(params, pcfg),
                       aux=sigma * noise, collect=collect, churn=churn)


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
    """``eval_fn(params, states, traces, churn_scheds=None)`` -> metrics
    stacked over the batch axis (no noise, no transitions kept), under a
    compiled churn schedule (``(batch, periods, M)`` leaves) when given.
    The JAX package selects that with a ``churn`` flag, because the two
    are separate compiles; here the argument is enough."""
    @torch.no_grad()
    def eval_fn(params, states, traces, churn_scheds=None) -> Metrics:
        *_, metrics = env.episode(states, traces,
                                  _policy_act_fn(params, pcfg),
                                  collect=False, churn=churn_scheds)
        return metrics
    return eval_fn


def make_baseline_episode_batch(env: SchedulingEnv, baseline_fn: Callable):
    """``eval_fn(states, traces, rand=None, *, churn_scheds=None)`` ->
    metrics for a baseline ``baseline_fn(slots, state, env, rand)``.

    ``rand`` is the episode batch's randomness, threaded into every
    period: a ``torch.Generator`` (MAGMA draws each generation from it;
    the heuristics ignore it), or a list with one entry per period
    (MAGMA's draws as data, from the tests).  The JAX package threads
    one key per episode and splits it per period.  ``churn_scheds`` is
    a compiled churn schedule.  An invalid SA needs no masking of its
    own here: it advertises the poison cost, which the heuristics'
    greedy argmin avoids."""
    @torch.no_grad()
    def eval_fn(states, traces, rand=None, *, churn_scheds=None) -> Metrics:
        per_period = iter(rand) if isinstance(rand, (list, tuple)) else None

        def act_fn(feats, mask, slots, st, aux):
            r = next(per_period) if per_period is not None else rand
            return baseline_fn(slots, st, env, r)
        *_, metrics = env.episode(states, traces, act_fn, collect=False,
                                  churn=churn_scheds)
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


def _eval_churn_schedules(env: SchedulingEnv, churn, seeds):
    """Deterministic per-seed eval schedules (NumPy ``churn_schedules``,
    the JAX package's), drawn over the env's *real* SA count
    (``true_num_sas`` on a padded env) and compiled at its table width,
    on the env's device."""
    real = getattr(env, "true_num_sas", env.num_sas)
    return churn_schedules(churn, env.cfg.periods, real, seeds,
                           width=env.num_sas, device=env.device)


def evaluate_batch(env: SchedulingEnv, pcfg: P.PolicyConfig, params,
                   seeds, arrivals=None, churn=None) -> dict[str, float]:
    """Mean policy metrics across seeds; ``churn`` (a ``ChurnConfig``)
    evaluates each seed under its deterministic schedule."""
    traces, states = stack_episodes(env, seeds, arrivals)
    return _means(make_evaluate_batch(env, pcfg)(
        params, states, traces,
        None if churn is None else _eval_churn_schedules(env, churn, seeds)))


def _seeds_generator(env: SchedulingEnv, seeds) -> torch.Generator:
    """A generator on the env's device seeded from all the eval seeds:
    a stochastic baseline's randomness follows the seeds that drew the
    traces (the JAX package keys each episode ``PRNGKey(seed)``)."""
    seed = int(np.random.SeedSequence([int(s) for s in seeds])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))
    return torch.Generator(device=env.device).manual_seed(seed)


def evaluate_batch_baseline(env: SchedulingEnv, baseline_fn: Callable,
                            seeds, arrivals=None,
                            churn=None) -> dict[str, float]:
    """Mean baseline metrics across seeds, the heuristics and MAGMA
    alike (MAGMA draws from :func:`_seeds_generator`); ``churn`` as in
    :func:`evaluate_batch`."""
    traces, states = stack_episodes(env, seeds, arrivals)
    return _means(make_baseline_episode_batch(env, baseline_fn)(
        states, traces, _seeds_generator(env, seeds),
        churn_scheds=(None if churn is None
                      else _eval_churn_schedules(env, churn, seeds))))


# --------------------------------------------------------------------------
# legacy per-period runners (the JAX package's compatibility wrappers, and
# the "before" datapoint of its rollout benchmark)
# --------------------------------------------------------------------------
def make_policy_period(env: SchedulingEnv, pcfg: P.PolicyConfig):
    """One period with the RELMAS actor: ``period(params, state, trace,
    gen=None, sigma=0.0, noise=None)`` -> ``(new_state, transition,
    info)`` on a one-stream state and trace (``S = 1``).

    At ``sigma == 0`` the actions are the actor's, with no noise and no
    clip (the reference's legacy act clips only with noise).  At
    ``sigma > 0`` they get ``sigma`` times a standard-normal ``(1,
    max_rq, G)`` block, ``noise`` if given (the draws as data) else
    drawn from ``gen`` (a ``torch.Generator`` on the env's device), and
    are clipped to [-1, 1].  The SA is ``argmax(a[..., 1:])``."""
    @torch.no_grad()
    def period(params, state, trace, gen=None, sigma: float = 0.0,
               noise=None):
        def act_fn(feats, mask, slots, st):
            a = P.actor_apply(params, pcfg, feats, mask)
            if sigma > 0.0:
                if noise is None:
                    z = torch.randn(a.shape, generator=gen,
                                    device=env.device)
                else:
                    z = torch.as_tensor(noise, dtype=a.dtype,
                                        device=env.device).reshape(a.shape)
                a = torch.clamp(a + sigma * z, -1.0, 1.0)
            return a, a[..., 0], torch.argmax(a[..., 1:], dim=-1)
        return env.period(state, trace, act_fn)
    return period


def make_baseline_period(env: SchedulingEnv, baseline_fn: Callable):
    """One period with a heuristic baseline ``baseline_fn(slots, state,
    env, rand)``: ``period(state, trace, rand=None)`` -> ``(new_state,
    transition, info)``, ``rand`` passed on to the baseline (MAGMA's
    generator; the heuristics ignore it).  There is nothing to compile,
    so the reference's ``jit`` flag has no counterpart."""
    @torch.no_grad()
    def period(state, trace, rand=None):
        return env.period(state, trace,
                          lambda feats, mask, slots, st: baseline_fn(
                              slots, st, env, rand))
    return period


def run_episode(env: SchedulingEnv, period_fn, rng: np.random.Generator,
                *, params=None, gen: torch.Generator | None = None,
                sigma: float = 0.0, collect: bool = False, arrivals=None,
                noise=None):
    """One episode with the legacy per-period Python loop, on one stream.

    The trace is the NumPy ``generate_trace`` from ``rng``, as the
    reference's ``new_episode`` draws it.  With ``params`` the periods
    are a policy's (:func:`make_policy_period`): each takes ``gen`` and
    ``sigma``, or period p's slice of ``noise`` ``(periods, max_rq, G)``
    (the draws as data); without, a baseline's
    (:func:`make_baseline_period`), given ``gen`` as its ``rand``.  A
    final drop pass counts the late jobs before the metrics.

    Returns ``(metrics, transitions | None)``: ``metrics`` a dict of
    Python floats, ``transitions`` (with ``collect``) one dict of NumPy
    arrays a period, without the stream axis, as ``ReplayBuffer.add``
    takes them.  Prefer :func:`collect_episodes` /
    :func:`evaluate_batch`: this path pays a host loop per period and
    exists for compatibility and as the benchmark's "before" arm.
    """
    tr = generate_trace(env.min_lat, arrivals or env.arrivals, rng)
    trace = env.to_trace({k: np.asarray(v)[None] for k, v in tr.items()})
    state = env.init_state(trace)
    transitions = [] if collect else None
    for p in range(env.cfg.periods):
        if params is not None:
            state, trans, _ = period_fn(
                params, state, trace, gen, sigma,
                None if noise is None else noise[p])
        else:
            state, trans, _ = period_fn(state, trace, gen)
        if collect:
            transitions.append({k: v[0].cpu().numpy()
                                for k, v in trans.items()})
    state = env.mark_drops(state, trace, state["t"])
    metrics = {k: float(v[0]) for k, v in env.metrics(state, trace).items()}
    return metrics, transitions


def evaluate(env: SchedulingEnv, period_fn, seeds, *,
             params=None) -> dict[str, float]:
    """Mean metrics over one :func:`run_episode` per seed (NumPy
    ``default_rng(seed)`` traces).  A policy's episode ``s`` takes a
    generator on the env's device seeded ``s``, as the reference keys
    each seed with ``PRNGKey(seed)`` (its own ``key`` argument is unused,
    so it has no counterpart here)."""
    out: dict[str, list[float]] = {}
    for s in seeds:
        g = (None if params is None else
             torch.Generator(device=env.device).manual_seed(int(s)))
        m, _ = run_episode(env, period_fn, np.random.default_rng(s),
                           params=params, gen=g)
        for k, v in m.items():
            out.setdefault(k, []).append(v)
    return {k: float(np.mean(v)) for k, v in out.items()}
