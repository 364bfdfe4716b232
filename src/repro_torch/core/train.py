"""RELMAS training rounds on one device.

The counterpart of the JAX package's ``core/train.py``.  A round is

    trace generation (``generate_traces_torch``, on the device)
      -> batched rollout (:func:`repro_torch.core.rollout.collect_episodes`)
      -> replay ring write (``replay_add``, in place)
      -> ``num_updates`` DDPG updates (skipped during warm-up)
      -> sigma decay.

Each round is split into its **draws** and its **body**.  The draws
(:func:`round_draws`) are everything random: the episodes' traces, the
standard-normal exploration block, the replay indices of every update
and, under churn, the episodes' compiled churn schedules, all from one
``torch.Generator`` seeded per round.  The body
(:func:`_round_body`) is deterministic given the draws, so the tests
feed it the draws the JAX round takes from its key, and a CPU run and a
card run of one round can take the same draws.

Per-round seeds come from (seed, global round index) (:func:`round_keys`),
so a driver resuming at a round draws what the uninterrupted run would
have.  Where the JAX package fuses a round (and a chunk of rounds) into
one jitted dispatch, here a round is eager PyTorch; the replay buffer
and learner state are updated in place or rebound, as the JAX callers
rebind donated arguments.  ``make_train_rounds`` and
``train_rounds_host`` are the same per-round loop.

Every round maker takes an optional ``churn`` (a
``repro_torch.sim.churn.ChurnConfig``): the round then draws a fresh
schedule per episode (``churn_schedules_torch``), so the policy trains
under fleet faults, throttles and joins as it is evaluated.  The
multi-fleet generalist rounds (``repro_torch.core.generalist``) are
these rounds with their own draws and episodes passed in; multi-device
rounds are not part of this package.

``telemetry=True`` folds the round's telemetry block
(``repro_torch.telemetry.metrics.round_telemetry``: SLA and reward
histograms, committed counter, replay-fill gauge) into its metrics.  It
only reads what the round computes, and the round moves all of its
metrics to the host in one transfer (stacked on the device, one
``.cpu()``), so the block rides that transfer as it does in JAX.  The
phases are ``torch.profiler`` ranges under the JAX package's scope
names: ``relmas.trace_gen`` (the draws), ``relmas.rollout``,
``relmas.ring_write``, ``relmas.ddpg_update``, ``relmas.telemetry``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import ddpg as D
from repro_torch.core import rollout as R
from repro_torch.core.replay import replay_add
from repro_torch.sim.arrivals import generate_traces_torch
from repro_torch.sim.churn import churn_schedules_torch
from repro_torch.sim.env import SchedulingEnv
from repro_torch.telemetry.metrics import ROUND_TELE_KEYS, round_telemetry

# update-info keys mirrored by the warm-up (no-update) branch of the
# round body: ddpg_update's info dict exactly
INFO_KEYS = ("critic_loss", "actor_loss", "q_mean", "target_mean")


def round_keys(seed: int, start_round: int, num_rounds: int) -> list[int]:
    """Per-round generator seeds from (seed, global round index), so a
    driver resuming at ``start_round`` draws the stream the uninterrupted
    run would have."""
    return [int(np.random.SeedSequence([seed, i]).generate_state(
        1, np.uint64)[0]) for i in range(start_round,
                                         start_round + num_rounds)]


def round_draws(env: SchedulingEnv, seed: int, *, batch_episodes: int,
                num_updates: int, batch_size: int, size_after: int,
                arrivals=None, churn=None) -> dict:
    """Everything random in one round, from one generator on the env's
    device seeded ``seed``: ``traces`` (batch_episodes, J), ``noise``
    (batch_episodes, periods, max_rq, G) standard normal, ``idx``
    (num_updates, batch_size) replay indices in ``[0, size_after)``,
    ``size_after`` being the ring's size after this round's write, and
    with a ``churn`` config ``churn``, the episodes' compiled schedules
    ((batch_episodes, periods, M) leaves; the JAX round's ``kchurn``
    draw), whose events target only the SAs of the env's ``sa_mask``
    where it has one (a padded env)."""
    gen = torch.Generator(device=env.device).manual_seed(seed)
    traces = generate_traces_torch(env.min_lat, arrivals or env.arrivals,
                                   gen, batch_episodes, env.device)
    noise = R.noise_block(env, batch_episodes, gen)
    idx = torch.randint(0, max(size_after, 1), (num_updates, batch_size),
                        generator=gen, device=env.device)
    draws = dict(traces=traces, noise=noise, idx=idx)
    if churn is not None:
        draws["churn"] = churn_schedules_torch(
            churn, env.cfg.periods, env.num_sas, gen, batch_episodes,
            sa_mask=getattr(env, "sa_mask", None))
    return draws


def round_inputs(env: SchedulingEnv, draws: dict, churn=None):
    """A round's episode inputs on ``env``'s device from its draws:
    ``(traces, states, noise, scheds)``, ``scheds`` None without a
    ``churn`` config."""
    traces = env.to_trace(draws["traces"])
    scheds = (None if churn is None else
              {k: v.to(env.device) for k, v in draws["churn"].items()})
    return traces, env.init_state(traces), draws["noise"].to(env.device), \
        scheds


def _to_host(dev_vals: dict, tele: dict) -> dict:
    """The round's float32 device scalars and its telemetry leaves in
    one device-to-host transfer: int32 leaves ride bit-cast to float32,
    so every value arrives as the same float32 (or int32) number.
    Returns host floats for ``dev_vals`` and NumPy values for ``tele``."""
    parts = [torch.stack(list(dev_vals.values()))]
    for k in ROUND_TELE_KEYS if tele else ():
        v = tele[k].reshape(-1)
        parts.append(v.view(torch.float32) if v.dtype == torch.int32 else v)
    host = torch.cat(parts).cpu().numpy()
    out = {k: float(v) for k, v in zip(dev_vals, host)}
    at = len(dev_vals)
    for k in ROUND_TELE_KEYS if tele else ():
        n = tele[k].numel()
        v = host[at:at + n]
        v = v.view(np.int32) if tele[k].dtype == torch.int32 else v
        out[k] = v.reshape(tele[k].shape)
        at += n
    return out


def _round_body(env: SchedulingEnv, dcfg: D.DDPGConfig, *,
                batch_episodes: int, num_updates: int, batch_size: int,
                sigma_min: float, sigma_decay: float, arrivals=None,
                churn=None, episodes=None, transform=None,
                telemetry: bool = False):
    """``round_fn(state, buf, draws, sigma, do_update)`` ->
    ``(state, buf, sigma, metrics)``, deterministic given ``draws``
    (with a ``churn`` config the episodes run under ``draws["churn"]``).

    ``buf`` is written in place (and returned); ``sigma`` is a float
    holding a float32 value, decayed in float32 as the JAX round does;
    ``metrics`` are host floats: the round's mean ``sla``, ``reward`` and
    ``energy_uj``, the new ``sigma``, ``did_update`` and the last
    update's :data:`INFO_KEYS` (zeros during warm-up), and the draws'
    ``fleet`` where they have one.

    ``episodes(params, draws, sigma)`` -> ``(transitions, infos,
    metrics)`` replaces the policy's episodes on ``env`` (the
    generalist's collect on the round's fleet and add a ``fleet`` ring
    column); ``transform`` maps each sampled replay batch before its
    update.  ``telemetry`` adds the :data:`ROUND_TELE_KEYS` leaves
    (NumPy) to the metrics."""
    pcfg = dcfg.policy
    if episodes is None:
        def episodes(params, draws, sigma):
            traces, states, noise, scheds = round_inputs(env, draws, churn)
            _, trans, einfos, mets = R.collect_episodes(
                env, pcfg, params, states, traces, None, sigma, noise=noise,
                churn=scheds)
            return trans, einfos, mets

    def round_fn(state: D.DDPGState, buf: dict, draws: dict, sigma: float,
                 do_update: bool):
        with record_function("relmas.rollout"):
            trans, einfos, mets = episodes(state.actor, draws, sigma)
        # (episodes, periods, ...) -> (episodes * periods, ...) ring write
        flat = {k: v.reshape((-1,) + tuple(v.shape[2:]))
                for k, v in trans.items()}
        with record_function("relmas.ring_write"):
            replay_add(buf, flat)
        vals = dict(sla=torch.mean(mets["sla_rate"]),
                    reward=torch.mean(einfos["reward"]),
                    energy_uj=torch.mean(mets["energy_uj"]))
        if do_update:
            with record_function("relmas.ddpg_update"):
                state, infos = D.ddpg_update_rounds(
                    state, dcfg, buf, draws["idx"].to(buf["r"].device),
                    transform)
            vals.update({k: infos[k][-1] for k in INFO_KEYS})
        tele = {}
        if telemetry:
            with record_function("relmas.telemetry"):
                tele = round_telemetry(mets["sla_rate"], einfos["reward"],
                                       einfos["committed"], buf["size"],
                                       buf["r"].shape[0])
        host = _to_host(vals, tele)
        sigma = float(max(np.float32(sigma_min), np.float32(sigma)
                          * np.float32(sigma_decay ** batch_episodes)))
        metrics = dict(sla=host["sla"], reward=host["reward"],
                       energy_uj=host["energy_uj"], sigma=sigma,
                       did_update=bool(do_update),
                       **{k: host.get(k, 0.0) for k in INFO_KEYS},
                       **{k: host[k] for k in ROUND_TELE_KEYS if tele})
        if "fleet" in draws:
            metrics["fleet"] = int(draws["fleet"])
        return state, buf, sigma, metrics

    return round_fn


def make_train_round(env: SchedulingEnv, dcfg: D.DDPGConfig, *,
                     batch_episodes: int, num_updates: int, batch_size: int,
                     sigma_min: float, sigma_decay: float, arrivals=None,
                     churn=None, draws_fn=round_draws, body_fn=_round_body,
                     telemetry: bool = False):
    """One full training round: ``round_fn(state, buf, seed, sigma,
    do_update)`` -> ``(state, buf, sigma, metrics)``, drawing the
    round's draws from ``seed`` (``draws_fn``, :func:`round_draws`) and
    running the body (``body_fn``, :func:`_round_body`); the generalist
    passes its own two, with its fleets' envs as ``env``.
    ``batch_episodes * periods`` transitions ring-write per round and
    must fit the replay capacity; ``telemetry`` goes to the body."""
    body = body_fn(env, dcfg, batch_episodes=batch_episodes,
                   num_updates=num_updates, batch_size=batch_size,
                   sigma_min=sigma_min, sigma_decay=sigma_decay,
                   arrivals=arrivals, churn=churn, telemetry=telemetry)
    periods = (env[0] if isinstance(env, list) else env).cfg.periods

    def round_fn(state, buf, seed: int, sigma: float, do_update: bool):
        cap = buf["r"].shape[0]
        size_after = min(buf["size"] + batch_episodes * periods, cap)
        with record_function("relmas.trace_gen"):
            draws = draws_fn(env, seed, batch_episodes=batch_episodes,
                             num_updates=num_updates, batch_size=batch_size,
                             size_after=size_after, arrivals=arrivals,
                             churn=churn)
        return body(state, buf, draws, sigma, do_update)

    return round_fn


def train_rounds_host(env: SchedulingEnv, dcfg: D.DDPGConfig, state, buf,
                      keys, sigma, do_update, make_round=make_train_round,
                      **kw):
    """Run the rounds described by per-round seeds ``keys`` and warm-up
    flags ``do_update`` one after another (each made by ``make_round``).
    Returns ``(state, buf, sigma, metrics)`` with metrics stacked over
    the round axis as NumPy arrays."""
    round_fn = make_round(env, dcfg, **kw)
    out = []
    for seed, du in zip(keys, do_update):
        state, buf, sigma, m = round_fn(state, buf, int(seed), sigma,
                                        bool(du))
        out.append(m)
    metrics = {k: np.asarray([m[k] for m in out]) for k in out[0]} \
        if out else {}
    return state, buf, sigma, metrics


def make_train_rounds(env: SchedulingEnv, dcfg: D.DDPGConfig, **kw):
    """A chunk of rounds: ``rounds_fn(state, buf, keys, sigma,
    do_update)`` -> ``(state, buf, sigma, metrics)``, metrics stacked over
    the round axis (:func:`train_rounds_host`)."""
    def rounds_fn(state, buf, keys, sigma, do_update):
        return train_rounds_host(env, dcfg, state, buf, keys, sigma,
                                 do_update, **kw)
    return rounds_fn
