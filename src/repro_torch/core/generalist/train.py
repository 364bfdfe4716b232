"""Multi-fleet training rounds for the generalist policy.

The counterpart of the JAX package's ``core/generalist/train.py``.  A
round is ``repro_torch.core.train``'s round with
one more draw: each round **samples a fleet** for its episode batch and
collects on that fleet's padded env, conditioned on its descriptors.
The round loop, the ring write, the updates and the sigma decay are
``core.train``'s; this module passes in the generalist's draws, its
episodes and its replay-batch transform.

The replay ring stores the *padded env* features (``4 + 2 M_max``) plus
a per-transition ``fleet`` index column instead of the full
descriptor-augmented rows: the update re-attaches the (tiny) descriptor
block by a per-sample gather (:func:`expand_batch`), so transitions of
different fleets mix in one buffer.

As in ``core.train``, a round splits into its draws
(:func:`generalist_round_draws`: the fleet index, then ``core.train``'s
draws on that fleet's env: traces with its SLA budgets, the noise
block, the replay indices and, under churn, schedules whose events
target the fleet's real SAs only) and a body deterministic given them,
so the tests feed in what the JAX round draws from its key.  A
``telemetry=True`` keyword reaches ``core.train._round_body`` through
``**kw``: the generalist round then carries the round's telemetry block
beside its ``fleet``, as the JAX generalist round does.

Sharded over devices (:func:`make_sharded_generalist_rounds`, the
oracle :func:`sharded_generalist_rounds_reference`), a round is
``core.train``'s sharded round with the same parts: the round's fleet
is drawn from the **shared** (unsharded) round seed, so every device
collects on the same fleet; each device's traces, noise and replay
indices come from its own seed; the ``fleet`` column rides the ring
pair like any field; and the descriptors are re-attached to the
gathered batch, after the gather.
"""
from __future__ import annotations

import torch

from repro_torch.core import ddpg as D
from repro_torch.core import train as TR
from repro_torch.core.generalist.env import PaddedEnv, stack_fleet_tables
from repro_torch.core.generalist.features import (GeneralistSpec,
                                                  action_channel_mask)
from repro_torch.core.generalist.rollout import collect_generalist
from repro_torch.core.replay import replay_init


def generalist_replay_init(capacity: int, seq_len: int,
                           spec: GeneralistSpec,
                           device: str | torch.device = "cuda") -> dict:
    """Replay ring in the padded-env feature space + a ``fleet`` index
    column per transition (descriptors re-attached at sample time)."""
    buf = replay_init(capacity, seq_len, spec.env_feat_dim, spec.act_dim,
                      device)
    buf["fleet"] = torch.zeros((capacity,), dtype=torch.int64,
                               device=device)
    return buf


def expand_batch(batch: dict, desc_all, sa_mask_all) -> dict:
    """Re-attach descriptor conditioning to a sampled replay batch:
    each sample's fleet descriptor block (``desc_all`` (K, M, D)) tiled
    onto every timestep of ``s`` / ``s2``, and the per-sample
    ``act_mask`` (B, 1 + M) that keeps the update's regenerated actions
    masked like the behaviour policy's."""
    f = batch["fleet"]
    B, T = batch["s"].shape[:2]
    dflat = desc_all[f].reshape(B, 1, -1).to(batch["s"].dtype)
    dtile = dflat.expand(B, T, dflat.shape[-1])
    return {**batch,
            "s": torch.cat([batch["s"], dtile], dim=-1),
            "s2": torch.cat([batch["s2"], dtile], dim=-1),
            "act_mask": action_channel_mask(sa_mask_all[f])}


def generalist_update_rounds(state: D.DDPGState, dcfg: D.DDPGConfig,
                             buf: dict, desc_all, sa_mask_all, idx):
    """``len(idx)`` DDPG updates, update ``u`` on the replay rows
    ``idx[u]`` with descriptors re-attached.  Returns (new_state, infos
    stacked over the (num_updates,) axis)."""
    return D.ddpg_update_rounds(
        state, dcfg, buf, idx,
        lambda batch: expand_batch(batch, desc_all, sa_mask_all))


def generalist_round_draws(envs: list[PaddedEnv], seed: int,
                           **kw) -> dict:
    """Everything random in one round from ``seed``: the ``fleet`` index
    (a host int, from a CPU generator), then ``core.train.round_draws``
    on that fleet's env (``kw`` as there): its ``traces``, the ``noise``
    block at width ``1 + M_max``, the replay ``idx`` and, with a
    ``churn`` config, the ``churn`` schedules over its real SAs."""
    fleet = int(torch.randint(len(envs), (),
                              generator=torch.Generator().manual_seed(seed)))
    return dict(fleet=fleet, **TR.round_draws(envs[fleet], seed, **kw))


def _generalist_parts(envs: list[PaddedEnv], dcfg: D.DDPGConfig,
                      churn=None) -> dict:
    """The generalist's ``episodes`` (collect on fleet
    ``draws["fleet"]`` with its descriptors, add the ``fleet`` ring
    column) and ``transform`` (re-attach the descriptors to a sampled
    batch) for ``core.train``'s round bodies."""
    stack = stack_fleet_tables(envs)
    pcfg = dcfg.policy

    def episodes(params, draws, sigma):
        f = int(draws["fleet"])
        env = envs[f]
        traces, states, noise, scheds = TR.round_inputs(env, draws, churn)
        _, trans, einfos, mets = collect_generalist(
            env, pcfg, params, states, traces, None, sigma,
            desc=stack["desc"][f], sa_mask=stack["sa_mask"][f],
            churn=scheds, noise=noise)
        trans["fleet"] = torch.full(trans["r"].shape, f, dtype=torch.int64,
                                    device=env.device)
        return trans, einfos, mets

    return dict(episodes=episodes,
                transform=lambda batch: expand_batch(batch, stack["desc"],
                                                     stack["sa_mask"]))


def _generalist_round_body(envs: list[PaddedEnv], dcfg: D.DDPGConfig, *,
                           churn=None, **kw):
    """``core.train``'s round body (``kw`` as there) collecting on fleet
    ``draws["fleet"]`` with its descriptors, writing the ``fleet``
    column and re-attaching descriptors to every update's batch."""
    return TR._round_body(envs, dcfg, churn=churn,
                          **_generalist_parts(envs, dcfg, churn), **kw)


def make_generalist_round(envs: list[PaddedEnv], dcfg: D.DDPGConfig, **kw):
    """One fleet-sampling training round: ``round_fn(state, buf, seed,
    sigma, do_update)`` -> ``(state, buf, sigma, metrics)``
    (``core.train.make_train_round`` with :func:`generalist_round_draws`
    and the generalist's body)."""
    return TR.make_train_round(envs, dcfg, draws_fn=generalist_round_draws,
                               body_fn=_generalist_round_body, **kw)


def generalist_rounds_host(envs: list[PaddedEnv], dcfg: D.DDPGConfig,
                           state, buf, keys, sigma, do_update, **kw):
    """The rounds of per-round seeds ``keys`` and warm-up flags
    ``do_update`` one after another (``core.train.train_rounds_host``
    with :func:`make_generalist_round`)."""
    return TR.train_rounds_host(envs, dcfg, state, buf, keys, sigma,
                                do_update, make_round=make_generalist_round,
                                **kw)


def make_generalist_rounds(envs: list[PaddedEnv], dcfg: D.DDPGConfig,
                           **kw):
    """A chunk of fleet-sampling rounds: ``rounds_fn(state, buf, keys,
    sigma, do_update)`` (:func:`generalist_rounds_host`)."""
    return TR.make_train_rounds(envs, dcfg, make_round=make_generalist_round,
                                **kw)


# ---------------------------------------------------------------------------
# sharded over devices
# ---------------------------------------------------------------------------
def sharded_generalist_draws(envs: list[PaddedEnv], seed: int,
                             shared_seed: int, **kw) -> dict:
    """One device's draws of a sharded round: the ``fleet`` from the
    shared round seed (as :func:`generalist_round_draws` draws it, so
    every device takes the same), then ``core.train.round_draws`` on
    that fleet's env from the device's own ``seed``."""
    fleet = int(torch.randint(
        len(envs), (), generator=torch.Generator().manual_seed(shared_seed)))
    return dict(fleet=fleet, **TR.round_draws(envs[fleet], seed, **kw))


def make_sharded_generalist_rounds(envs: list[PaddedEnv],
                                   dcfg: D.DDPGConfig, *, mesh, **kw):
    """This rank's part of a chunk of fleet-sampling rounds sharded over
    ``mesh``: ``rounds_fn(state, pair, keys, shared_keys, sigma,
    do_update)`` (``core.train.make_sharded_train_rounds``'s contract,
    plus ``shared_keys``, the R unsharded round seeds of ``round_keys``
    that draw each round's fleet); ``pair`` is built over
    :func:`generalist_replay_init`; ``metrics`` gain ``fleet``."""
    fn = TR.make_sharded_train_rounds(
        envs, dcfg, mesh=mesh, draws_fn=sharded_generalist_draws,
        **_generalist_parts(envs, dcfg), **kw)
    return lambda state, pair, keys, shared_keys, sigma, do_update: fn(
        state, pair, keys, sigma, do_update, shared_keys)


def sharded_generalist_rounds_reference(envs: list[PaddedEnv],
                                        dcfg: D.DDPGConfig, *,
                                        num_devices: int, **kw):
    """The in-process oracle of :func:`make_sharded_generalist_rounds`:
    ``rounds_fn(state, pairs, keys, shared_keys, sigma, do_update)`` with
    the ``num_devices`` shards' pairs and all ``(D, R)`` seeds
    (``core.train.sharded_rounds_reference``'s contract)."""
    fn = TR.sharded_rounds_reference(
        envs, dcfg, num_devices=num_devices,
        draws_fn=sharded_generalist_draws,
        **_generalist_parts(envs, dcfg), **kw)
    return lambda state, pairs, keys, shared_keys, sigma, do_update: fn(
        state, pairs, keys, sigma, do_update, shared_keys)
