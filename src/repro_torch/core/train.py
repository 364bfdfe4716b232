"""RELMAS training rounds, on one device or sharded over several.

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
rebind donated arguments.  ``make_train_rounds``, its call-style
``train_rounds_scan`` and ``train_rounds_host`` are the same per-round
loop.

Every single-device round maker takes an optional ``churn`` (a
``repro_torch.sim.churn.ChurnConfig``): the round then draws a fresh
schedule per episode (``churn_schedules_torch``), so the policy trains
under fleet faults, throttles and joins as it is evaluated.  The
multi-fleet generalist rounds (``repro_torch.core.generalist``) are
these rounds with their own draws and episodes passed in.

**Sharded rounds** (:func:`make_sharded_train_rounds`, the reference's
``jit``-of-``shard_map``) run one process per device over a 1-D
``DeviceMesh`` whose dim is :data:`MESH_AXIS` (:func:`make_device_mesh`;
NCCL on the card, gloo on the CPU).  Each rank collects
``batch_episodes / D`` episodes from its own per-(device, round) seed
(:func:`shard_round_keys`), owns a double-buffered replay ring pair
(``replay_pair_init`` / ``replay_pair_step``: the updates sample the
``read`` ring while the round's transitions go to the ``write`` ring),
and every update gathers the rows each rank sampled from its read ring
(``replay_sample_global``), so each replica runs the same plain update
on the same global batch and the learner states stay bit-equal with no
gradient collective.  The episode metrics are averaged and the
telemetry counts summed over the device axis, from one gather of the
ranks' values, and still reach the host in one transfer a round.
:func:`sharded_rounds_reference` is the in-process oracle: the ``D``
shards in one process, its collective a stack in shard order.  The
body (:func:`_sharded_round_body`) runs in stages (collect; the
updates, each sampling, gathering and updating; the ring step; the
reductions) and loops over the shards it holds in each, so the oracle
and the process-group path share every line but the collective
(``StackedShards`` / ``MeshShards``).  The oracle also runs the
reference's local-sample topology (``update_gather=False``): each
shard's update samples its own read ring and the shards' gradients and
infos are averaged (``StackedShards.mean``); the mesh callable keeps
the gathered batch, as the reference's does.

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
from repro_torch.core.replay import (pack_rows, replay_add,
                                     replay_pair_step, unpack_rows)
from repro_torch.sim.arrivals import generate_traces_torch
from repro_torch.sim.churn import churn_schedules_torch
from repro_torch.sim.env import SchedulingEnv
from repro_torch.telemetry.metrics import (ROUND_TELE_COUNTS,
                                           ROUND_TELE_GAUGES,
                                           ROUND_TELE_KEYS, round_telemetry)

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


def _policy_episodes(env: SchedulingEnv, pcfg, churn=None):
    """``episodes(params, draws, sigma)`` -> ``(transitions, infos,
    metrics)``: the policy's batched episodes on ``env`` from a round's
    draws."""
    def episodes(params, draws, sigma):
        traces, states, noise, scheds = round_inputs(env, draws, churn)
        _, trans, einfos, mets = R.collect_episodes(
            env, pcfg, params, states, traces, None, sigma, noise=noise,
            churn=scheds)
        return trans, einfos, mets
    return episodes


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
    episodes = episodes or _policy_episodes(env, dcfg.policy, churn)

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
        sigma = _decay(sigma, sigma_min, sigma_decay, batch_episodes)
        return state, buf, sigma, _round_metrics(vals, tele, sigma,
                                                 do_update, draws)

    return round_fn


def _decay(sigma: float, sigma_min: float, sigma_decay: float,
           episodes: int) -> float:
    """Sigma after a round of ``episodes`` episodes, in float32 as the
    JAX round decays it."""
    return float(max(np.float32(sigma_min), np.float32(sigma)
                     * np.float32(sigma_decay ** episodes)))


def _round_metrics(vals: dict, tele: dict, sigma: float, do_update: bool,
                   draws: dict) -> dict:
    """A round's host metrics from its device scalars ``vals`` and
    telemetry leaves ``tele`` (one transfer, :func:`_to_host`): ``sla``,
    ``reward``, ``energy_uj``, ``sigma``, ``did_update``, the
    :data:`INFO_KEYS` (zeros during warm-up), the telemetry leaves and
    the draws' ``fleet`` where they have one."""
    host = _to_host(vals, tele)
    metrics = dict(sla=host["sla"], reward=host["reward"],
                   energy_uj=host["energy_uj"], sigma=sigma,
                   did_update=bool(do_update),
                   **{k: host.get(k, 0.0) for k in INFO_KEYS},
                   **{k: host[k] for k in ROUND_TELE_KEYS if tele})
    if "fleet" in draws:
        metrics["fleet"] = int(draws["fleet"])
    return metrics


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


def train_rounds_scan(env: SchedulingEnv, dcfg: D.DDPGConfig, state, buf,
                      keys, sigma, do_update, **kw):
    """Call-style convenience over :func:`make_train_rounds`: the rounds
    described by the per-round seeds ``keys`` and warm-up flags
    ``do_update``, returning ``(state, buf, sigma, metrics)`` with
    metrics stacked over the round axis.  ``buf`` is written in place,
    as the reference's donated buffer is."""
    return make_train_rounds(env, dcfg, **kw)(state, buf, keys, sigma,
                                              do_update)


# ---------------------------------------------------------------------------
# rounds sharded over devices: one process per device on a 1-D DeviceMesh
# ---------------------------------------------------------------------------
MESH_AXIS = "dev"


def make_device_mesh(devices=None):
    """A 1-D ``DeviceMesh`` whose dim is :data:`MESH_AXIS`, over the
    process group already initialised (one rank per device).
    ``devices``, when given, lists one device per rank and must match
    the world size.  The mesh's device type follows the backend: NCCL
    meshes are ``cuda``, gloo meshes ``cpu`` (gloo moves a card's tensors
    through the host)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_device_mesh: initialise the process group "
                           "first (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if devices is not None and len(list(devices)) != world:
        raise ValueError(f"make_device_mesh: {len(list(devices))} devices "
                         f"for a world of {world} ranks")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, list(range(world)), mesh_dim_names=(MESH_AXIS,))


class StackedShards:
    """The in-process oracle's collective: all ``num_devices`` shards
    are here, and ``all_gather`` stacks them in shard order."""

    def __init__(self, num_devices: int):
        self.num_devices = num_devices

    def all_gather(self, parts: list) -> torch.Tensor:
        if len(parts) != self.num_devices:
            raise ValueError(f"{len(parts)} shards for {self.num_devices} "
                             f"devices")
        return torch.stack(parts)

    def mean(self, parts: list) -> torch.Tensor:
        """The shards' mean (the reference's ``pmean``): their sum left
        to right in shard order, over ``num_devices``."""
        if len(parts) != self.num_devices:
            raise ValueError(f"{len(parts)} shards for {self.num_devices} "
                             f"devices")
        return _sum_shards(parts) / self.num_devices


class MeshShards:
    """A rank's collective over ``mesh``: one shard here, and
    ``all_gather`` stacks every rank's in rank order (one
    ``torch.distributed.all_gather``; on gloo through the host, so two
    ranks may share a card)."""

    def __init__(self, mesh):
        import torch.distributed as dist
        self.group = mesh.get_group(MESH_AXIS)
        self.num_devices = mesh.size()
        self.rank = mesh.get_local_rank(MESH_AXIS)
        self.host = dist.get_backend(self.group) != "nccl"

    def all_gather(self, parts: list) -> torch.Tensor:
        import torch.distributed as dist
        (x,) = parts
        y = x.cpu() if self.host else x
        out = [torch.empty_like(y) for _ in range(self.num_devices)]
        dist.all_gather(out, y, group=self.group)
        return torch.stack(out).to(x.device)


def shard_round_keys(keys, num_devices: int) -> np.ndarray:
    """Per-(device, round) seeds ``(num_devices, R)``: round seed ``k``
    of :func:`round_keys` and device ``d`` give
    ``SeedSequence([k, d])``'s, a pure function of (seed, round,
    device), so a resume at any round count or device count replays
    the same per-device stream."""
    return np.array([[np.random.SeedSequence([int(k), d]).generate_state(
        1, np.uint64)[0] for k in keys] for d in range(num_devices)],
        dtype=np.uint64).reshape(num_devices, len(keys))


def replicate(tree: dict, num_devices: int) -> list:
    """``num_devices`` copies of a dict of tensors and host ints (nested
    dicts too): the oracle's shards of a fresh ring pair.  Its learner
    state needs no copies: every replica's is the same, and a rank's
    replica is a plain single-device state, which checkpoints and
    evaluation take as they are (the reference's ``unreplicate``)."""
    copy = lambda node: ({k: copy(v) for k, v in node.items()}
                         if isinstance(node, dict) else
                         node.clone() if torch.is_tensor(node) else node)
    return [copy(tree) for _ in range(num_devices)]


def _shard_sizes(num_devices: int, batch_episodes: int,
                 batch_size: int) -> tuple[int, int]:
    for name, v in (("batch_episodes", batch_episodes),
                    ("batch_size", batch_size)):
        if v % num_devices:
            raise ValueError(f"{name}={v} not divisible by "
                             f"num_devices={num_devices}")
    return batch_episodes // num_devices, batch_size // num_devices


def _sum_shards(rows: list) -> torch.Tensor:
    """Left to right in shard order, the same on every rank."""
    acc = rows[0]
    for x in rows[1:]:
        acc = acc + x
    return acc


def _reduce_shards(comm, parts: list, tele: list) -> tuple[dict, dict]:
    """The shards' round values reduced over the device axis from one
    gather: the episode means (``parts``: per shard the (3,) float32
    sla, reward and energy means) averaged, the telemetry counts summed
    and the gauges averaged (``tele``: per shard its telemetry leaves,
    or empty dicts)."""
    keys = [k for k in ROUND_TELE_GAUGES + ROUND_TELE_COUNTS if tele[0]]
    packed = comm.all_gather([pack_rows([p] + [t[k] for k in keys])
                              for p, t in zip(parts, tele)])
    like = [parts[0]] + [tele[0][k] for k in keys]
    shards = [unpack_rows(row, like) for row in packed]
    n = comm.num_devices
    mean = _sum_shards([x[0] for x in shards]) / n
    vals = dict(zip(("sla", "reward", "energy_uj"), mean))
    out = {}
    for j, k in enumerate(keys, 1):
        total = _sum_shards([x[j] for x in shards])
        out[k] = total / n if k in ROUND_TELE_GAUGES else total
    return vals, out


def _sharded_round_body(env, dcfg: D.DDPGConfig, *, num_devices: int,
                        batch_episodes: int, num_updates: int,
                        batch_size: int, sigma_min: float,
                        sigma_decay: float, arrivals=None, episodes=None,
                        transform=None, telemetry: bool = False,
                        update_gather: bool = True):
    """``round_fn(state, pairs, draws, sigma, do_update, comm)`` ->
    ``(state, pairs, sigma, metrics)``, deterministic given ``draws``.

    ``pairs`` and ``draws`` are the shards this process holds (its own,
    or all ``num_devices`` for the oracle), each drawn for
    ``batch_episodes / num_devices`` episodes and ``batch_size /
    num_devices`` rows an update from its read ring; ``comm`` gathers
    over the device axis.  In stages: collect every shard; the updates
    (each gathers the shards' samples, ``ddpg_update_rounds``'s ``comm``
    mode; with ``update_gather=False`` each shard updates on its own
    samples and the gradients are averaged, ``comm.mean``); each pair's
    ring step; the reductions (episode means averaged,
    telemetry counts summed, the fill gauge averaged over the new read
    rings), moved to the host in one transfer.  Sigma decays by the
    global ``batch_episodes``.  ``episodes`` and ``transform`` as in
    :func:`_round_body` (no churn: the sharded rounds have none, as in
    the reference)."""
    _shard_sizes(num_devices, batch_episodes, batch_size)
    episodes = episodes or _policy_episodes(env, dcfg.policy)

    def round_fn(state: D.DDPGState, pairs: list, draws: list, sigma: float,
                 do_update: bool, comm):
        with record_function("relmas.rollout"):
            outs = [episodes(state.actor, d, sigma) for d in draws]
        info = {}
        if do_update:
            with record_function("relmas.ddpg_update"):
                reads = [p["read"] for p in pairs]
                state, infos = D.ddpg_update_rounds(
                    state, dcfg, reads,
                    [d["idx"].to(r["r"].device) for d, r in zip(draws, reads)],
                    transform, comm, update_gather)
            info = {k: infos[k][-1] for k in INFO_KEYS}
        with record_function("relmas.ring_write"):
            for p, (trans, _, _) in zip(pairs, outs):
                replay_pair_step(p, {k: v.reshape((-1,) + tuple(v.shape[2:]))
                                     for k, v in trans.items()})
        parts = [torch.stack([torch.mean(m["sla_rate"]),
                              torch.mean(e["reward"]),
                              torch.mean(m["energy_uj"])])
                 for _, e, m in outs]
        tele = [{} for _ in pairs]
        if telemetry:
            with record_function("relmas.telemetry"):
                tele = [round_telemetry(m["sla_rate"], e["reward"],
                                        e["committed"], p["read"]["size"],
                                        p["read"]["r"].shape[0])
                        for p, (_, e, m) in zip(pairs, outs)]
        vals, tele = _reduce_shards(comm, parts, tele)
        sigma = _decay(sigma, sigma_min, sigma_decay, batch_episodes)
        return state, pairs, sigma, _round_metrics(
            {**vals, **info}, tele, sigma, do_update, draws[0])

    return round_fn


def _sharded_rounds(env, dcfg: D.DDPGConfig, comm, draws_fn, *,
                    batch_episodes: int, num_updates: int, batch_size: int,
                    arrivals=None, **kw):
    """The rounds loop over ``comm``'s shards: ``loop(state, pairs, keys,
    shared, sigma, do_update)`` with ``keys`` the seeds of the shards
    held (one row of R per pair) and ``shared`` the unsharded round
    seeds; each round draws every shard's draws
    (``draws_fn(env, seed, shared_seed, **draw_kw)``, its replay indices
    into the shard's read ring), then runs the body.  Metrics come back
    stacked over the round axis as NumPy arrays."""
    per_eps, per_bs = _shard_sizes(comm.num_devices, batch_episodes,
                                   batch_size)
    body = _sharded_round_body(env, dcfg, num_devices=comm.num_devices,
                               batch_episodes=batch_episodes,
                               num_updates=num_updates,
                               batch_size=batch_size, arrivals=arrivals,
                               **kw)

    def loop(state, pairs, keys, shared, sigma, do_update):
        out = []
        for i, du in enumerate(do_update):
            with record_function("relmas.trace_gen"):
                draws = [draws_fn(env, int(k[i]), int(shared[i]),
                                  batch_episodes=per_eps,
                                  num_updates=num_updates,
                                  batch_size=per_bs,
                                  size_after=p["read"]["size"],
                                  arrivals=arrivals)
                         for k, p in zip(keys, pairs)]
            state, pairs, sigma, m = body(state, pairs, draws, sigma,
                                          bool(du), comm)
            out.append(m)
        metrics = {k: np.asarray([m[k] for m in out]) for k in out[0]} \
            if out else {}
        return state, pairs, sigma, metrics

    return loop


def _plain_draws(env, seed: int, shared_seed: int, **kw) -> dict:
    return round_draws(env, seed, **kw)


def make_sharded_train_rounds(env: SchedulingEnv, dcfg: D.DDPGConfig, *,
                              mesh, draws_fn=_plain_draws, **kw):
    """A chunk of rounds sharded over ``mesh``, this rank's part:
    ``rounds_fn(state, pair, keys, sigma, do_update)`` ->
    ``(state, pair, sigma, metrics)``.

    ``state`` is this rank's replica of the learner state (bit-equal on
    every rank); ``pair`` its ring pair (``replay_pair_init`` over a
    ring of ``replay_capacity / D``); ``keys`` the ``(D, R)`` seeds of
    :func:`shard_round_keys` (the rank takes its row); ``do_update`` the
    R warm-up flags; ``metrics`` the round values reduced over the mesh,
    the same on every rank.  ``kw``: ``batch_episodes``,
    ``num_updates``, ``batch_size`` (global; ``batch_episodes`` and
    ``batch_size`` divisible by D), ``sigma_min``, ``sigma_decay``,
    ``arrivals``, ``telemetry``.  The updates take the gathered batch
    (the reference's mesh callable has no local-sample mode)."""
    if not kw.get("update_gather", True):
        raise ValueError("make_sharded_train_rounds updates on the "
                         "gathered batch; the local-sample topology runs "
                         "in sharded_rounds_reference")
    comm = MeshShards(mesh)
    loop = _sharded_rounds(env, dcfg, comm, draws_fn, **kw)

    def rounds_fn(state, pair, keys, sigma, do_update, shared=None):
        shared = [0] * len(do_update) if shared is None else shared
        state, pairs, sigma, m = loop(state, [pair], [keys[comm.rank]],
                                      shared, sigma, do_update)
        return state, pairs[0], sigma, m

    return rounds_fn


def sharded_rounds_reference(env: SchedulingEnv, dcfg: D.DDPGConfig, *,
                             num_devices: int, draws_fn=_plain_draws, **kw):
    """The in-process oracle of :func:`make_sharded_train_rounds` (the
    reference's vmap oracle): ``rounds_fn(state, pairs, keys, sigma,
    do_update)`` with ``pairs`` the ``num_devices`` shards' ring pairs in
    device order (:func:`replicate` of a fresh pair), ``keys`` all
    ``(D, R)`` seeds, and ``state`` one copy of the replicated learner
    state; on one device.  The same body and loop as the mesh path, its
    collective a stack in shard order.  ``update_gather=False`` (in
    ``kw``) runs the local-sample topology: each shard's update on its
    own samples, the gradients and infos averaged over the shards."""
    loop = _sharded_rounds(env, dcfg, StackedShards(num_devices), draws_fn,
                           **kw)

    def rounds_fn(state, pairs, keys, sigma, do_update, shared=None):
        shared = [0] * len(do_update) if shared is None else shared
        return loop(state, pairs, list(keys), shared, sigma, do_update)

    return rounds_fn
