"""RELMAS DDPG training driver (paper Sec. 4.2 / Sec. 5).

The counterpart of the JAX package's ``launch/rl_train.py``, with the
same flags plus ``--device``.  Each round (``core.train``): device-side
trace generation, a batched rollout whose actor runs the hand-written
``lstm_cell`` kernel once per LSTM step, the replay ring write, the
round's DDPG updates (whose five recurrences each run the kernel T times
forward, three of them with a backward) and sigma decay.  Evaluation
runs the policy and the baselines on NumPy-drawn eval traces.

- ``--fleet a,b,...`` (or ``--policy-kind generalist``) trains the
  fleet-conditioned generalist (``core.generalist``): features padded
  to ``--m-max`` with per-SA descriptors, each round samples a fleet;
  evaluation runs on every fleet (``--best-metric min_fleet`` keeps the
  checkpoint whose weakest fleet is best);
- ``--churn NAME`` draws a fresh churn schedule (``sim.churn``) for
  every episode of every round;
- ``--eval-baselines`` scores fcfs, prema, herald and magma (the GA at
  ``--magma-population`` x ``--magma-generations``) before training.

Fault-tolerant loop, as in the reference:
- periodic atomic checkpoints of the full learner state (the replay is
  re-warmed on restart, sound for an off-policy learner), in the JAX
  package's format: either package resumes the other's checkpoints;
- per-round generator seeds from the *global* round index
  (``core.train.round_keys``), so a resumed run draws the stream the
  uninterrupted run would have (on the same device);
- ``--fail-at`` injects a crash; a rerun in the same ``--outdir``
  auto-resumes from the latest checkpoint and prints
  ``[resume] restored checkpoint``.  The best eval policy's actor goes
  to ``<outdir>/best`` as the reference writes it.

Telemetry, as in the reference: a console sink always (through
``log_fn``), ``--log-jsonl PATH`` streams schema'd records
(``run_header``, ``baseline``, ``train_round``, ``train_eval``,
``span`` "collect"/"eval"/"ckpt", ``run_end``) there and turns on the
round's device telemetry block (``replay_fill``, ``sla_hist``,
``reward_hist`` and ``committed`` in each ``train_round``; bit-neutral,
riding the round's one metrics transfer); ``--profile-dir DIR``
captures a ``torch.profiler`` trace of the training loop, its phases
marked by the ``relmas.*`` ranges of ``core.train``.

``--devices N`` shards the rounds over N devices, one process per
device (``core.train.make_sharded_train_rounds``): collection splits
the episode batch, each rank owns a double-buffered replay ring pair of
``--replay-capacity / N``, and every update gathers the rows each rank
sampled, so the learner state stays bit-equal on every rank.  The
driver checks the flags first (no churn; ``--batch-episodes``,
``--batch-size`` and ``--replay-capacity`` divisible by N;
``--episodes`` a multiple of ``--batch-episodes``; on ``cuda`` at most
``torch.cuda.device_count()`` devices), then spawns N ranks
(``torch.multiprocessing``, ``spawn``) that meet at a fresh ``file://``
rendezvous, deleted after the run: rank ``r`` on ``cuda:r`` under
NCCL, or on the CPU under gloo with ``--device cpu``.  Rank 0 alone
writes the log, the console (relayed through the parent's ``log_fn``),
the JSONL stream, the evaluations and the checkpoints; checkpoints are
single-device, so a run restores at any ``--devices``.  ``--fail-at``
fails every rank at the same chunk boundary, before any collective,
and the parent raises the same ``RuntimeError``.  ``--devices 1`` is
the plain path, the parity oracle.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.rl_train --workload light \\
      --episodes 150 --hidden 64 --batch-episodes 8 --outdir runs/light_med
  PYTHONPATH=src python -m repro_torch.launch.rl_train --device cpu \\
      --devices 2 --episodes 8 --batch-episodes 4 --outdir runs/cpu2
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import faulthandler
import json
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Callable

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.core import baselines as BL
from repro_torch.core import ddpg as D
from repro_torch.core import policy as P
from repro_torch.core.generalist import (GeneralistSpec, build_padded_envs,
                                         evaluate_generalist_batch,
                                         generalist_replay_init,
                                         generalist_rounds_host,
                                         make_sharded_generalist_rounds)
from repro_torch.core.replay import replay_init, replay_pair_init
from repro_torch.core.rollout import evaluate_batch, evaluate_batch_baseline
from repro_torch.core.train import (INFO_KEYS, MESH_AXIS, make_device_mesh,
                                    make_sharded_train_rounds, round_keys,
                                    shard_round_keys, train_rounds_host)
from repro_torch.sim.arrivals import ArrivalConfig
from repro_torch.sim.churn import CHURN_SCENARIOS, churn_preset
from repro_torch.sim.env import EnvConfig, SchedulingEnv
from repro_torch.telemetry import (ROUND_TELE_KEYS, console_line,
                                   make_telemetry, profile_trace)
from repro_torch.workloads import build_registry


@dataclasses.dataclass
class TrainConfig:
    workload: str = "light"
    # accelerator platform(s) (costmodel.fleets); a comma list trains a
    # fleet-conditioned generalist (core.generalist)
    fleet: str = "paper6"
    # auto | generalist | specialist (auto: generalist iff several fleets)
    policy_kind: str = "auto"
    m_max: int = 0             # generalist pad width (0 = widest fleet)
    # best-checkpoint selection: mean | min_fleet (generalist only:
    # maximin over the per-fleet eval SLA)
    best_metric: str = "mean"
    qos_level: str = "medium"
    qos_factor: float = 3.0
    load: float = 0.9
    scenario: str = "default"
    bandwidth_gbps: float = 0.0  # 0 = the fleet's dram_gbps
    t_s_us: float = 500.0
    periods: int = 60
    max_rq: int = 96
    max_jobs: int = 64
    hidden: int = 64
    episodes: int = 150
    batch_episodes: int = 8
    devices: int = 1           # >1: sharded rounds, one process a device
    # in-episode fleet-churn preset drawn fresh per round (sim.churn);
    # "none" keeps the static fleet
    churn: str = "none"
    updates_per_episode: int = 30
    batch_size: int = 32
    replay_capacity: int = 4000
    warmup_episodes: int = 5
    sigma0: float = 0.4
    sigma_min: float = 0.05
    sigma_decay: float = 0.97
    eval_every: int = 10
    eval_seeds: int = 5
    # comma list of baselines scored on the eval seeds before training
    # ("" = skip): fcfs, prema, herald, magma (the GA at
    # magma_population x magma_generations; paper settings 100 x 100)
    eval_baselines: str = ""
    magma_population: int = 24
    magma_generations: int = 12
    seed: int = 0
    outdir: str = "runs/relmas"
    ckpt_every: int = 10
    fail_at: int = -1          # crash injection (episode index) for FT tests
    # telemetry: "" disables the machine-readable stream; a path streams
    # schema'd JSONL records there AND turns on the round's device
    # telemetry block (bit-neutral, rides the round's metrics transfer)
    log_jsonl: str = ""
    # capture a torch.profiler trace of the training loop into this dir
    profile_dir: str = ""
    device: str = "cuda"       # cuda | cpu (the plain versions)


def _env_cfgs(cfg: TrainConfig) -> tuple[EnvConfig, ArrivalConfig]:
    ecfg = EnvConfig(t_s_us=cfg.t_s_us, periods=cfg.periods,
                     max_rq=cfg.max_rq, max_jobs=cfg.max_jobs,
                     bandwidth_gbps=cfg.bandwidth_gbps)
    arr = ArrivalConfig(max_jobs=cfg.max_jobs, load=cfg.load,
                        qos_factor=cfg.qos_factor, qos_level=cfg.qos_level,
                        horizon_us=ecfg.horizon_us,
                        slack_us=2.0 * cfg.t_s_us,
                        scenario=cfg.scenario)
    return ecfg, arr


def build_env(cfg: TrainConfig, fleet: str | None = None) -> SchedulingEnv:
    reg = build_registry(cfg.workload, mas=fleet or cfg.fleet)
    ecfg, arr = _env_cfgs(cfg)
    return SchedulingEnv(reg, ecfg, arr, device=cfg.device)


def _resolve_kind(cfg: TrainConfig) -> tuple[str, list[str]]:
    """-> (policy_kind, fleet list) with ``auto`` resolved."""
    fleets = [f.strip() for f in cfg.fleet.split(",") if f.strip()]
    kind = cfg.policy_kind
    if kind == "auto":
        kind = "generalist" if len(fleets) > 1 else "specialist"
    if kind not in ("generalist", "specialist"):
        raise ValueError(f"--policy-kind must be auto|generalist|"
                         f"specialist, got {cfg.policy_kind!r}")
    if kind == "specialist" and len(fleets) > 1:
        raise ValueError("a specialist policy is fleet-shaped: train "
                         "one per --fleet, or use "
                         "--policy-kind generalist for a multi-fleet run")
    if cfg.best_metric not in ("mean", "min_fleet"):
        raise ValueError(f"--best-metric must be mean|min_fleet, got "
                         f"{cfg.best_metric!r}")
    if cfg.best_metric == "min_fleet" and kind != "generalist":
        raise ValueError("--best-metric min_fleet needs per-fleet eval — "
                         "a generalist run (--fleet a,b,... or "
                         "--policy-kind generalist)")
    return kind, fleets


def _baseline_fns(cfg: TrainConfig) -> dict:
    """{name: baseline function} of ``--eval-baselines``."""
    out = {}
    for n in filter(None, (n.strip() for n in cfg.eval_baselines.split(","))):
        if n == "magma":
            out[n] = BL.make_magma_baseline(BL.MagmaConfig(
                population=cfg.magma_population,
                generations=cfg.magma_generations))
        elif n in BL.BASELINES:
            out[n] = BL.BASELINES[n]
        else:
            raise ValueError(f"unknown baseline {n!r}; pick from "
                             f"{sorted(BL.BASELINES) + ['magma']}")
    return out


def _check_devices(cfg: TrainConfig, churn_cfg) -> None:
    """``--devices``'s checks, the reference's, before any rank is
    spawned."""
    if cfg.devices < 1:
        raise ValueError(f"--devices must be >= 1, got {cfg.devices}")
    if cfg.devices == 1:
        return
    if churn_cfg is not None:
        raise ValueError("--churn is a single-device feature: the sharded "
                         "round bodies do not thread churn schedules; use "
                         "--devices 1")
    if torch.device(cfg.device).type == "cuda":
        n = torch.cuda.device_count()
        if cfg.devices > n:
            raise ValueError(
                f"--devices {cfg.devices} exceeds torch.cuda.device_count()"
                f" = {n}; use --devices {n} or fewer (--device cpu runs the "
                f"ranks on the CPU over gloo)")
    for knob, val in (("batch-episodes", cfg.batch_episodes),
                      ("batch-size", cfg.batch_size),
                      ("replay-capacity", cfg.replay_capacity)):
        if val % cfg.devices:
            raise ValueError(f"--{knob} {val} must be divisible by "
                             f"--devices {cfg.devices} (equal shards)")
    if cfg.episodes % cfg.batch_episodes:
        raise ValueError(
            f"--episodes {cfg.episodes} must be a multiple of "
            f"--batch-episodes {cfg.batch_episodes} when sharding (a "
            f"smaller tail round cannot split evenly over --devices "
            f"{cfg.devices})")


def _plan_chunks(cfg: TrainConfig, start_ep: int) -> list[dict]:
    """Group training rounds into chunks (the reference's planner, the
    single source of truth for cadence).

    A chunk is a run of consecutive rounds with the same episode batch
    size and no interior boundary; eval/ckpt cadence, the final round,
    a batch-size change (the tail round), and the crash-injection round
    all end (or, for ``fail_at``, start) a chunk.  Each chunk dict
    carries its rounds ``[(start_ep, n), ...]``, the first round's
    global index (for the seed stream), whether to raise the injected
    failure instead of running, and the boundary actions (``eval`` /
    ``ckpt``) the driver takes after it.
    """
    def crossed(every: int, s: int, ep: int) -> bool:
        return (ep + 1) // every > s // every

    chunks: list[dict] = []
    cur: list[tuple[int, int]] = []
    s = start_ep
    while s < cfg.episodes:
        n = min(cfg.batch_episodes, cfg.episodes - s)
        ep = s + n - 1
        fail_here = s <= cfg.fail_at <= ep
        if cur and (fail_here or n != cur[0][1]):
            chunks.append(dict(rounds=cur, fail=False, eval=False,
                               ckpt=False))
            cur = []
        cur.append((s, n))
        do_eval = crossed(cfg.eval_every, s, ep) or ep == cfg.episodes - 1
        do_ckpt = crossed(cfg.ckpt_every, s, ep)
        if fail_here or do_eval or do_ckpt:
            chunks.append(dict(rounds=cur, fail=fail_here,
                               eval=do_eval and not fail_here,
                               ckpt=do_ckpt and not fail_here))
            cur = []
        s += n
    if cur:
        chunks.append(dict(rounds=cur, fail=False, eval=False, ckpt=False))
    for c in chunks:
        c["round0"] = c["rounds"][0][0] // cfg.batch_episodes
    return chunks


def _resume(cfg: TrainConfig, mgr: CheckpointManager, state, dcfg,
            kind: str, log_fn):
    """-> (state, start episode) from the latest checkpoint, or
    (state, 0) without one."""
    step = mgr.latest_step()
    if step is None:
        return state, 0
    try:
        tree, step, meta = mgr.restore(state, step)
    except ValueError as e:
        # policy shapes follow --hidden, --policy-kind and the fleet's
        # num_sas (or --m-max)
        raise ValueError(
            f"checkpoint in {cfg.outdir} does not match this run's "
            f"policy shapes — resume with the --hidden/--fleet/"
            f"--policy-kind it was trained with (this run: --hidden "
            f"{cfg.hidden} --fleet {cfg.fleet} [{kind}]) or use a fresh "
            f"--outdir [{e}]") from None
    ck_kind = meta.get("policy_kind", "specialist")
    ck_fleet = meta.get("fleet", "paper6")
    if ck_kind != kind:
        raise ValueError(f"checkpoint in {cfg.outdir} is {ck_kind!r} but "
                         f"this run is {kind!r}; use a fresh --outdir")
    if kind == "generalist":
        # fleet-independent by construction: any fleet list continues
        if ck_fleet != cfg.fleet:
            log_fn(f"[resume] generalist checkpoint trained on "
                   f"{ck_fleet!r}, continuing on {cfg.fleet!r}")
    elif ck_fleet != cfg.fleet:
        # per-fleet checkpoints stay platform-locked
        raise ValueError(
            f"checkpoint in {cfg.outdir} was trained on fleet "
            f"{ck_fleet!r} but --fleet is {cfg.fleet!r}; use a fresh "
            f"--outdir to train a {cfg.fleet!r} agent")
    state = D.ddpg_state_from_numpy(tree, dcfg, device=cfg.device)
    return state, meta.get("episode", 0) + 1


@dataclasses.dataclass(frozen=True)
class Run:
    """What a specialist or a generalist run trains with
    (:func:`_build_run`)."""
    env: SchedulingEnv            # the (first) training env
    envs: list                    # the training envs (a generalist's fleets)
    spec: GeneralistSpec | None   # None for a specialist
    dcfg: D.DDPGConfig
    fleets: list[str]
    churn: object                 # a ChurnConfig or None
    meta: dict                    # checkpoint meta
    baseline_envs: list           # unpadded envs the baselines score on
    evaluate: Callable            # (params, seeds) -> mean metrics
    rounds: Callable              # (state, buf, keys, sigma, flags, **kw)
    replay_init: Callable         # capacity -> replay ring (or ring pair)

    @property
    def pcfg(self) -> P.PolicyConfig:
        return self.dcfg.policy


def _train_loop(cfg: TrainConfig, run: Run, state, start_ep: int,
                mgr: CheckpointManager, logf, tele, mesh=None):
    """The chunks of rounds with their eval and checkpoint boundaries,
    reported through the telemetry session ``tele``.  Sharded (``mesh``
    given), rank 0 alone evaluates and checkpoints (its replica is the
    learner state) and every rank waits at a boundary with either, so
    a failure injected at the next chunk finds the checkpoint written.
    Returns (state, best eval, history)."""
    lead = mesh is None or mesh.get_rank() == 0
    eval_seeds = range(7000, 7000 + cfg.eval_seeds)
    buf = run.replay_init(cfg.replay_capacity)
    best = {"sla_rate": -1.0}
    history = []
    sigma = float(np.float32(max(cfg.sigma_min,
                                 cfg.sigma0 * cfg.sigma_decay ** start_ep)))

    for chunk in _plan_chunks(cfg, start_ep):
        if chunk["fail"]:       # every rank, before any collective
            raise RuntimeError(f"injected failure at episode {cfg.fail_at}")
        rounds = chunk["rounds"]
        n = rounds[0][1]
        flags = [s + m > cfg.warmup_episodes for s, m in rounds]
        keys = round_keys(cfg.seed + 1, chunk["round0"], len(rounds))
        kw = dict(batch_episodes=n, num_updates=cfg.updates_per_episode * n,
                  batch_size=cfg.batch_size, sigma_min=cfg.sigma_min,
                  sigma_decay=cfg.sigma_decay,
                  telemetry=bool(cfg.log_jsonl))
        if run.churn is not None:
            kw["churn"] = run.churn
        t0 = time.perf_counter()
        # span "collect": the rounds INCLUDING their metrics transfer
        with tele.span("collect", episodes=int(sum(m for _, m in rounds))):
            state, buf, sigma, mets = run.rounds(state, buf, keys, sigma,
                                                 flags, **kw)
        # the metrics are host floats: the chunk's work has finished
        elapsed = max(time.perf_counter() - t0, 1e-9)
        pps = round(sum(m for _, m in rounds) * cfg.periods / elapsed, 1)
        for i, (rs, rn) in enumerate(rounds):
            ep = rs + rn - 1
            rec = dict(episode=ep, batch_episodes=rn,
                       sla=round(float(mets["sla"][i]), 4),
                       sigma=round(float(mets["sigma"][i]), 4),
                       periods_per_sec=pps,
                       secs=round(elapsed / len(rounds), 3))
            if "fleet" in mets:     # generalist: the round's fleet
                rec["fleet"] = run.fleets[int(mets["fleet"][i])]
            if mets["did_update"][i]:
                rec.update({k: round(float(mets[k][i]), 5)
                            for k in INFO_KEYS})
            history.append(rec)
            logf.write(json.dumps(rec) + "\n")
            emit = dict(rec)
            if all(k in mets for k in ROUND_TELE_KEYS):
                # the device block, on the host through the round's one
                # metrics transfer: no added sync
                emit.update(
                    replay_fill=round(float(mets["tele_replay_fill"][i]), 4),
                    sla_hist=[int(x) for x in mets["tele_sla_hist"][i]],
                    reward_hist=[int(x) for x in mets["tele_reward_hist"][i]],
                    committed=int(mets["tele_committed"][i]))
            tele.emit("train_round", **emit)
        logf.flush()

        # chunk boundary: eval / best checkpoint / periodic checkpoint
        rs, rn = rounds[-1]
        ep = rs + rn - 1
        if chunk["eval"] and lead:
            with tele.span("eval"):
                ev = run.evaluate(state.actor, eval_seeds)
            history[-1]["eval_sla"] = round(ev["sla_rate"], 4)
            evrec = {"episode": ep, "eval_sla": history[-1]["eval_sla"]}
            if "per_fleet" in ev:
                history[-1]["eval_sla_per_fleet"] = ev["per_fleet"]
                evrec["eval_sla_per_fleet"] = ev["per_fleet"]
            logf.write(json.dumps(evrec) + "\n")
            logf.flush()
            tele.emit("train_eval", **evrec)
            score = (min(ev["per_fleet"].values())
                     if cfg.best_metric == "min_fleet" else ev["sla_rate"])
            if score > best.get("score", -1.0):
                best = {**ev, "episode": ep, "score": score}
                CheckpointManager(os.path.join(cfg.outdir, "best"),
                                  keep=1).save(
                    ep, state.actor,
                    dict(episode=ep, sla=ev["sla_rate"], **run.meta))
        if chunk["ckpt"] and lead:
            # single-device tensors: a run restores at any --devices
            with tele.span("ckpt"):
                mgr.save(ep, state, dict(episode=ep, **run.meta))
        if mesh is not None and (chunk["eval"] or chunk["ckpt"]):
            import torch.distributed as dist
            dist.barrier(group=mesh.get_group(MESH_AXIS))
    return state, best, history


def _build_run(cfg: TrainConfig, kind: str, fleets: list[str],
               churn_cfg, mesh=None) -> Run:
    """The run's env(s), policy config, replay, round and eval functions
    and checkpoint meta, for a specialist or a generalist run; sharded
    over ``mesh`` when given (rounds of ``make_sharded_*_rounds``, a
    ring pair of ``replay_capacity / D`` a rank)."""
    ecfg, arr = _env_cfgs(cfg)
    if kind == "generalist":
        envs = build_padded_envs(cfg.workload, fleets, ecfg, arr,
                                 m_max=cfg.m_max or None, device=cfg.device)
        spec = GeneralistSpec(m_max=envs[0].num_sas)
        pcfg = spec.pcfg(hidden=cfg.hidden)
    else:
        envs, spec = [build_env(cfg)], None
        pcfg = P.PolicyConfig(feat_dim=envs[0].feat_dim,
                              act_dim=envs[0].act_dim, hidden=cfg.hidden)
    env, dcfg = envs[0], D.DDPGConfig(policy=pcfg)
    meta = dict(fleet=cfg.fleet, policy_kind=kind, hidden=cfg.hidden,
                feat_dim=pcfg.feat_dim, act_dim=pcfg.act_dim,
                churn=cfg.churn)
    if spec is None:
        ring = lambda cap: replay_init(cap, env.seq_len, env.feat_dim,
                                       env.act_dim, env.device)
        rounds = lambda *a, **kw: train_rounds_host(env, dcfg, *a, **kw)
    else:
        ring = lambda cap: generalist_replay_init(cap, env.seq_len, spec,
                                                  env.device)
        rounds = lambda *a, **kw: generalist_rounds_host(envs, dcfg, *a,
                                                         **kw)
    if mesh is not None:
        ndev = mesh.size()
        plain_ring = ring
        ring = lambda cap: replay_pair_init(
            plain_ring(cap // ndev), (cfg.batch_episodes // ndev)
            * cfg.periods)
        if spec is None:
            rounds = lambda state, pair, keys, sigma, flags, **kw: \
                make_sharded_train_rounds(env, dcfg, mesh=mesh, **kw)(
                    state, pair, shard_round_keys(keys, ndev), sigma, flags)
        else:
            rounds = lambda state, pair, keys, sigma, flags, **kw: \
                make_sharded_generalist_rounds(envs, dcfg, mesh=mesh, **kw)(
                    state, pair, shard_round_keys(keys, ndev), keys, sigma,
                    flags)
    common = dict(env=env, envs=envs, spec=spec, dcfg=dcfg, fleets=fleets,
                  churn=churn_cfg, rounds=rounds, replay_init=ring)
    if spec is None:
        return Run(
            **common, meta=meta, baseline_envs=envs,
            evaluate=lambda params, seeds: evaluate_batch(env, pcfg, params,
                                                          seeds))

    def evaluate(params, seeds):
        """Mean metrics across every training fleet (+ per fleet)."""
        per = {f: evaluate_generalist_batch(e, pcfg, params, seeds)
               for f, e in zip(fleets, envs)}
        mean = {k: float(np.mean([m[k] for m in per.values()]))
                for k in next(iter(per.values()))}
        mean["per_fleet"] = {f: round(m["sla_rate"], 4)
                             for f, m in per.items()}
        return mean
    # the heuristics and MAGMA act on raw slot tables: each fleet's
    # unpadded env (padding columns would skew cost-greedy choices)
    return Run(
        **common, meta=dict(meta, m_max=spec.m_max, desc_dim=spec.desc_dim,
                            fleets=fleets),
        baseline_envs=[build_env(cfg, f) for f in fleets],
        evaluate=evaluate)


def _checked(cfg: TrainConfig):
    """Every flag check, before anything is built or spawned.  Returns
    (churn config or None, baseline functions, policy kind, fleets)."""
    if cfg.batch_episodes < 1:
        raise ValueError(f"--batch-episodes must be >= 1, "
                         f"got {cfg.batch_episodes}")
    if cfg.batch_episodes * cfg.periods > cfg.replay_capacity:
        # one ring write cannot wrap the buffer more than once
        raise ValueError(
            f"a collection round writes batch_episodes * periods = "
            f"{cfg.batch_episodes * cfg.periods} transitions, which must "
            f"fit --replay-capacity ({cfg.replay_capacity})")
    if cfg.churn not in CHURN_SCENARIOS:
        raise ValueError(f"--churn must be one of "
                         f"{'|'.join(CHURN_SCENARIOS)}, got {cfg.churn!r}")
    churn_cfg = None if cfg.churn == "none" else churn_preset(cfg.churn)
    _check_devices(cfg, churn_cfg)
    baselines = _baseline_fns(cfg)
    kind, fleets = _resolve_kind(cfg)
    return churn_cfg, baselines, kind, fleets


def train(cfg: TrainConfig, log_fn=console_line) -> dict:
    """Train as ``cfg`` says.  ``log_fn`` writes the console lines (the
    console sink's writer; a test passes a capture).  With ``--devices
    N > 1`` the rounds run on N spawned ranks (:func:`spawn_ranks`) and
    this returns rank 0's result."""
    checked = _checked(cfg)
    if cfg.devices > 1:
        return _train_sharded(cfg, log_fn, checked)
    return _train(cfg, log_fn, checked)


def _train(cfg: TrainConfig, log_fn, checked, mesh=None) -> dict:
    """The run on this process: the whole of it, or this rank's part of
    a sharded one (``mesh`` given; rank 0 alone writes and logs)."""
    churn_cfg, baselines, kind, fleets = checked
    lead = mesh is None or mesh.get_rank() == 0
    run = _build_run(cfg, kind, fleets, churn_cfg, mesh)
    # the telemetry session: console always (through log_fn), the JSONL
    # stream when --log-jsonl was given; rank 0's alone when sharded
    tele = make_telemetry(log_fn=log_fn if lead else (lambda line: None),
                          jsonl_path=(cfg.log_jsonl or None) if lead
                          else None)
    tele.run_header("train", dataclasses.asdict(cfg), device=cfg.device)
    if run.spec is not None:
        tele.note(f"[generalist] fleets={','.join(fleets)} "
                  f"m_max={run.spec.m_max} desc_dim={run.spec.desc_dim} "
                  f"feat_dim={run.pcfg.feat_dim}")
    seen = (torch.cuda.device_count()
            if torch.device(cfg.device).type == "cuda" else 0)
    if cfg.devices < seen:
        tele.note(f"[note] {seen} local devices; pass --devices N to shard "
                  f"the rounds over them")
    state = D.init_ddpg(torch.Generator().manual_seed(cfg.seed), run.dcfg,
                        device=cfg.device)
    mgr = CheckpointManager(os.path.join(cfg.outdir, "ckpt"))
    state, start_ep = _resume(cfg, mgr, state, run.dcfg, kind, tele.note)
    if start_ep:
        tele.note(f"[resume] restored checkpoint at episode {start_ep - 1}")

    eval_seeds = range(7000, 7000 + cfg.eval_seeds)
    baseline_scores: dict[str, dict] = {}
    for name, fn in (baselines if lead else {}).items():
        ms = [evaluate_batch_baseline(e, fn, eval_seeds)
              for e in run.baseline_envs]
        m = {k: float(np.mean([x[k] for x in ms])) for k in ms[0]}
        baseline_scores[name] = {k: round(v, 4) for k, v in m.items()}
        tele.emit("baseline", name=name, sla_rate=round(m["sla_rate"], 4))

    os.makedirs(cfg.outdir, exist_ok=True)
    log_path = os.path.join(cfg.outdir, "log.jsonl") if lead else os.devnull
    with open(log_path, "a") as logf, \
            profile_trace(cfg.profile_dir if lead else "", cfg.device):
        if baseline_scores:
            logf.write(json.dumps({"baselines": baseline_scores}) + "\n")
            logf.flush()
        state, best, history = _train_loop(cfg, run, state, start_ep, mgr,
                                           logf, tele, mesh)
    tele.emit("run_end", best_sla=round(float(best.get("sla_rate", -1.0)), 4))
    tele.close()
    return dict(best=best, history=history, env=run.env, pcfg=run.pcfg,
                state=state, baselines=baseline_scores, policy_kind=kind,
                fleets=fleets, spec=run.spec)


# ---------------------------------------------------------------------------
# --devices N: one spawned process a device
# ---------------------------------------------------------------------------
# a rank waits this long in a collective for a slower peer before the
# process group gives up (a round at full size is seconds)
PG_TIMEOUT_S = 900
# after one rank has failed, the others get this long to reach their own
# end (rank 0 finishing a checkpoint) before they are killed
FAIL_GRACE_S = 120


def _state_to_numpy(state: D.DDPGState) -> dict:
    """The learner state as NumPy leaves by field name (what
    ``ddpg_state_from_numpy`` reads back), to cross a process
    boundary."""
    return {f.name: (D.tree_map(lambda t: t.detach().cpu().numpy(),
                                getattr(state, f.name))
                     if f.name != "step" else state.step)
            for f in dataclasses.fields(state)}


def _rank_entry(rank: int, nprocs: int, init_method: str, backend: str,
                device: str, threads: int, entry, args, out) -> None:
    """A spawned rank: join the process group, run
    ``entry(rank, relay, *args)`` (``relay(line)`` sends a console line
    to the parent), send its return value (or its exception) to the
    parent through ``out``."""
    try:
        faulthandler.enable()           # a crash prints the rank's stack
        torch.set_num_threads(threads)
        bind = {}
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
            if backend == "nccl":       # the rank's card for its barriers
                bind["device_id"] = torch.device(
                    "cuda", torch.cuda.current_device())
        import torch.distributed as dist
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=nprocs,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S), **bind)
        try:
            res = entry(rank, lambda line: out.put(("log", rank, line)),
                        *args)
        finally:
            dist.destroy_process_group()
        out.put(("result", rank, pickle.dumps(res)))
    except BaseException as e:
        try:
            blob = pickle.dumps(e)
        except Exception:
            blob = pickle.dumps(RuntimeError(f"{type(e).__name__}: {e}"))
        out.put(("error", rank, (blob, traceback.format_exc())))
        raise SystemExit(1)


def spawn_ranks(entry, nprocs: int, *args, device: str = "cuda",
                backend: str | None = None, timeout: float | None = None,
                log_fn=console_line) -> list:
    """Run ``entry(rank, relay, *args)`` on ``nprocs`` spawned ranks
    (``torch.multiprocessing``, ``spawn``) joined in one process group
    at a fresh ``file://`` rendezvous (deleted after the run); returns
    every rank's return value, in rank order.

    ``entry`` must be a module-level function of this package (a
    spawned rank imports it, and so neither a test nor JAX).  The
    backend is NCCL for ``cuda`` and gloo for ``cpu`` unless ``backend``
    says otherwise (gloo on ``cuda`` lets ranks share a card, each on
    ``cuda:(rank % device_count)``).  Console lines a rank sends through
    its ``relay`` reach ``log_fn`` as they come.  A rank's exception is
    raised here (the lowest failed rank's, with its traceback as a
    note) once every rank has ended, or ``FAIL_GRACE_S`` after the first
    failure; past ``timeout`` seconds every rank is killed and
    ``TimeoutError`` raised."""
    import torch.multiprocessing as mp
    backend = backend or ("nccl" if torch.device(device).type == "cuda"
                          else "gloo")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="rendezvous-")
    init = "file://" + os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(r, nprocs, init, backend, device,
                               torch.get_num_threads(), entry, args, out))
             for r in range(nprocs)]
    results, errors = {}, {}
    t0, failed = time.monotonic(), None

    def drain(wait: float) -> None:
        try:
            kind, rank, val = out.get(timeout=wait)
        except queue_mod.Empty:
            return
        if kind == "log":
            log_fn(val)
        elif kind == "result":
            results[rank] = pickle.loads(val)
        else:
            errors[rank] = val

    try:
        for p in procs:
            p.start()
        while any(p.is_alive() for p in procs):
            drain(0.1)
            now = time.monotonic()
            if failed is None and (errors or any(
                    p.exitcode not in (None, 0) for p in procs)):
                failed = now
            if timeout is not None and now - t0 > timeout:
                raise TimeoutError(f"{nprocs} ranks still running after "
                                   f"{timeout} s: killed")
            if failed is not None and now - failed > FAIL_GRACE_S:
                break
        # what the ranks sent before they ended is in the queue's pipe
        end = time.monotonic() + 10
        while len(results) + len(errors) < nprocs \
                and time.monotonic() < end:
            drain(0.1)
    finally:
        for p in procs:
            if p.pid is None:           # never started
                continue
            if p.is_alive():
                p.kill()
            p.join()
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        rank = min(errors)
        blob, tb = errors[rank]
        exc = pickle.loads(blob)
        exc.add_note(f"(rank {rank} of {nprocs})\n{tb}")
        raise exc
    if len(results) != nprocs:
        codes = [p.exitcode for p in procs]
        raise RuntimeError(f"ranks ended with exit codes {codes} and "
                           f"{len(results)} results")
    return [results[r] for r in range(nprocs)]


def _train_rank(rank: int, relay, cfg: TrainConfig):
    """One rank of a sharded ``train``: this rank's part on a mesh over
    the process group; rank 0 returns its result (the state as NumPy)."""
    res = _train(cfg, relay, _checked(cfg), make_device_mesh())
    if rank:
        return None
    keep = ("best", "history", "baselines", "policy_kind", "fleets")
    return dict({k: res[k] for k in keep},
                state=_state_to_numpy(res["state"]))


def _train_sharded(cfg: TrainConfig, log_fn, checked) -> dict:
    """``train`` at ``--devices N > 1``: N ranks, rank 0's result with
    the env, policy config and spec built here."""
    (out,) = spawn_ranks(_train_rank, cfg.devices, cfg, device=cfg.device,
                         log_fn=log_fn)[:1]
    churn_cfg, _, kind, fleets = checked
    run = _build_run(cfg, kind, fleets, churn_cfg)
    return dict(out, state=D.ddpg_state_from_numpy(out["state"], run.dcfg,
                                                   device=cfg.device),
                env=run.env, pcfg=run.pcfg, spec=run.spec)


def sharded_rounds_rank(rank: int, relay, jobs: list) -> list:
    """One rank of chunks of sharded rounds from given inputs (the
    tests' and ``chip_smoke.py``'s harness of
    ``make_sharded_train_rounds``), one chunk a job, in turn on the same
    process group.  A job holds ``cfg`` (a :class:`TrainConfig`: envs,
    widths, ``device``), ``kind``, ``state`` (NumPy,
    :func:`_state_to_numpy`), ``keys`` (the R round seeds), ``sigma``,
    ``flags`` and ``kw`` (the rounds' keywords).  Returns, a job each,
    this rank's learner state and ring pair (NumPy), its metrics, its
    ``lstm_cell`` launches, the seconds of its set-up and of its rounds,
    and the modules of JAX, ``repro`` or a test it has loaded (none)."""
    import sys

    import torch.distributed as dist

    from repro_torch.kernels.lstm_cell import ops as cell_ops
    mesh = make_device_mesh()
    np_tree = lambda t: {k: (np_tree(v) if isinstance(v, dict) else
                             v.cpu().numpy() if torch.is_tensor(v) else v)
                         for k, v in t.items()}
    out = []
    for job in jobs:
        t0 = time.perf_counter()
        cfg = job["cfg"]
        run = _build_run(cfg, job["kind"], cfg.fleet.split(","), None, mesh)
        state = D.ddpg_state_from_numpy(job["state"], run.dcfg,
                                        device=cfg.device)
        pair = run.replay_init(cfg.replay_capacity)
        cell_ops.LAUNCHES = 0
        if run.env.device.type == "cuda":
            torch.cuda.synchronize()
        # the ranks start their rounds together: a rank's wall time then
        # leaves out its peers' start-up
        dist.barrier(group=mesh.get_group(MESH_AXIS))
        t1 = time.perf_counter()
        state, pair, sigma, mets = run.rounds(state, pair, job["keys"],
                                              job["sigma"], job["flags"],
                                              **job["kw"])
        if run.env.device.type == "cuda":
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
            "jax", "repro", "tests") or m.split(".")[-1].startswith("test_"))
        out.append(dict(state=_state_to_numpy(state), pair=np_tree(pair),
                        sigma=sigma, metrics=mets,
                        launches=cell_ops.LAUNCHES, setup_s=t1 - t0,
                        secs=t2 - t1, loaded=loaded))
    return out


_HELP = {
    "workload": "tenant set: light | heavy | mixed (workloads.cnn_zoo)",
    "fleet": "accelerator-fleet preset(s) (repro_torch.costmodel.fleets): "
             "paper6, 4simba_4eyeriss, 8simba, 8eyeriss, 2simba_6eyeriss, "
             "big_little, ...; one name = per-fleet specialist, a comma "
             "list = fleet-conditioned generalist (one fleet sampled per "
             "round)",
    "policy_kind": "auto | generalist | specialist (auto: generalist iff "
                   "several fleets; generalist checkpoints restore on any "
                   "fleet with num_sas <= m_max)",
    "m_max": "generalist SA-channel pad width (0 = widest requested fleet)",
    "best_metric": "best-checkpoint selection: mean | min_fleet (maximin "
                   "over per-fleet eval SLA; generalist runs only)",
    "scenario": "arrival preset: default | steady | burst | diurnal | "
                "heavy_tail (sim.arrivals)",
    "batch_episodes": "episodes collected per training round",
    "devices": "shard each round over N devices, one spawned process a "
               "device (collection splits, each update gathers a global "
               "minibatch from every rank's ring, per-rank double-"
               "buffered replay rings); batch-episodes, batch-size and "
               "replay-capacity divisible by N, episodes a multiple of "
               "batch-episodes, no --churn, and on cuda N <= "
               "torch.cuda.device_count() (NCCL; --device cpu: gloo); "
               "1 = the single-device path (parity oracle)",
    "churn": "in-episode fleet-churn preset drawn fresh per round: none | "
             "fail | throttle | slowdown | join | mixed (sim.churn)",
    "eval_baselines": 'comma list scored on the eval seeds before '
                      'training, e.g. "fcfs,herald,magma" ("" = skip)',
    "fail_at": "inject a crash at this episode (fault-tolerance tests)",
    "log_jsonl": "stream schema'd JSONL telemetry records to this path and "
                 "enable the round's device telemetry block (bit-neutral; "
                 "validate/render with scripts/metrics_summary.py)",
    "profile_dir": "capture a torch.profiler trace of the training loop "
                   "into this directory (view in TensorBoard/Perfetto)",
    "device": "cuda (kernels; raises without a GPU) or cpu (plain "
              "versions)",
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="RELMAS DDPG training driver (PyTorch)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    for f in dataclasses.fields(TrainConfig):
        ap.add_argument(f"--{f.name.replace('_', '-')}", type=type(f.default),
                        default=f.default, help=_HELP.get(f.name, " "))
    cfg = TrainConfig(**vars(ap.parse_args(argv)))
    console_line(f"RELMAS DDPG training: {cfg}")
    out = train(cfg)
    console_line(f"best eval: {out['best']}")
    return out


if __name__ == "__main__":
    main()
