"""Periodic-scheduling environment (paper Sec. 4.1, Fig. 2a), batch-first.

The counterpart of the JAX package's ``sim/env.py``: every array carries
an explicit leading stream axis ``S`` where the JAX code ``vmap``s.
Per-job state (next layer to schedule, ready time, flags) is kept and
the ready queue (RQ) is *derived* each period by packing the
uncommitted layers of active jobs — sorted by absolute deadline, the
order the paper feeds the LSTM — into ``max_rq`` slots.  A job's layers
occupy contiguous ascending slots, so precedence reduces to
``dep[i] = i-1`` within a job.

Each period:
  1. deadline-passed jobs are dropped (whole remaining job = SLA miss);
  2. the RQ is built from jobs arrived by ``t`` + residuals;
  3. the policy (or a heuristic) emits (priority, SA) per slot;
  4. the engine simulates the horizon; SJs *started* before
     ``t + T_s`` commit (non-preemptive), the rest become residuals;
  5. the paper reward is computed from the projected finish times;
  6. the transition's next state encodes the residual RQ only.

Tables: ``lat``/``bw``/``en``/``n_layers`` are float32/int64 tensors on
the env's device.  ``min_lat`` stays a host NumPy float32 array, because
host code (trace and load generation) reads it with ``np.asarray``.

:meth:`SchedulingEnv.episode` runs all periods of a batch of episodes
(the JAX package's ``lax.scan`` over periods inside ``vmap`` over
episodes becomes a Python loop over periods on the stream axis), with
the final drop pass and the metrics; :meth:`new_episodes` draws the
traces with NumPy on the host and :meth:`new_episodes_torch` with a
``torch.Generator`` on the device.

Fleet churn (``repro_torch.sim.churn``) enters as data: ``episode``
takes a compiled schedule with ``(S, periods, M)`` leaves and
``period`` one ``(S, M)`` row of it, injected into the state that
:meth:`SchedulingEnv.build_slots` and the policy see, and stripped from
the state it returns.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.costmodel.registry import Registry
from repro_torch.device import resolve_device
from repro_torch.sim import engine
from repro_torch.sim.arrivals import (ArrivalConfig, generate_traces,
                                      generate_traces_torch)
from repro_torch.sim.engine import INF
from repro_torch.telemetry.profiler import span

State = dict[str, Any]
Trace = dict[str, Any]
Slots = dict[str, Any]

F32 = torch.float32
I64 = torch.int64

# advertised cost of an SA that is invalid this period (failed, or not
# yet joined — see repro_torch.sim.churn): large enough that selecting
# it is an unmissable SLA miss, finite so the `* zero` slot masking in
# build_slots stays NaN-free (INF * 0 = NaN).  The padding poison
# PAD_LAT_US of repro_torch.core.generalist.env has the same value.
CHURN_POISON_US = 1.0e7

# state keys injected by `period` when a churn row is threaded; they are
# visible to build_slots / act_fns and stripped from the returned state
_CHURN_KEYS = ("sa_valid", "lat_mult", "bw_mult")


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    t_s_us: float = 500.0        # scheduling period T_S
    periods: int = 60            # episode length (last ~40% drains arrivals)
    max_rq: int = 96             # R: RQ slot capacity presented to the policy
    max_jobs: int = 64           # J
    # shared DRAM bandwidth; 0 = take the fleet's dram_gbps from the
    # registry's MASConfig (repro_torch.costmodel.fleets)
    bandwidth_gbps: float = 0.0
    # reward coefficients (paper Sec. 5)
    alpha: float = 0.10
    beta: float = 0.11
    gamma_r: float = 0.05
    delta: float = 0.01
    # feature normalization
    ttd_norm_periods: float = 8.0

    @property
    def horizon_us(self) -> float:
        return 0.6 * self.t_s_us * self.periods


class SchedulingEnv:
    """Binds a model Registry (tables) + EnvConfig into batched step
    functions on one device."""

    def __init__(self, registry: Registry, cfg: EnvConfig,
                 arrivals: ArrivalConfig | None = None, *,
                 device: str | torch.device = "cuda"):
        if cfg.bandwidth_gbps <= 0:  # resolve "fleet default" once, here
            cfg = dataclasses.replace(cfg,
                                      bandwidth_gbps=registry.mas.dram_gbps)
        self.cfg = cfg
        self.registry = registry
        self.device = resolve_device(device)
        d = registry.dense()
        self.num_models = d["num_models"]
        self.lmax = d["lmax"]
        self.num_sas = d["num_sas"]
        dev = self.device
        self.lat = torch.as_tensor(d["lat"], dtype=F32, device=dev)
        self.bw = torch.as_tensor(d["bw"], dtype=F32, device=dev)
        self.en = torch.as_tensor(d["en"], dtype=F32, device=dev)
        self.n_layers = torch.as_tensor(d["n_layers"], dtype=I64, device=dev)
        self.min_lat = np.asarray(d["min_lat"], np.float32)   # host copy
        self.arrivals = arrivals or ArrivalConfig(
            max_jobs=cfg.max_jobs, horizon_us=cfg.horizon_us,
            slack_us=2.0 * cfg.t_s_us)
        self.feat_dim = 4 + 2 * self.num_sas
        self.act_dim = 1 + self.num_sas
        self.seq_len = cfg.max_rq + 1          # + primer

    # ---------------- episode setup ----------------
    def to_trace(self, tr: dict) -> Trace:
        """Trace dict (NumPy arrays or tensors, leading stream axis) ->
        device trace with the per-job layer count ``njl``."""
        dev = self.device

        def col(k, dt):
            if isinstance(tr[k], torch.Tensor):
                return tr[k].to(device=dev, dtype=dt)
            return torch.tensor(np.asarray(tr[k]), dtype=dt, device=dev)
        trace = dict(arrival=col("arrival", F32), deadline=col("deadline", F32),
                     q=col("q", F32), model=col("model", I64))
        trace["njl"] = self.n_layers[trace["model"]]
        return trace

    def new_episodes(self, rng: np.random.Generator, batch: int,
                     arrivals: ArrivalConfig | None = None
                     ) -> tuple[Trace, State]:
        """``batch`` fresh traces drawn with NumPy on the host (the
        arrival-process oracle), and their initial states."""
        trace = self.to_trace(generate_traces(
            self.min_lat, arrivals or self.arrivals, rng, batch))
        return trace, self.init_state(trace)

    def new_episodes_torch(self, gen: torch.Generator, batch: int,
                           arrivals: ArrivalConfig | None = None
                           ) -> tuple[Trace, State]:
        """:meth:`new_episodes` drawn from ``gen`` on the env's device
        (``generate_traces_torch``): no host work per round."""
        trace = self.to_trace(generate_traces_torch(
            self.min_lat, arrivals or self.arrivals, gen, batch,
            self.device))
        return trace, self.init_state(trace)

    def init_state(self, trace: Trace) -> State:
        """Fresh per-stream state for a ``(S, J)`` trace."""
        S, J = trace["arrival"].shape
        dev = self.device
        return dict(
            nls=torch.zeros((S, J), dtype=I64, device=dev),
            jready=trace["arrival"].clone(),
            missed=torch.zeros((S, J), dtype=torch.bool, device=dev),
            done=torch.zeros((S, J), dtype=torch.bool, device=dev),
            hit=torch.zeros((S, J), dtype=torch.bool, device=dev),
            fjob=torch.full((S, J), INF, dtype=F32, device=dev),
            sa_free=torch.zeros((S, self.num_sas), dtype=F32, device=dev),
            t=torch.zeros((S,), dtype=F32, device=dev),
            energy=torch.zeros((S,), dtype=F32, device=dev),
        )

    # ---------------- batched step pieces ----------------
    def mark_drops(self, state: State, trace: Trace, now) -> State:
        now = torch.as_tensor(now, dtype=F32, device=self.device)
        now = now.expand(trace["arrival"].shape[0])[:, None]
        overdue = ((trace["arrival"] <= now) & ~state["done"]
                   & ~state["missed"] & (trace["deadline"] < now))
        return {**state, "missed": state["missed"] | overdue}

    def build_slots(self, state: State, trace: Trace, cutoff) -> Slots:
        """Pack uncommitted layers of active jobs into R slots by deadline."""
        R, J = self.cfg.max_rq, self.cfg.max_jobs
        dev = self.device
        S = trace["arrival"].shape[0]
        cutoff = torch.as_tensor(cutoff, dtype=F32, device=dev)
        cutoff = cutoff.expand(S)[:, None]
        active = ((trace["arrival"] <= cutoff) & ~state["done"]
                  & ~state["missed"])
        rem = torch.where(active, trace["njl"] - state["nls"], 0)
        key = torch.where(active & (rem > 0), trace["deadline"], INF)
        # stable, as jnp.argsort: padded jobs tie at INF
        order = torch.argsort(key, dim=1, stable=True)           # (S, J)
        rem_o = torch.gather(rem, 1, order)
        cum = torch.cumsum(rem_o, dim=1)
        starts = cum - rem_o
        total = cum[:, -1:]
        i = torch.arange(R, dtype=I64, device=dev).expand(S, R)
        k = torch.searchsorted(cum, i.contiguous(), right=True)
        k = k.clamp(0, J - 1)
        valid = i < torch.clamp(total, max=R)
        job = torch.where(valid, torch.gather(order, 1, k), 0)
        layer = torch.where(valid, torch.gather(state["nls"], 1, job)
                            + (i - torch.gather(starts, 1, k)), 0)
        layer = layer.clamp(0, self.lmax - 1)
        prev_same = torch.zeros_like(valid)
        prev_same[:, 1:] = ((job[:, 1:] == job[:, :-1]) & valid[:, 1:]
                            & valid[:, :-1])
        dep = torch.where(prev_same, i - 1, -1)
        model = torch.gather(trace["model"], 1, job)
        ready_rel = torch.where(
            dep < 0, torch.clamp(torch.gather(state["jready"], 1, job)
                                 - state["t"][:, None], min=0.0), 0.0)
        cost_all = self.lat[model, layer]              # (S, R, M)
        bw_all = self.bw[model, layer]
        en_all = self.en[model, layer]
        # in-episode churn (rows injected by `period`): a slowed SA
        # advertises scaled busy times, a throttled SA scaled bus
        # demand, an invalid SA the poison cost.  At the no-op row all
        # three are bit-exact identities (x * 1.0, where(True, x, _)).
        lat_mult = state.get("lat_mult")
        if lat_mult is not None:
            cost_all = cost_all * lat_mult[:, None, :]
        bw_mult = state.get("bw_mult")
        if bw_mult is not None:
            bw_all = bw_all * bw_mult[:, None, :]
        sa_valid = state.get("sa_valid")
        if sa_valid is not None:
            cost_all = torch.where(sa_valid[:, None, :], cost_all,
                                   CHURN_POISON_US)
        zero = torch.where(valid[..., None], 1.0, 0.0)
        return dict(job=job, layer=layer, valid=valid, dep=dep,
                    ready_rel=ready_rel * valid,
                    cost_all=cost_all * zero, bw_all=bw_all * zero,
                    en_all=en_all * zero, model=model,
                    deadline=torch.gather(trace["deadline"], 1, job),
                    q=torch.gather(trace["q"], 1, job),
                    arrival=torch.gather(trace["arrival"], 1, job))

    def encode(self, slots: Slots, state: State):
        """-> (feats (S, R+1, F), mask (S, R+1)) with the primer at t=0."""
        cfg = self.cfg
        tsn = cfg.t_s_us * cfg.ttd_norm_periods
        t = state["t"][:, None]
        S = t.shape[0]
        model_n = (slots["model"] + 1.0) / self.num_models
        layer_n = (slots["layer"] + 1.0) / self.lmax
        ttd = torch.clamp((slots["deadline"] - t) / tsn, -1.0, 1.0)
        wait = torch.clamp((t - slots["arrival"]) / tsn, 0.0, 1.0)
        c_n = torch.clamp(slots["cost_all"] / cfg.t_s_us, 0.0, 2.0) / 2.0
        b_n = slots["bw_all"] / cfg.bandwidth_gbps
        v = slots["valid"].to(F32)[..., None]
        rows = torch.cat(
            [(model_n.to(F32)[..., None] * v), (layer_n.to(F32)[..., None] * v),
             ttd[..., None] * v, wait[..., None] * v, c_n * v, b_n * v],
            dim=-1)
        sa_busy = torch.clamp(state["sa_free"] - t, min=0.0) / cfg.t_s_us
        zeros4 = torch.zeros((S, 4), dtype=F32, device=self.device)
        primer = torch.cat([zeros4, torch.clamp(sa_busy, 0.0, 4.0) / 4.0,
                            torch.zeros_like(sa_busy)], dim=-1)[:, None]
        feats = torch.cat([primer, rows], dim=1)
        mask = torch.cat([torch.ones((S, 1), dtype=torch.bool,
                                     device=self.device), slots["valid"]],
                         dim=1)
        return feats.to(F32).contiguous(), mask.contiguous()

    def simulate(self, state: State, slots: Slots, prio, sa_choice,
                 commit_only: bool = False):
        """Engine run for the current RQ. Returns (start, finish) rel. to t.

        ``commit_only=True`` stops the event loop once every SJ starting
        inside the period has finished (``stop_start_after=T_s``): the
        committed results are exact, late starters keep
        ``finish = INF``.  Only for consumers that ignore uncommitted
        SJs (the serving tick; a reward needs every finish).
        """
        sa = sa_choice.to(I64).clamp(0, self.num_sas - 1)
        idx = sa[..., None]
        cost = torch.gather(slots["cost_all"], 2, idx)[..., 0]
        bw = torch.gather(slots["bw_all"], 2, idx)[..., 0]
        en = torch.gather(slots["en_all"], 2, idx)[..., 0]
        sa_free_rel = torch.clamp(state["sa_free"] - state["t"][:, None],
                                  min=0.0)
        start, fin = engine.simulate(
            slots["valid"], sa, prio, cost, bw, slots["dep"],
            slots["ready_rel"], sa_free_rel, self.cfg.bandwidth_gbps,
            num_sas=self.num_sas,
            stop_start_after=(self.cfg.t_s_us if commit_only else None))
        return start, fin, cost, bw, en, sa

    def reward(self, state: State, slots: Slots, fin):
        """Paper reward per stream, ``(S,)``."""
        cfg = self.cfg
        t = state["t"][:, None]
        ran = slots["valid"] & (fin < INF / 2)
        abs_f = t + fin
        delta = torch.where(fin < cfg.t_s_us, 1.0, cfg.delta)
        hit = abs_f <= slots["deadline"]
        A = torch.where(hit, cfg.alpha, -cfg.beta)
        slack = torch.clamp((slots["deadline"] - abs_f)
                            / torch.clamp(slots["q"], min=1e-3), -3.0, 3.0)
        r_slot = delta * (A + cfg.gamma_r * slack)
        r_unran = cfg.delta * (-cfg.beta - 3.0 * cfg.gamma_r)
        return torch.where(slots["valid"],
                           torch.where(ran, r_slot, r_unran), 0.0).sum(1)

    def commit(self, state: State, trace: Trace, slots: Slots,
               start, fin, en, sa) -> State:
        cfg, J, M = self.cfg, self.cfg.max_jobs, self.num_sas
        dev = self.device
        t = state["t"][:, None]
        # an SJ commits iff it *started* inside the period; the finite-fin
        # guard protects state from a (bounded-iteration) engine anomaly
        committed = (slots["valid"] & (start < cfg.t_s_us - 1e-6)
                     & (fin < INF / 2))
        job = slots["job"]
        jobhot = job[..., None] == torch.arange(J, device=dev)   # (S, R, J)
        ncom = (committed[..., None] & jobhot).sum(1)
        fin_c = torch.where(committed, fin, -INF)
        jlast = torch.where(jobhot, fin_c[..., None], -INF).amax(1)
        nls = state["nls"] + ncom
        jready = torch.where(ncom > 0, t + jlast, state["jready"])
        arrived = trace["arrival"] <= t
        newly_done = (arrived & ~state["done"] & ~state["missed"]
                      & (nls >= trace["njl"]) & (ncom > 0))
        fjob = torch.where(newly_done, jready, state["fjob"])
        hit = state["hit"] | (newly_done & (fjob <= trace["deadline"]))
        done = state["done"] | newly_done
        energy = state["energy"] + torch.where(committed, en, 0.0).sum(1)
        sahot = sa[..., None] == torch.arange(M, device=dev)     # (S, R, M)
        fin_sa = torch.where(sahot, fin_c[..., None], -INF).amax(1)
        sa_free = torch.where(fin_sa > -INF / 2,
                              torch.maximum(state["sa_free"], t + fin_sa),
                              state["sa_free"])
        return {**state, "nls": nls, "jready": jready, "done": done,
                "hit": hit, "fjob": fjob, "energy": energy,
                "sa_free": sa_free, "t": state["t"] + cfg.t_s_us}

    # ---------------- one full period ----------------
    def period(self, state: State, trace: Trace, act_fn,
               commit_only: bool = False, churn=None):
        """act_fn(feats, mask, slots, state) -> (a (S,R,G), prio (S,R),
        sa (S,R)).

        Returns ``(new_state, transition, info)``.  With
        ``commit_only=True`` the engine stops at the period-boundary
        start horizon and the transition (reward, residual next state)
        is not computed: it needs every finish time.  ``transition`` is
        then ``None``; ``new_state`` and ``info["committed"]`` are the
        same either way.

        ``churn``: an optional churn row ``dict(valid (S, M), lat_mult
        (S, M), bw_mult (S, M))`` (one period of a compiled
        ``repro_torch.sim.churn`` schedule), injected into the state
        seen by :meth:`build_slots` and ``act_fn`` as ``sa_valid`` /
        ``lat_mult`` / ``bw_mult`` and stripped from the returned state.

        Spans (``telemetry.profiler``): ``env.drops``, ``env.slots``,
        ``env.encode``, ``env.act``, then the engine, then
        ``env.commit``.
        """
        if churn is not None:
            state = {**state, "sa_valid": churn["valid"],
                     "lat_mult": churn["lat_mult"],
                     "bw_mult": churn["bw_mult"]}
        t = state["t"]
        with span("env.drops"):
            state = self.mark_drops(state, trace, t)
        with span("env.slots"):
            slots = self.build_slots(state, trace, cutoff=t)
        with span("env.encode"):
            feats, mask = self.encode(slots, state)
        with span("env.act"):
            a, prio, sa_choice = act_fn(feats, mask, slots, state)
        start, fin, cost, bw, en, sa = self.simulate(
            state, slots, prio, sa_choice, commit_only=commit_only)
        with span("env.commit"):
            new_state = self.commit(state, trace, slots, start, fin, en, sa)
            info = dict(committed=(slots["valid"]
                                   & (start < self.cfg.t_s_us)).sum(1))
        if commit_only:
            return _strip(new_state), None, info
        r = self.reward(state, slots, fin)
        # residual-RQ-only next state (paper Sec. 4.2): cutoff at *old* t
        ns = self.mark_drops(new_state, trace, new_state["t"])
        rslots = self.build_slots(ns, trace, cutoff=t)
        feats2, mask2 = self.encode(rslots, ns)
        info["reward"] = r
        trans = dict(s=feats, mask=mask, a=a, r=r, s2=feats2, mask2=mask2)
        return _strip(new_state), trans, info

    # ---------------- whole episodes ----------------
    def episode(self, state: State, trace: Trace, act_fn, aux=None,
                collect: bool = True, churn=None):
        """Run all ``cfg.periods`` periods of every stream.

        ``act_fn(feats, mask, slots, state, aux_p) -> (a, prio, sa)``
        where ``aux_p`` is period p's slice ``aux[:, p]`` of the
        ``(S, periods, ...)`` block ``aux`` (the policy's pre-drawn
        exploration noise), or None without one.  After the last period
        a final drop pass counts the late jobs.  ``churn`` is an
        optional compiled churn schedule with ``(S, periods, M)`` leaves
        (``repro_torch.sim.churn``); period p reads its slice
        ``[:, p]``.

        Returns ``(final_state, transitions, infos, metrics)``:
        transitions (``{}`` when ``collect=False``) and infos stacked
        over a periods axis after the stream axis, ``(S, periods, ...)``.
        """
        trans, infos = [], []
        for p in range(self.cfg.periods):
            a_p = None if aux is None else aux[:, p]
            c_p = (None if churn is None
                   else {k: v[:, p] for k, v in churn.items()})
            state, tr, info = self.period(
                state, trace,
                lambda feats, mask, slots, st: act_fn(feats, mask, slots,
                                                      st, a_p),
                churn=c_p)
            if collect:
                trans.append(tr)
            infos.append(info)
        state = self.mark_drops(state, trace, state["t"])
        stack = lambda xs: {k: torch.stack([x[k] for x in xs], dim=1)
                            for k in xs[0]}
        return (state, stack(trans) if collect else {}, stack(infos),
                self.metrics(state, trace))

    # ---------------- episode metrics ----------------
    def metrics(self, state: State, trace: Trace) -> dict[str, torch.Tensor]:
        counted = (state["done"] | state["missed"]).sum(1)
        hits = state["hit"].sum(1)
        arrived = (trace["arrival"] < INF / 2).sum(1)
        return dict(
            hits=hits, counted=counted, arrived=arrived,
            sla_rate=hits.to(F32) / torch.clamp(counted, min=1).to(F32),
            energy_uj=state["energy"],
        )


def _strip(state: State) -> State:
    """``state`` without the churn row ``period`` injected."""
    return {k: v for k, v in state.items() if k not in _CHURN_KEYS}
