"""Multi-tenant scheduling service: policy x registry x environment.

The counterpart of the JAX package's ``serving/service.py`` with two
serving paths on one device:

- :meth:`MultiTenantService.serve_stream` — the batched path: ``S``
  request queues live on the device (``serving.queue``) and one tick
  per period (``core.serve.make_serving_tick``) admits staged requests,
  runs one actor pass over every pending sub-job of every stream,
  advances the contention engine and retires completed jobs.  Fed by
  ``serving.loadgen`` streams.
- :meth:`MultiTenantService.serve_trace_host` — the per-period
  reference with the whole trace known up front (full engine run every
  period): the parity oracle of the batched path on a replayed trace.

Checkpoints (the JAX package's format, written by either package):
a *generalist* checkpoint (``policy_kind: "generalist"`` in its meta,
the fleet-conditioned policy of ``repro_torch.core.generalist``)
restores on any fleet whose ``num_sas`` fits its ``m_max``: the env is
padded and the descriptors condition the weights.  A *specialist*
checkpoint restores into the actor and stays fleet-locked: one recorded
on another named fleet is refused (untrained policy, with a message),
as in the JAX package.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from repro_torch.ckpt import restore_checkpoint
from repro_torch.core import baselines as BL
from repro_torch.core.generalist import (PaddedEnv,
                                         load_generalist_checkpoint)
from repro_torch.core.policy import Actor, PolicyConfig
# module import: core.serve imports serving.queue, whose package
# imports this module; attributes are read at call time
from repro_torch.core import serve as core_serve
from repro_torch.costmodel.registry import Registry
from repro_torch.serving.queue import queue_init
from repro_torch.serving.request import Request, resolve_request
from repro_torch.sim.arrivals import ArrivalConfig, generate_trace
from repro_torch.sim.engine import INF
from repro_torch.sim.env import EnvConfig, SchedulingEnv
from repro_torch.telemetry.console import console_line
from repro_torch.telemetry.profiler import span


def per_tenant_metrics(env: SchedulingEnv, state, trace) -> dict[str, dict]:
    """SLA breakdown by tenant (model id) for stream 0 of a finished
    episode.

    Tenants with zero counted jobs report ``sla_rate: None`` (no data,
    distinct from 0.0 = all missed); the ``jobs`` counts sum to the
    stream's counted total.
    """
    model = trace["model"][0].cpu().numpy()
    arrived = trace["arrival"][0].cpu().numpy() < 1e29
    hit = state["hit"][0].cpu().numpy()
    counted = (state["done"] | state["missed"])[0].cpu().numpy() & arrived
    out = {}
    for mid, name in enumerate(env.registry.model_names):
        sel = counted & (model == mid)
        n = int(sel.sum())
        out[name] = {"jobs": n,
                     "sla_rate": float(hit[sel].sum() / n) if n else None}
    return out


def _tenant_table(model_names, ten_counted, ten_hit) -> dict[str, dict]:
    """Per-tenant table from the queue accumulators — the same int
    ratios as :func:`per_tenant_metrics`."""
    out = {}
    for mid, name in enumerate(model_names):
        n = int(ten_counted[mid])
        out[name] = {"jobs": n,
                     "sla_rate": float(int(ten_hit[mid]) / n) if n else None}
    return out


class MultiTenantService:
    def __init__(self, registry: Registry, *, policy: str = "relmas",
                 ckpt_dir: str | None = None, hidden: int = 64,
                 env_cfg: EnvConfig | None = None,
                 arrivals: ArrivalConfig | None = None,
                 device: str | torch.device = "cuda"):
        env_cfg = env_cfg or EnvConfig()
        self.policy_name = policy
        self.actor = None
        self._baseline_fn = None
        gen = (load_generalist_checkpoint(
                   ckpt_dir, min_num_sas=registry.mas.num_sas,
                   default_hidden=hidden, device=device)
               if policy == "relmas" else None)
        if gen is not None:
            # fleet-conditioned generalist: this fleet's env padded to
            # the checkpoint's m_max, served on any platform (a failed
            # weight restore leaves the architecture untrained; the
            # loader said so)
            params, pcfg, spec, _ = gen
            self.env = PaddedEnv(registry, env_cfg, spec.m_max, arrivals,
                                 device=device)
            self.device = self.env.device
            self.policy_kind = "generalist"
            self.actor = Actor(pcfg, device=self.device)
            for name, mod in self.actor.params().items():
                for k, prm in mod.items():
                    prm.data.copy_(params[name][k])
            return
        self.env = SchedulingEnv(registry, env_cfg, arrivals, device=device)
        self.device = self.env.device
        if policy != "relmas":
            self.policy_kind = "heuristic"
            self._baseline_fn = BL.BASELINES[policy]
            return
        self.policy_kind = "specialist"
        pcfg = PolicyConfig(feat_dim=self.env.feat_dim,
                            act_dim=self.env.act_dim, hidden=hidden)
        self.actor = Actor(pcfg, device=self.device)
        # attempt the restore whenever a directory was given (even an
        # empty one: the FileNotFoundError path must still say so)
        if ckpt_dir and os.path.isdir(ckpt_dir):
            try:
                tree, _, meta = restore_checkpoint(ckpt_dir)
                # specialist checkpoints stay fleet-locked: a same-width
                # fleet restores shape-clean but carries another
                # platform's policy; accept a fleet match only when both
                # sides are named
                ck_fleet = meta.get("fleet")
                fleet = getattr(registry.mas, "name", None)
                if ck_fleet and fleet and ck_fleet != fleet:
                    console_line(f"[service] checkpoint trained on fleet "
                                 f"{ck_fleet!r}, serving {fleet!r}; using "
                                 f"untrained policy")
                else:
                    self.actor.load_numpy(tree)
            except (ValueError, KeyError, FileNotFoundError) as e:
                # trained for another MAS shape (M changes F and G)
                console_line(f"[service] checkpoint incompatible ({e}); "
                             f"using untrained policy")

    def _act(self):
        return core_serve.build_act(self.env, self.policy_kind, self.actor,
                         self._baseline_fn)

    # ------------------------------------------------------------------
    # per-period reference path (whole trace known up front)
    # ------------------------------------------------------------------
    def serve_episode_host(self, seed: int = 0) -> dict:
        """Draw one trace (NumPy, ``default_rng(seed)``) and serve it
        through :meth:`serve_trace_host`."""
        rng = np.random.default_rng(seed)
        return self.serve_trace_host(
            generate_trace(self.env.min_lat, self.env.arrivals, rng))

    run_episode = serve_episode_host

    @torch.no_grad()
    def serve_trace_host(self, trace) -> dict:
        """Serve one host trace (NumPy ``(max_jobs,)`` columns) period by
        period with the full engine run, then a final drop pass.  The
        reference for :meth:`serve_stream` on the equivalent stream
        (``loadgen.trace_to_requests``)."""
        env = self.env
        tr = env.to_trace({k: np.asarray(trace[k])[None]
                           for k in ("arrival", "deadline", "q", "model")})
        state = env.init_state(tr)
        act = self._act()
        for _ in range(env.cfg.periods):
            state, _, _ = env.period(state, tr, act)
        state = env.mark_drops(state, tr, state["t"])
        metrics = {k: float(v[0]) for k, v in env.metrics(state, tr).items()}
        metrics["per_tenant"] = per_tenant_metrics(env, state, tr)
        return metrics

    # ------------------------------------------------------------------
    # batched path (one tick per period, all streams)
    # ------------------------------------------------------------------
    def serve_stream(self, request_streams, *, tick_k: int = 8,
                     ticks: int | None = None, telemetry=None,
                     window: int = 0) -> dict:
        """Serve request streams through the batched tick.

        ``request_streams``: a list of per-stream ``Request`` lists (or
        one flat list for a single stream), validated up front
        (:func:`~repro_torch.serving.request.resolve_request`).  Each
        tick stages up to ``tick_k`` arrived requests per stream; rows
        that find no free slot are *deferred* (re-staged next tick).
        Runs ``ticks`` periods (default ``env.cfg.periods``), then
        flushes: final drop pass + drain.

        Returns ``dict(metrics, aggregate, completions, stats)``:
        per-stream metric dicts in the schema of
        :meth:`serve_trace_host`, per-stream completion records, and
        serving statistics (``tick_wall_us``: each period's host wall
        time as the loop runs it, from the staging of its admissions
        through the read-back to its completion records; admitted/
        deferred counts, queue depth).

        Spans (``telemetry.profiler``, only while a profiler runs):
        ``serving.resolve`` once a call, then each period
        ``serving.stage``, the tick's spans, ``serving.readback`` and,
        in a period with completions, ``serving.record``; last
        ``serving.flush``.

        ``telemetry``: an optional :class:`repro_torch.telemetry.
        Telemetry` session.  When given, the queues carry the device
        telemetry block (depth histogram, committed and tick counters,
        accumulated on the device and read back at the flush, which the
        path pays for anyway; ``stats["device_tele"]``), and the host
        emits ``serve_window`` records every ``window`` ticks (0: none),
        the per-tenant ``tenant`` rows summed over streams and a
        ``serve_summary``, all from values the loop already holds on the
        host: no added device-to-host transfer.
        """
        if request_streams and isinstance(request_streams[0], Request):
            request_streams = [request_streams]
        S = len(request_streams)
        if S == 0:
            raise ValueError("no request streams given")
        env, dev = self.env, self.device
        names = env.registry.model_names
        # every request resolved up front into arrival-sorted columns:
        # each stream's backlog is the window [head, avail) of its row
        K = tick_k
        n_req = np.array([len(st) for st in request_streams], np.int64)
        N = max(int(n_req.max()), 1)
        with span("serving.resolve"):
            cols = dict(rid=np.full((S, N), -1, np.int32),
                        model=np.zeros((S, N), np.int32),
                        arrival=np.full((S, N), np.float32(INF),
                                        np.float32),
                        deadline=np.full((S, N), np.float32(INF),
                                         np.float32),
                        q=np.ones((S, N), np.float32))
            for s, stream in enumerate(request_streams):
                for j, r in enumerate(sorted(stream,
                                             key=lambda r: r.arrival_us)):
                    mid, arr, dl, q = resolve_request(r, names)
                    cols["rid"][s, j] = r.rid
                    cols["model"][s, j] = mid
                    cols["arrival"][s, j] = arr
                    cols["deadline"][s, j] = dl
                    cols["q"][s, j] = q
        tick = core_serve.make_serving_tick(env, kind=self.policy_kind,
                                 actor=self.actor,
                                 baseline_fn=self._baseline_fn)
        flush = core_serve.make_serving_flush(env)
        queues = queue_init(env, S, telemetry=telemetry is not None)
        n_ticks = ticks if ticks is not None else env.cfg.periods
        t_s = float(env.cfg.t_s_us)
        head = np.zeros((S,), np.int64)    # first not-yet-admitted row
        completions: list[list[dict]] = [[] for _ in range(S)]
        tick_wall_us: list[float] = []
        depth_sum = admitted = deferred = 0
        win = int(window) if telemetry is not None else 0
        w_first, w_adm, w_def, w_comp, w_depth = 0, 0, 0, 0, 0
        lane = np.arange(K)
        for i in range(n_ticks):
            t0 = time.perf_counter()
            with span("serving.stage"):
                t_now = i * t_s
                avail = (cols["arrival"] <= t_now).sum(axis=1)
                n_stage = np.minimum(avail - head, K)
                idx = np.minimum(head[:, None] + lane[None, :], N - 1)
                adm = {k: torch.as_tensor(
                           np.take_along_axis(cols[k], idx, 1), device=dev)
                       for k in ("model", "arrival", "deadline", "q",
                                 "rid")}
                adm["valid"] = torch.as_tensor(
                    lane[None, :] < n_stage[:, None], device=dev)
            out = tick(queues, adm)
            with span("serving.readback"):
                n_adm = out["n_admitted"].cpu().numpy()
                comp = out["completed"].cpu().numpy()
                depth = int(out["depth"].sum())
            if comp.any():
                with span("serving.record"):
                    self._record(out, comp, completions)
            tick_wall_us.append((time.perf_counter() - t0) * 1e6)
            head += n_adm
            admitted += int(n_adm.sum())
            deferred += int((n_stage - n_adm).sum())
            depth_sum += depth
            if win:
                w_adm += int(n_adm.sum())
                w_def += int((n_stage - n_adm).sum())
                w_comp += int(comp.sum())
                w_depth += depth
                if i + 1 - w_first >= win or i == n_ticks - 1:
                    w_wall = tick_wall_us[w_first:i + 1]
                    telemetry.emit(
                        "serve_window", tick_first=w_first, tick_last=i,
                        tick_p50_us=float(np.percentile(w_wall, 50)),
                        tick_p99_us=float(np.percentile(w_wall, 99)),
                        admitted=w_adm, deferred=w_def, completed=w_comp,
                        mean_depth=w_depth / max(len(w_wall) * S, 1))
                    w_first, w_adm, w_def, w_comp, w_depth = \
                        i + 1, 0, 0, 0, 0
        with span("serving.flush"):
            fout = flush(queues)
            final = {k: v.cpu().numpy() for k, v in fout.items()}
            self._record(final, final["completed"], completions)
            metrics = []
            for s in range(S):
                m = dict(hits=float(final["hits"][s]),
                         counted=float(final["counted"][s]),
                         arrived=float(final["arrived"][s]),
                         sla_rate=float(final["sla_rate"][s]),
                         energy_uj=float(final["energy_uj"][s]))
                m["per_tenant"] = _tenant_table(
                    names, final["ten_counted"][s], final["ten_hit"][s])
                metrics.append(m)
        tot_c = int(final["counted"].sum())
        tot_h = int(final["hits"].sum())
        aggregate = dict(
            sla_rate=tot_h / max(tot_c, 1), counted=tot_c, hits=tot_h,
            arrived=int(final["arrived"].sum()),
            energy_uj=float(final["energy_uj"].sum()),
            completed=sum(len(c) for c in completions),
            per_tenant=_tenant_table(names, final["ten_counted"].sum(0),
                                     final["ten_hit"].sum(0)))
        stats = dict(streams=S, ticks=n_ticks, tick_k=tick_k,
                     tick_wall_us=tick_wall_us, admitted=admitted,
                     deferred=deferred, unserved=int((n_req - head).sum()),
                     mean_depth=depth_sum / max(n_ticks, 1))
        if "tele_depth_hist" in final:
            # the device-accumulated block, read back at the flush
            stats["device_tele"] = dict(
                depth_hist=final["tele_depth_hist"].sum(axis=0).tolist(),
                depth_edges=final["tele_depth_edges"][0].tolist(),
                committed=int(final["tele_committed"].sum()),
                ticks=int(final["tele_ticks"][0]))
        if telemetry is not None:
            for name, row in aggregate["per_tenant"].items():
                telemetry.emit("tenant", tenant=name, jobs=row["jobs"],
                               sla_rate=row["sla_rate"])
            telemetry.emit("serve_summary",
                           sla_rate=aggregate["sla_rate"],
                           counted=tot_c, ticks=n_ticks)
        return dict(metrics=metrics, aggregate=aggregate,
                    completions=completions, stats=stats)

    @staticmethod
    def _record(out, comp, completions) -> None:
        """Append one tick's completed jobs to the per-stream logs."""
        comp = np.asarray(comp)
        get = lambda k: (out[k].cpu().numpy() if torch.is_tensor(out[k])
                         else np.asarray(out[k]))
        rid, hit, missed, fin = (get("rid"), get("hit"), get("missed"),
                                 get("finish_us"))
        for s, j in zip(*np.nonzero(comp)):
            completions[s].append(dict(
                rid=int(rid[s, j]), hit=bool(hit[s, j]),
                missed=bool(missed[s, j]), finish_us=float(fin[s, j])))
