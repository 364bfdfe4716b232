"""Multi-tenant serving driver (the paper's deployment scenario).

Schedules DNN/LM inference requests on the heterogeneous MAS with the
chosen policy and reports global and per-tenant SLA satisfaction.
Tenants: the paper's CNN zoo (Table 2 workloads) or the ten LM
architectures (``workloads.llm_zoo``, ``--phase``/``--seq``; the
``datacenter`` fleet and a 2000 us period by default).  Runs on
``--device cuda`` (the default; it raises without a GPU) or
``--device cpu``.

Two serving modes:

- default: per-episode reference loop (``serve_episode_host``), one
  full trace per episode;
- ``--batched``: ``--streams`` concurrent request streams drawn by the
  ``serving.loadgen`` scenario generator (``--scenario``/
  ``--rate-scale``/``--requests``), served by one tick per period
  across all streams; prints aggregate SLA, the per-tenant table and
  the p50 / p99 of the period wall times (``stats["tick_wall_us"]``:
  each period from its staging to its completion records).

Telemetry, as in the JAX package's driver: ``--log-jsonl PATH`` streams
schema'd records (``run_header`` / ``serve_window`` / ``serve_episode``
/ ``tenant`` / ``serve_summary`` / ``span`` / ``run_end``, see
``repro_torch.telemetry.schema``) beside the console lines and turns on
the queues' device telemetry block (bit-neutral; the JAX package's
batched driver always carries it, here it follows the flag as the
training driver's does, so a run without it is the telemetry-off run);
``--window N`` sets the batched mode's ``serve_window`` cadence;
``--profile-dir DIR`` captures a ``torch.profiler`` trace of the
serving loop.  ``scripts/metrics_summary.py`` validates the stream.

The last line of standard output is one JSON summary.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --workload mixed \
      --fleet paper6 --hidden 256 --batched --streams 32
  PYTHONPATH=src python -m repro_torch.launch.serve --workload light \
      --policy herald --device cpu --episodes 2
  PYTHONPATH=src python -m repro_torch.launch.serve --workload lm_mixed \
      --policy herald --episodes 3
  PYTHONPATH=src python -m repro_torch.launch.serve --workload light \
      --batched --log-jsonl runs/serve.jsonl --window 16 \
      --profile-dir runs/serve_trace
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.serving.loadgen import LoadGenConfig, request_streams
from repro_torch.serving.service import MultiTenantService
from repro_torch.sim.arrivals import ArrivalConfig
from repro_torch.sim.env import EnvConfig
from repro_torch.telemetry import console_line, make_telemetry, profile_trace
from repro_torch.workloads import (LM_WORKLOADS, WORKLOADS, build_registry,
                                   build_llm_registry)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="mixed",
                    choices=list(WORKLOADS) + list(LM_WORKLOADS))
    ap.add_argument("--policy", default="relmas",
                    choices=["relmas", "fcfs", "prema", "herald"])
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (either package's): a "
                         "specialist serves its own fleet only, a "
                         "generalist any fleet with num_sas <= its m_max")
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--episodes", type=int, default=3)
    ap.add_argument("--periods", type=int, default=60)
    ap.add_argument("--qos", default="medium",
                    choices=["high", "medium", "low"])
    ap.add_argument("--qos-factor", type=float, default=3.0)
    ap.add_argument("--load", type=float, default=0.9)
    ap.add_argument("--bandwidth", type=float, default=-1.0,
                    help="shared DRAM GB/s (<=0: fleet default)")
    ap.add_argument("--fleet", default=None,
                    help="accelerator fleet preset "
                         "(repro_torch.costmodel.fleets; default: paper6, "
                         "or datacenter for lm_* workloads)")
    ap.add_argument("--t-s", type=float, default=-1.0)
    ap.add_argument("--max-rq", type=int, default=96,
                    help="ready-queue slots a stream (at most 256 on "
                         "--device cuda, the event-loop kernel's limit)")
    ap.add_argument("--max-jobs", type=int, default=64)
    ap.add_argument("--phase", default="decode",
                    choices=["decode", "prefill"])
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batched", action="store_true",
                    help="serve loadgen streams through the batched tick "
                         "instead of per-episode loops")
    ap.add_argument("--streams", type=int, default=16,
                    help="concurrent request streams (--batched)")
    ap.add_argument("--tick-k", type=int, default=8,
                    help="max admissions per stream per tick (--batched)")
    ap.add_argument("--scenario", default="steady",
                    choices=["default", "steady", "burst", "diurnal",
                             "heavy_tail"],
                    help="loadgen arrival scenario (--batched)")
    ap.add_argument("--rate-scale", type=float, default=1.0,
                    help="offered-load multiplier on the calibrated base "
                         "arrival rate (--batched)")
    ap.add_argument("--requests", type=int, default=32,
                    help="requests per stream (--batched)")
    ap.add_argument("--log-jsonl", default="",
                    help="stream schema'd JSONL telemetry records to this "
                         "path and carry the device telemetry block "
                         "(validate with scripts/metrics_summary.py)")
    ap.add_argument("--window", type=int, default=16,
                    help="serve_window record cadence in ticks "
                         "(--batched with --log-jsonl; 0 disables windows)")
    ap.add_argument("--profile-dir", default="",
                    help="capture a torch.profiler trace of the serving "
                         "loop into this directory")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of the queues, tables and actor")
    return ap.parse_args(argv)


def build_service(args) -> MultiTenantService:
    if args.workload in LM_WORKLOADS:
        registry = build_llm_registry(
            args.workload, phase=args.phase, seq=args.seq,
            mas=args.fleet or "datacenter")
        t_s = 2000.0                      # LM layer latencies are larger
    else:
        registry = build_registry(args.workload, mas=args.fleet or "paper6")
        t_s = 500.0
    t_s = args.t_s if args.t_s > 0 else t_s
    # bandwidth <= 0 -> SchedulingEnv resolves the fleet's dram_gbps
    ecfg = EnvConfig(t_s_us=t_s, periods=args.periods, max_rq=args.max_rq,
                     max_jobs=args.max_jobs, bandwidth_gbps=args.bandwidth)
    arr = ArrivalConfig(max_jobs=args.max_jobs, load=args.load,
                        qos_factor=args.qos_factor, qos_level=args.qos,
                        horizon_us=ecfg.horizon_us, slack_us=2 * ecfg.t_s_us)
    return MultiTenantService(registry, policy=args.policy,
                              ckpt_dir=args.ckpt, hidden=args.hidden,
                              env_cfg=ecfg, arrivals=arr, device=args.device)


def serve_batched(svc: MultiTenantService, args,
                  tele=None) -> tuple[dict, dict]:
    """Drive the batched path on loadgen traffic, reporting through the
    telemetry session ``tele`` (console only when not given).  Returns
    the summary dict and the full ``serve_stream`` result."""
    tele = tele or make_telemetry()
    lg = LoadGenConfig(scenario=args.scenario, rate_scale=args.rate_scale,
                       n_requests=args.requests,
                       qos_factor=args.qos_factor, qos_level=args.qos)
    reqs = request_streams(svc.env, lg, args.streams, seed=9000)
    on = bool(args.log_jsonl)
    with tele.span("serve"), profile_trace(args.profile_dir, svc.device):
        res = svc.serve_stream(reqs, tick_k=args.tick_k,
                               telemetry=tele if on else None,
                               window=args.window)
    agg, st = res["aggregate"], res["stats"]
    if not on:          # serve_stream emitted the tenant table itself
        for name, row in agg["per_tenant"].items():
            tele.emit("tenant", tenant=name, jobs=row["jobs"],
                      sla_rate=row["sla_rate"])
    tick_p50 = float(np.percentile(st["tick_wall_us"], 50))
    tick_p99 = float(np.percentile(st["tick_wall_us"], 99))
    tele.note(f"[serve batched] streams={args.streams} "
              f"scenario={args.scenario} rate={args.rate_scale} "
              f"sla={agg['sla_rate']:.3f} jobs={agg['counted']} "
              f"energy={agg['energy_uj']:.0f}uJ")
    tele.note(f"    ticks={st['ticks']} tick_p50={tick_p50:.0f}us "
              f"tick_p99={tick_p99:.0f}us admitted={st['admitted']} "
              f"deferred={st['deferred']} unserved={st['unserved']} "
              f"mean_depth={st['mean_depth']:.1f}")
    out = {"policy": args.policy, "policy_kind": svc.policy_kind,
           "workload": args.workload, "scenario": args.scenario,
           "rate_scale": args.rate_scale, "streams": args.streams,
           "device": str(svc.device),
           "sla_rate": agg["sla_rate"], "counted": agg["counted"],
           "deferred": st["deferred"], "ticks": st["ticks"],
           "tick_p50_us": tick_p50, "tick_p99_us": tick_p99}
    return out, res


def main(argv=None):
    args = parse_args(argv)
    svc = build_service(args)
    tele = make_telemetry(jsonl_path=args.log_jsonl or None)
    tele.run_header("serve", dict(vars(args)), device=svc.device)
    if args.batched:
        out, _ = serve_batched(svc, args, tele)
    else:
        rates, energies = [], []
        with profile_trace(args.profile_dir, svc.device):
            for ep in range(args.episodes):
                with tele.span("episode", episode=ep):
                    m = svc.run_episode(seed=9000 + ep)
                rates.append(m["sla_rate"])
                energies.append(m["energy_uj"])
                tele.emit("serve_episode", episode=ep,
                          sla_rate=float(m["sla_rate"]),
                          counted=int(m["counted"]),
                          energy_uj=float(m["energy_uj"]))
                for tname, tm in m["per_tenant"].items():
                    if tm["jobs"]:
                        tele.emit("tenant", tenant=tname, jobs=tm["jobs"],
                                  sla_rate=tm["sla_rate"])
        out = {"policy": args.policy, "workload": args.workload,
               "device": str(svc.device),
               "sla_rate_mean": float(np.mean(rates)),
               "energy_uj_mean": float(np.mean(energies))}
    tele.emit("run_end", summary=out)
    tele.close()
    console_line(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
