"""Load generator: scenario-preset request streams at configurable rates.

Replays the arrival-process presets of ``repro_torch.sim.arrivals``
(steady / burst / diurnal / heavy_tail / default Pareto) as *serving*
request streams: unlike an episode trace (fixed ``max_jobs`` slots,
horizon-padded), a stream is an arbitrary-length arrival-ordered list
of :class:`~repro_torch.serving.request.Request` objects that the batched
serving loop admits tick by tick — the queue capacity, not the trace
shape, bounds concurrency, and offered load is a free knob
(``rate_scale`` multiplies the env's calibrated base arrival rate, so
``rate_scale > 1`` drives the scheduler past saturation and SLA-under-
load is measured, not assumed).

NumPy only, and the same code as the JAX package's ``serving/loadgen.py``:
with the same seed both packages draw the same requests, which anchors
every parity check between them.  The same inter-arrival samplers as the
episode path
(:func:`repro_torch.sim.arrivals._interarrivals`) draw the stream, so a
scenario means the same thing to the trainer, the sweep grid, and the
serving bench.  :func:`trace_to_requests` converts an episode trace
into the equivalent stream — replaying it through the batched tick
reproduces the host-loop reference bit-for-bit (the parity tests).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serving.request import Request, resolve_request
from repro_torch.sim.arrivals import QOS_MULT, SCENARIOS, _interarrivals
from repro_torch.sim.engine import INF


@dataclasses.dataclass(frozen=True)
class LoadGenConfig:
    """One request stream's shape: scenario, rate, size, QoS."""
    scenario: str = "default"
    rate_scale: float = 1.0    # multiplier on the env's base arrival rate
    n_requests: int = 128      # stream length (not capped by max_jobs)
    qos_factor: float | None = None   # None: the env's ArrivalConfig's
    qos_level: str | None = None

    def __post_init__(self):
        if self.scenario not in SCENARIOS:
            raise ValueError(f"unknown scenario {self.scenario!r}; "
                             f"pick one of {SCENARIOS}")
        if self.rate_scale <= 0:
            raise ValueError(f"rate_scale must be positive, "
                             f"got {self.rate_scale}")
        if self.n_requests <= 0:
            raise ValueError(f"n_requests must be positive, "
                             f"got {self.n_requests}")


def request_stream(env, cfg: LoadGenConfig,
                   rng: np.random.Generator) -> list[Request]:
    """Draw one arrival-ordered request stream against ``env``'s fleet.

    Rate calibration matches :func:`repro_torch.sim.arrivals.generate_trace`
    (``lam = load * eff_parallelism / mean_min_latency``) with
    ``load`` scaled by ``cfg.rate_scale``; SLA budgets are
    ``qos_factor * QOS_MULT[level] * min_isolated_latency + slack`` per
    drawn model, exactly the episode path's deadlines.  A non-positive
    effective SLA multiplier is rejected here (it would poison every
    deadline downstream).
    """
    base = env.arrivals
    qf = cfg.qos_factor if cfg.qos_factor is not None else base.qos_factor
    level = cfg.qos_level if cfg.qos_level is not None else base.qos_level
    mult = qf * QOS_MULT[level]
    if mult <= 0:
        raise ValueError(f"non-positive SLA multiplier {mult} "
                         f"(qos_factor={qf}, level={level!r})")
    acfg = dataclasses.replace(base, scenario=cfg.scenario,
                               load=base.load * cfg.rate_scale,
                               qos_factor=qf, qos_level=level)
    min_lat = np.asarray(env.min_lat)
    lam = acfg.load * acfg.eff_parallelism / float(np.mean(min_lat))
    inter = _interarrivals(acfg, 1.0 / lam, cfg.n_requests, rng)
    arrival = np.cumsum(inter)
    arrival[0] = 0.0
    model = rng.integers(0, len(min_lat), size=cfg.n_requests)
    q = mult * min_lat[model] + acfg.slack_us
    names = env.registry.model_names
    return [Request(rid=i, tenant=names[int(model[i])],
                    arrival_us=float(arrival[i]),
                    deadline_us=float(arrival[i] + q[i]),
                    q_us=float(q[i]))
            for i in range(cfg.n_requests)]


def request_streams(env, cfg: LoadGenConfig, streams: int,
                    seed: int = 0) -> list[list[Request]]:
    """``streams`` independent draws of the configured stream (one rng,
    split per stream — episode-style i.i.d. traffic)."""
    rng = np.random.default_rng(seed)
    return [request_stream(env, cfg, rng) for _ in range(streams)]


def requests_to_trace(env, reqs: list[Request]) -> dict[str, np.ndarray]:
    """Request stream -> the equivalent host episode trace, NumPy
    ``(max_jobs,)`` columns (the inverse of :func:`trace_to_requests`;
    stack streams and pass them to ``env.to_trace`` for the device).

    Rows land in arrival order at the lowest slot indices — exactly the
    slot assignment :func:`repro_torch.serving.queue.queue_admit` produces
    when the same stream is replayed into an empty queue, so the
    host-loop reference (``serve_trace_host``) and the batched tick path
    serve bit-identical episodes from one stream (the benchmark's
    equal-SLA anchor).  The stream must fit the trace shape
    (``len(reqs) <= cfg.max_jobs``).
    """
    J = env.cfg.max_jobs
    if len(reqs) > J:
        raise ValueError(f"{len(reqs)} requests > max_jobs {J}; "
                         f"shorten the stream or raise cfg.max_jobs")
    names = env.registry.model_names
    tr = dict(arrival=np.full((J,), INF, np.float32),
              deadline=np.full((J,), INF, np.float32),
              q=np.ones((J,), np.float32),
              model=np.zeros((J,), np.int32))
    for j, r in enumerate(sorted(reqs, key=lambda r: r.arrival_us)):
        mid, arr, dl, q = resolve_request(r, names)
        tr["arrival"][j] = arr
        tr["deadline"][j] = dl
        tr["q"][j] = q
        tr["model"][j] = mid
    return tr


def trace_to_requests(env, trace) -> list[Request]:
    """Episode trace -> the equivalent arrival-ordered request stream.

    Horizon-padding rows (``arrival >= INF/2``) are dropped; ``rid`` is
    the trace's slot index, so replaying the stream into an empty queue
    reassigns every job its original slot (arrivals are nondecreasing)
    and the batched tick path is bit-identical to running the trace
    through the host reference loop.
    """
    arrival = np.asarray(trace["arrival"])
    deadline = np.asarray(trace["deadline"])
    model = np.asarray(trace["model"])
    q = np.asarray(trace["q"])
    names = env.registry.model_names
    reqs = [Request(rid=j, tenant=names[int(model[j])],
                    arrival_us=float(arrival[j]),
                    deadline_us=float(deadline[j]), q_us=float(q[j]))
            for j in range(arrival.shape[0]) if arrival[j] < INF / 2]
    return sorted(reqs, key=lambda r: r.arrival_us)
