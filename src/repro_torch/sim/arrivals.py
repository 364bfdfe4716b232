"""Multi-tenant request trace generation (paper Sec. 5).

Inter-arrival times are drawn from a Pareto distribution ("emulating
task dispatching in data centers", Da Costa et al.), models uniformly
from the workload set, and each request's SLA latency budget is
``qos_factor * min_isolated_latency`` (the PREMA approach), with
QoS-High = 0.8x and QoS-Low = 1.2x the Medium factor.

Scenario presets (selectable from configs / CLI via ``scenario=``):

- ``default``     the paper's Pareto(2.0) process (legacy behaviour);
- ``steady``      near-deterministic arrivals (jittered uniform spacing)
                  — the low-variance sanity regime;
- ``burst``       arrivals grouped into tight bursts separated by long
                  idle gaps (same mean rate) — stresses queue depth;
- ``diurnal``     sinusoidally rate-modulated Poisson process over the
                  horizon (rate in [0.5, 1.5]x base, peak = 3x trough)
                  — the day/night pattern of real inference traffic;
- ``heavy_tail``  Pareto(1.2) with a looser tail clip — extreme
                  dispatch-center burstiness.

All presets conserve the configured mean arrival rate (``load`` knob),
so SLA numbers stay comparable across scenarios.

:func:`generate_traces` is the batched twin of :func:`generate_trace`:
it returns the same dict with a leading ``(batch,)`` axis on every
array, ready to be moved to the device with a leading stream axis.

:func:`generate_trace_torch` / :func:`generate_traces_torch` are the
twins of the JAX package's ``jax.random`` generators: they draw on the
device from a ``torch.Generator``, for all five scenarios, so a training
round makes its episodes where it runs them.  Another RNG draws other
numbers, so their parity with the NumPy generators is distributional
(tests/test_torch_train.py); the NumPy generators remain the oracle for
scenario semantics and for host-side consumers (serving, evaluation).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

QOS_MULT = {"high": 0.8, "medium": 1.0, "low": 1.2}

SCENARIOS = ("default", "steady", "burst", "diurnal", "heavy_tail")


@dataclasses.dataclass(frozen=True)
class ArrivalConfig:
    max_jobs: int = 64
    pareto_shape: float = 2.0      # heavy-tailed (alpha>1 so the mean exists)
    load: float = 0.9              # offered load vs. effective MAS parallelism
    eff_parallelism: float = 3.0   # jobs the 6-SA MAS sustains concurrently
    qos_factor: float = 3.0        # QoS-Medium budget multiplier
    qos_level: str = "medium"
    horizon_us: float = 30_000.0
    # scheduling-quantum allowance added to every SLA budget: a request
    # cannot even be *noticed* before the next scheduler trigger, so the
    # budget must exceed the period (see DESIGN.md "Assumptions changed");
    # set to 2 * T_S by the environment.
    slack_us: float = 0.0
    # named arrival-process preset (see module docstring / SCENARIOS)
    scenario: str = "default"
    burst_size: int = 4            # jobs per burst (scenario="burst")


def scenario_preset(name: str, **overrides) -> "ArrivalConfig":
    """Build an ArrivalConfig for a named scenario (plus overrides)."""
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; pick one of {SCENARIOS}")
    return ArrivalConfig(scenario=name, **overrides)


def _interarrivals(cfg: ArrivalConfig, mean_ia: float, J: int,
                   rng: np.random.Generator) -> np.ndarray:
    """Draw J inter-arrival times with the configured mean, per scenario."""
    sc = cfg.scenario
    if sc in ("default", "heavy_tail"):
        a = cfg.pareto_shape if sc == "default" else 1.2
        clip = 50.0 if sc == "default" else 200.0
        xm = mean_ia * (a - 1.0) / a              # Pareto scale for mean_ia
        inter = xm * (1.0 + rng.pareto(a, size=J))
        return np.minimum(inter, clip * mean_ia)
    if sc == "steady":
        return mean_ia * rng.uniform(0.8, 1.2, size=J)
    if sc == "burst":
        # bursts of `burst_size` back-to-back jobs; the inter-burst gap
        # absorbs the rest of the budget so the mean rate is conserved
        bs = max(1, cfg.burst_size)
        intra = 0.1 * mean_ia
        gap = bs * mean_ia - (bs - 1) * intra
        inter = np.full(J, intra)
        inter[::bs] = gap * rng.uniform(0.5, 1.5, size=len(inter[::bs]))
        return inter
    if sc == "diurnal":
        # inhomogeneous Poisson, rate(t) = base * (1 + 0.5 sin(2*pi*t/H)):
        # sequential thinning against the peak rate (1.5x base)
        base = 1.0 / mean_ia
        peak = 1.5 * base
        H = max(cfg.horizon_us, mean_ia)
        inter = np.empty(J)
        t = prev = 0.0
        for i in range(J):
            while True:
                t += rng.exponential(1.0 / peak)
                rate = base * (1.0 + 0.5 * np.sin(2.0 * np.pi * t / H))
                if rng.uniform() <= rate / peak:
                    break
            inter[i] = t - prev
            prev = t
        return inter
    raise ValueError(f"unknown scenario {sc!r}; pick one of {SCENARIOS}")


def generate_trace(min_lat_us: np.ndarray, cfg: ArrivalConfig,
                   rng: np.random.Generator) -> dict[str, np.ndarray]:
    """-> dict(arrival, model, deadline, q) padded to (max_jobs,).

    min_lat_us: (num_models,) isolated minimum latency per model.
    Jobs that do not fit the horizon are padded with arrival=+inf.
    """
    n_models = len(min_lat_us)
    mean_lat = float(np.mean(min_lat_us))
    lam = cfg.load * cfg.eff_parallelism / mean_lat  # arrivals per us
    mean_ia = 1.0 / lam
    J = cfg.max_jobs
    inter = _interarrivals(cfg, mean_ia, J, rng)
    arrival = np.cumsum(inter)
    arrival[0] = 0.0                                  # first job at t=0
    model = rng.integers(0, n_models, size=J)
    qf = cfg.qos_factor * QOS_MULT[cfg.qos_level]
    q = qf * min_lat_us[model] + cfg.slack_us
    deadline = arrival + q
    # pad out-of-horizon jobs
    pad = arrival > cfg.horizon_us
    arrival = np.where(pad, np.float64(1e30), arrival)
    deadline = np.where(pad, np.float64(1e30), deadline)
    return dict(arrival=arrival.astype(np.float32),
                model=model.astype(np.int32),
                deadline=deadline.astype(np.float32),
                q=q.astype(np.float32))


def generate_traces(min_lat_us: np.ndarray, cfg: ArrivalConfig,
                    rng: np.random.Generator,
                    batch: int) -> dict[str, np.ndarray]:
    """Batched :func:`generate_trace`: every array gains a (batch,) axis.

    Episodes are independent draws of the same arrival process; the
    result stacks directly into device tensors with a leading batch axis.
    """
    traces = [generate_trace(min_lat_us, cfg, rng) for _ in range(batch)]
    return {k: np.stack([t[k] for t in traces]) for k in traces[0]}


# --------------------------------------------------------------------------
# torch.Generator twins (drawn on the device inside a training round)
# --------------------------------------------------------------------------
# candidate overdraw for the diurnal thinning pass: acceptance is at
# least rate_min/peak = 1/3, so 8x gives ~2.7x the needed points even
# in the worst case; a shortfall surfaces as +inf arrivals (horizon
# padding), as in the JAX twin.
_DIURNAL_OVERDRAW = 8


def _arrivals_torch(cfg: ArrivalConfig, mean_ia: float, J: int, batch: int,
                    gen: torch.Generator, device) -> torch.Tensor:
    """Absolute arrival times (batch, J) for the configured scenario.

    Mirrors :func:`_interarrivals` process for process.  The diurnal
    thinning loop becomes a fixed-size candidate pool (homogeneous
    Poisson at the peak rate, thinned in one vectorised accept/reject).
    """
    kw = dict(generator=gen, device=device, dtype=torch.float32)
    expo = lambda n: torch.empty((batch, n), device=device,
                                 dtype=torch.float32).exponential_(
                                     generator=gen)
    sc = cfg.scenario
    if sc in ("default", "heavy_tail"):
        a = cfg.pareto_shape if sc == "default" else 1.2
        clip = 50.0 if sc == "default" else 200.0
        xm = mean_ia * (a - 1.0) / a
        # xm * (1 + numpy's Lomax draw) == xm * X, X ~ Pareto(a, mode 1),
        # and X = exp(E / a) for E ~ Exp(1)
        inter = torch.clamp(xm * torch.exp(expo(J) / a), max=clip * mean_ia)
    elif sc == "steady":
        inter = mean_ia * (0.8 + 0.4 * torch.rand((batch, J), **kw))
    elif sc == "burst":
        bs = max(1, cfg.burst_size)
        intra = 0.1 * mean_ia
        gap = bs * mean_ia - (bs - 1) * intra
        n_bursts = -(-J // bs)
        inter = torch.full((batch, J), intra, device=device,
                           dtype=torch.float32)
        inter[:, ::bs] = gap * (0.5 + torch.rand((batch, n_bursts), **kw))
    elif sc == "diurnal":
        base = 1.0 / mean_ia
        peak = 1.5 * base
        H = max(cfg.horizon_us, mean_ia)
        C = _DIURNAL_OVERDRAW * J
        t = torch.cumsum(expo(C) / peak, dim=1)
        rate = base * (1.0 + 0.5 * torch.sin(2.0 * math.pi * t / H))
        accept = torch.rand((batch, C), **kw) <= rate / peak
        sel = torch.sort(torch.where(accept, t, math.inf), dim=1).values
        sel = sel[:, :J].contiguous()
        sel[:, 0] = 0.0
        return sel
    else:
        raise ValueError(f"unknown scenario {sc!r}; pick one of {SCENARIOS}")
    arrival = torch.cumsum(inter, dim=1)
    arrival[:, 0] = 0.0
    return arrival


def generate_traces_torch(min_lat_us: np.ndarray, cfg: ArrivalConfig,
                          gen: torch.Generator, batch: int,
                          device=None) -> dict[str, torch.Tensor]:
    """:func:`generate_traces` drawn from ``gen`` on ``device`` (default:
    the generator's device): the same dict of (batch, J) tensors, models
    as int64."""
    device = gen.device if device is None else device
    n_models = len(min_lat_us)
    lam = cfg.load * cfg.eff_parallelism / float(np.mean(min_lat_us))
    J = cfg.max_jobs
    arrival = _arrivals_torch(cfg, 1.0 / lam, J, batch, gen, device)
    model = torch.randint(0, n_models, (batch, J), generator=gen,
                          device=device)
    qf = cfg.qos_factor * QOS_MULT[cfg.qos_level]
    min_lat = torch.as_tensor(np.asarray(min_lat_us, np.float32),
                              device=device)
    q = qf * min_lat[model] + cfg.slack_us
    deadline = arrival + q
    pad = arrival > cfg.horizon_us
    return dict(arrival=torch.where(pad, 1e30, arrival), model=model,
                deadline=torch.where(pad, 1e30, deadline), q=q)


def generate_trace_torch(min_lat_us: np.ndarray, cfg: ArrivalConfig,
                         gen: torch.Generator,
                         device=None) -> dict[str, torch.Tensor]:
    """One trace of :func:`generate_traces_torch`: (J,) tensors."""
    return {k: v[0] for k, v in generate_traces_torch(
        min_lat_us, cfg, gen, 1, device).items()}
