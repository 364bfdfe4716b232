"""The benchmark's traffic generator: per-stream request columns drawn
from a seed.

A copy of the port's ``serving/loadgen.py::request_stream`` with the
inter-arrival samplers of ``sim/arrivals.py::_interarrivals``: the same
draws in the same order from the same ``numpy.random.Generator``, so a
stream here is the stream the port's generator would draw.  It returns
NumPy columns instead of request objects; the runner turns them into the
program's requests, and the reference reads the columns.

A traffic file (``portbench/traffic/<name>.json``) gives the scenario,
the rate multiplier, the requests drawn a stream and whether those that
arrive past the arrival horizon are dropped (``horizon_cut``, as the
port's ``sim/arrivals.py::generate_trace`` pads an episode's jobs past
it with never-arriving rows); the configuration gives the
base arrival process (load, parallelism, QoS) and the tenants' isolated
latencies come from the reference's cost model.
"""
from __future__ import annotations

import numpy as np

SCENARIOS = ("default", "steady", "burst", "diurnal", "heavy_tail")
QOS_MULT = {"high": 0.8, "medium": 1.0, "low": 1.2}


def interarrivals(scenario: str, mean_ia: float, n: int,
                  rng: np.random.Generator, *, pareto_shape: float = 2.0,
                  burst_size: int = 4, horizon_us: float = 30_000.0):
    """``n`` inter-arrival times with mean ``mean_ia`` for a scenario."""
    if scenario in ("default", "heavy_tail"):
        a = pareto_shape if scenario == "default" else 1.2
        clip = 50.0 if scenario == "default" else 200.0
        xm = mean_ia * (a - 1.0) / a
        inter = xm * (1.0 + rng.pareto(a, size=n))
        return np.minimum(inter, clip * mean_ia)
    if scenario == "steady":
        return mean_ia * rng.uniform(0.8, 1.2, size=n)
    if scenario == "burst":
        bs = max(1, burst_size)
        intra = 0.1 * mean_ia
        gap = bs * mean_ia - (bs - 1) * intra
        inter = np.full(n, intra)
        inter[::bs] = gap * rng.uniform(0.5, 1.5, size=len(inter[::bs]))
        return inter
    if scenario == "diurnal":
        base = 1.0 / mean_ia
        peak = 1.5 * base
        H = max(horizon_us, mean_ia)
        inter = np.empty(n)
        t = prev = 0.0
        for i in range(n):
            while True:
                t += rng.exponential(1.0 / peak)
                rate = base * (1.0 + 0.5 * np.sin(2.0 * np.pi * t / H))
                if rng.uniform() <= rate / peak:
                    break
            inter[i] = t - prev
            prev = t
        return inter
    raise ValueError(f"unknown scenario {scenario!r}; pick one of "
                     f"{SCENARIOS}")


def mean_interarrival(min_lat, arrivals: dict, rate_scale: float) -> float:
    """Mean gap between requests of one stream (us): the calibrated rate
    ``load * eff_parallelism / mean isolated latency``, times
    ``rate_scale``.  ``min_lat`` is float32, as the program holds it."""
    load = arrivals["load"] * rate_scale
    lam = load * arrivals["eff_parallelism"] / float(
        np.mean(np.asarray(min_lat, np.float32)))
    return 1.0 / lam


def stream(min_lat, arrivals: dict, traffic: dict, horizon_us: float,
           rng: np.random.Generator) -> dict:
    """One stream of ``traffic["requests_per_stream"]`` requests drawn,
    less those past ``horizon_us`` with ``traffic["horizon_cut"]``, as
    columns ``rid`` (int), ``model`` (tenant index), ``arrival``,
    ``deadline``, ``q`` (float64 us), in arrival order."""
    min_lat = np.asarray(min_lat, np.float32)
    n = int(traffic["requests_per_stream"])
    mult = arrivals["qos_factor"] * QOS_MULT[arrivals["qos_level"]]
    if mult <= 0:
        raise ValueError(f"non-positive SLA multiplier {mult}")
    mean_ia = mean_interarrival(min_lat, arrivals, traffic["rate_scale"])
    inter = interarrivals(traffic["scenario"], mean_ia, n, rng,
                          pareto_shape=arrivals.get("pareto_shape", 2.0),
                          burst_size=arrivals.get("burst_size", 4),
                          horizon_us=horizon_us)
    arrival = np.cumsum(inter)
    arrival[0] = 0.0
    model = rng.integers(0, len(min_lat), size=n)
    q = mult * min_lat[model] + arrivals["slack_us"]
    cols = dict(rid=np.arange(n), model=model, arrival=arrival,
                deadline=arrival + q, q=q)
    if traffic.get("horizon_cut", False):
        keep = arrival <= horizon_us
        cols = {k: v[keep] for k, v in cols.items()}
    return cols


def call_streams(min_lat, arrivals: dict, traffic: dict, horizon_us: float,
                 seed: int, call: int) -> list[dict]:
    """The streams of call set ``call``: ``traffic["streams"]`` draws from
    one generator seeded by ``(seed, call)``."""
    rng = np.random.default_rng([seed, call])
    return [stream(min_lat, arrivals, traffic, horizon_us, rng)
            for _ in range(int(traffic["streams"]))]
