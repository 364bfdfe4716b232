"""Fleet churn as in-episode event schedules.

RELMAS assumes a fixed accelerator fleet for a whole episode; this
module lets sub-accelerators (SAs) fail, throttle, slow down or join
mid-episode.  A seeded scenario draws a fixed-shape **event list** per
episode and compiles it into per-period churn rows that
:meth:`~repro_torch.sim.env.SchedulingEnv.episode` reads as data.

Representation
--------------
Events are a dict of fixed-shape arrays (``E = max_events`` rows,
padded with ``EV_NONE``)::

    period (..., E) int   first period the event is in effect
    sa     (..., E) int   target sub-accelerator
    code   (..., E) int   EV_FAIL / EV_JOIN / EV_THROTTLE / EV_SLOWDOWN
    mag    (..., E) float multiplier for degradation events

:func:`compile_schedule` turns them into per-period rows::

    valid    (..., T, M) bool     SA may accept new placements this period
    lat_mult (..., T, M) float32  busy-time multiplier (compute slowdown)
    bw_mult  (..., T, M) float32  bus-demand multiplier (memory throttle)

Event semantics (the JAX package's ``sim/churn.py``):

- ``EV_FAIL`` — fail-stop with graceful drain: no new placements from
  the event period onward, committed work finishes and is counted;
- ``EV_JOIN`` — the target SA is absent from period 0 and flips valid
  at the event period (a later JOIN revives an earlier FAIL of the
  same SA: later rows win);
- ``EV_SLOWDOWN`` — every layer on the SA takes ``mag``x its latency;
- ``EV_THROTTLE`` — the SA's sub-jobs demand ``mag``x the shared bus
  bandwidth.

Two draws of the events: the NumPy host path (:func:`churn_events`,
:func:`churn_schedule`, :func:`churn_schedules`), copied from the JAX
package with its draw helpers so both packages compile the same
schedules for the same eval seeds; and the torch twin
(:func:`churn_events_torch`, :func:`churn_schedules_torch`), drawn from
a ``torch.Generator`` on the device for training rounds, under the same
plan, window and ``sa_mask`` rules as ``churn_events_jax``.

An all-no-op schedule (:func:`no_op_schedule`) is the **bit-exact
identity**: every application site is ``x * 1.0`` / ``where(True, x,
_)``, so the churn-enabled episode reproduces the static fleet's bit
for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.runtime.elastic import join_schedule
from repro_torch.runtime.fault import failure_schedule
from repro_torch.runtime.straggler import slowdown_schedule, throttle_schedule

# event codes (the `code` column of the fixed-shape event arrays)
EV_NONE, EV_FAIL, EV_JOIN, EV_THROTTLE, EV_SLOWDOWN = 0, 1, 2, 3, 4

CHURN_SCENARIOS = ("none", "fail", "throttle", "slowdown", "join", "mixed")


@dataclasses.dataclass(frozen=True)
class ChurnConfig:
    """Seeded churn scenario.

    ``max_events`` fixes the event-array shape ``E``; ``n_events`` is
    how many real events the scenario draws (the rest pad with
    ``EV_NONE``).  ``window`` bounds event periods as fractions of the
    episode; ``magnitude`` is the lat/bw multiplier of degradation
    events.  Keep ``n_events`` well below the smallest fleet width.
    """
    scenario: str = "none"
    max_events: int = 4
    n_events: int = 1
    magnitude: float = 4.0
    window: tuple[float, float] = (0.25, 0.75)


def churn_preset(name: str, **overrides) -> ChurnConfig:
    """Build a ChurnConfig for a named scenario (plus overrides)."""
    if name not in CHURN_SCENARIOS:
        raise ValueError(f"unknown churn scenario {name!r}; pick one of "
                         f"{CHURN_SCENARIOS}")
    defaults: dict = {"none": dict(n_events=0), "mixed": dict(n_events=3)}
    kw = {**defaults.get(name, {}), **overrides}
    return ChurnConfig(scenario=name, **kw)


def _event_plan(cfg: ChurnConfig) -> list[int]:
    """Static list of event codes the scenario draws (length <= E)."""
    if cfg.scenario == "none" or cfg.n_events <= 0:
        return []
    n = min(cfg.n_events, cfg.max_events)
    if cfg.scenario == "mixed":
        return [EV_FAIL, EV_THROTTLE, EV_JOIN, EV_SLOWDOWN][:n]
    code = {"fail": EV_FAIL, "throttle": EV_THROTTLE,
            "slowdown": EV_SLOWDOWN, "join": EV_JOIN}[cfg.scenario]
    return [code] * n


def _window(periods: int, window: tuple[float, float]) -> tuple[int, int]:
    lo = int(window[0] * periods)
    return lo, max(lo + 1, int(window[1] * periods))


# ---------------------------------------------------------------------------
# NumPy host path (the JAX package's runtime draw helpers: the fail-stop
# one is ``runtime/fault.py::failure_schedule``, the degradations
# ``runtime/straggler.py``'s, the join's ``runtime/elastic.py``'s)
# ---------------------------------------------------------------------------
def no_op_events(max_events: int = 4) -> dict[str, np.ndarray]:
    """All-``EV_NONE`` event arrays (compiles to the identity schedule)."""
    z = np.zeros((max_events,), np.int32)
    return dict(period=z, sa=z.copy(), code=z.copy(),
                mag=np.ones((max_events,), np.float32))


def churn_events(cfg: ChurnConfig, periods: int, num_sas: int,
                 rng: np.random.Generator) -> dict[str, np.ndarray]:
    """Host-side (NumPy) event draw for one episode; fixed shape
    ``E = cfg.max_events`` regardless of scenario.  The same draws, in
    the same order, as the JAX package's ``churn_events``."""
    ev = no_op_events(cfg.max_events)
    plan = _event_plan(cfg)
    rows: list[tuple[int, int, int, float]] = []
    kw = dict(periods=periods, num_sas=num_sas, window=cfg.window)
    for code in (EV_FAIL, EV_JOIN, EV_THROTTLE, EV_SLOWDOWN):
        n = plan.count(code)
        if not n:
            continue
        if code == EV_FAIL:
            p, sa = failure_schedule(rng, n=n, **kw)
            mag = np.ones(len(p), np.float32)
        elif code == EV_JOIN:
            p, sa = join_schedule(rng, n=n, **kw)
            mag = np.ones(len(p), np.float32)
        elif code == EV_THROTTLE:
            p, sa, mag = throttle_schedule(rng, n=n,
                                           magnitude=cfg.magnitude, **kw)
        else:
            p, sa, mag = slowdown_schedule(rng, n=n,
                                           magnitude=cfg.magnitude, **kw)
        rows += [(int(pi), int(si), code, float(gi))
                 for pi, si, gi in zip(p, sa, mag)]
    for i, (p, s, c, g) in enumerate(rows[:cfg.max_events]):
        ev["period"][i] = p
        ev["sa"][i] = s
        ev["code"][i] = c
        ev["mag"][i] = g
    return ev


# ---------------------------------------------------------------------------
# compiled schedules (torch)
# ---------------------------------------------------------------------------
def compile_schedule(events: dict, periods: int, num_sas: int,
                     device=None) -> dict[str, torch.Tensor]:
    """Events -> per-period churn rows.

    ``events`` holds arrays or tensors of shape ``(..., E)``; returns
    ``dict(valid (..., T, M) bool, lat_mult (..., T, M) float32,
    bw_mult (..., T, M) float32)`` on ``device`` (default: the events'
    device, or the CPU for NumPy events).  Later event rows win per
    field (a JOIN after a FAIL of the same SA revives it); a JOIN
    target is invalid from period 0 until its event period.  The same
    ``where`` sequence as the JAX package's ``compile_schedule``, so
    the rows are bit-equal for the same events.
    """
    ev = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                             else v, device=device)
          for k, v in events.items()}
    dev = ev["period"].device
    T, M = periods, num_sas
    lead = tuple(ev["period"].shape[:-1])
    tt = torch.arange(T, device=dev)[:, None]                    # (T, 1)
    cols = torch.arange(M, device=dev)[None, :]                  # (1, M)
    valid = torch.ones(lead + (T, M), dtype=torch.bool, device=dev)
    lat = torch.ones(lead + (T, M), dtype=torch.float32, device=dev)
    bwm = torch.ones(lead + (T, M), dtype=torch.float32, device=dev)
    x = lambda k, e: ev[k][..., e][..., None, None]              # (..., 1, 1)
    for e in range(int(ev["period"].shape[-1])):
        p, c = x("period", e), x("code", e)
        g = x("mag", e).to(torch.float32)
        col = cols == x("sa", e)
        after, before = col & (tt >= p), col & (tt < p)
        valid = torch.where(after & (c == EV_FAIL), False, valid)
        valid = torch.where(before & (c == EV_JOIN), False, valid)
        valid = torch.where(after & (c == EV_JOIN), True, valid)
        lat = torch.where(after & (c == EV_SLOWDOWN), g, lat)
        bwm = torch.where(after & (c == EV_THROTTLE), g, bwm)
    return dict(valid=valid, lat_mult=lat, bw_mult=bwm)


def no_op_schedule(periods: int, num_sas: int,
                   batch: int | None = None) -> dict[str, torch.Tensor]:
    """The identity schedule: all valid, all multipliers 1.0 (with a
    leading ``batch`` axis when given)."""
    shape = ((batch,) if batch is not None else ()) + (periods, num_sas)
    return dict(valid=torch.ones(shape, dtype=torch.bool),
                lat_mult=torch.ones(shape, dtype=torch.float32),
                bw_mult=torch.ones(shape, dtype=torch.float32))


def churn_schedule(cfg: ChurnConfig, periods: int, num_sas: int,
                   rng: np.random.Generator, width: int | None = None,
                   device=None) -> dict[str, torch.Tensor]:
    """Draw (NumPy) + compile one episode's schedule.

    Events are drawn over the ``num_sas`` *real* SAs and compiled at
    ``width`` columns (default ``num_sas``): a padded ``M_max`` env and
    the plain env see identical real-SA events for the same ``rng``.
    """
    ev = churn_events(cfg, periods, num_sas, rng)
    return compile_schedule(ev, periods, width or num_sas, device)


def churn_schedules(cfg: ChurnConfig, periods: int, num_sas: int, seeds,
                    width: int | None = None,
                    device=None) -> dict[str, torch.Tensor]:
    """One deterministic schedule per eval seed, stacked over ``(B,)``,
    each seeded ``default_rng([seed, 0xC1])`` as in the JAX package, so
    both packages evaluate under the same schedules."""
    scheds = [churn_schedule(cfg, periods, num_sas,
                             np.random.default_rng([int(s), 0xC1]), width,
                             device)
              for s in seeds]
    return {k: torch.stack([s[k] for s in scheds]) for k in scheds[0]}


# ---------------------------------------------------------------------------
# torch.Generator twin (training rounds)
# ---------------------------------------------------------------------------
def churn_events_torch(cfg: ChurnConfig, periods: int, num_sas: int,
                       gen: torch.Generator, batch: int,
                       sa_mask=None) -> dict[str, torch.Tensor]:
    """``batch`` episodes' events drawn from ``gen`` (on its device):
    the counterpart of
    ``churn_events_jax`` vmapped over keys, under the same rules.

    The event codes follow the scenario's plan; periods are uniform in
    the window; the targets are the first ``E`` entries (mod
    ``num_sas``) of an argsort of uniform scores, raised by 1e9 outside
    ``sa_mask`` (the real SAs of a padded fleet), so they are distinct
    valid SAs.  Parity with the NumPy path is distributional.
    """
    device = gen.device
    E = cfg.max_events
    plan = _event_plan(cfg)
    code = torch.tensor(list(plan) + [EV_NONE] * (E - len(plan)),
                        dtype=torch.int64, device=device)
    degr = (code == EV_THROTTLE) | (code == EV_SLOWDOWN)
    mag = torch.where(degr, float(cfg.magnitude), 1.0).to(torch.float32)
    lo, hi = _window(periods, cfg.window)
    p = torch.randint(lo, hi, (batch, E), generator=gen, device=device)
    scores = torch.rand((batch, num_sas), generator=gen, device=device)
    if sa_mask is not None:
        scores = scores + torch.where(sa_mask.to(device), 0.0, 1e9)
    order = torch.argsort(scores, dim=1, stable=True)
    sa = order[:, torch.arange(E, device=device) % num_sas]
    return dict(period=p, sa=sa, code=code.expand(batch, E),
                mag=mag.expand(batch, E))


def churn_schedules_torch(cfg: ChurnConfig, periods: int, num_sas: int,
                          gen: torch.Generator, batch: int,
                          sa_mask=None) -> dict[str, torch.Tensor]:
    """``batch`` compiled schedules ``(batch, periods, num_sas)`` drawn
    from ``gen`` (the counterpart of ``churn_schedules_jax``)."""
    ev = churn_events_torch(cfg, periods, num_sas, gen, batch, sa_mask)
    return compile_schedule(ev, periods, num_sas)
