"""Straggler mitigation helpers, a port of ``repro.runtime.straggler``
(NumPy and the standard library only).

Two mechanisms used by the drivers:

1. ``TimeBudget`` — bounded collection: rollout/data producers are
   given a wall-clock budget; work not delivered in time is *dropped*
   (off-policy DDPG tolerates missing episodes; the data loader
   re-issues the step's batch deterministically).  This is the
   classical backup-task/straggler-drop trick adapted to a
   single-coordinator loop.
2. Deadline-aware scheduling of the MAS itself is the paper's own
   mechanism (RELMAS reacts to SA busy-times through the primer
   encoding): slow sub-accelerators advertise longer busy times and the
   policy routes around them.  :func:`slowdown_schedule` and
   :func:`throttle_schedule` draw the in-episode degradation events of
   the churn schedule (``sim/churn.py``), the same draws, in the same
   order, as the JAX package's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, TypeVar

import numpy as np

T = TypeVar("T")


def _degradation_schedule(rng: np.random.Generator, *, periods: int,
                          num_sas: int, n: int,
                          window: tuple[float, float], magnitude: float
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Shared draw for slowdown/throttle events: (period, sa, mag)."""
    n = max(0, min(int(n), num_sas))
    lo = int(window[0] * periods)
    hi = max(lo + 1, int(window[1] * periods))
    p = rng.integers(lo, hi, size=n)
    sa = rng.choice(num_sas, size=n, replace=False)
    mag = np.full(n, magnitude, np.float32)
    return p.astype(np.int32), sa.astype(np.int32), mag


def slowdown_schedule(rng: np.random.Generator, *, periods: int,
                      num_sas: int, n: int = 1,
                      window: tuple[float, float] = (0.25, 0.75),
                      magnitude: float = 4.0
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Draw ``n`` compute-straggler events: (period, sa, lat_mult).

    From each event's period onward the target SA executes every layer
    ``magnitude``x slower (its advertised busy-times scale with it).
    Distinct SAs, uniform periods inside ``window``.
    """
    return _degradation_schedule(rng, periods=periods, num_sas=num_sas,
                                 n=n, window=window, magnitude=magnitude)


def throttle_schedule(rng: np.random.Generator, *, periods: int,
                      num_sas: int, n: int = 1,
                      window: tuple[float, float] = (0.25, 0.75),
                      magnitude: float = 4.0
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Draw ``n`` memory-path throttle events: (period, sa, bw_mult).

    A throttled SA's DRAM link degrades: its sub-jobs demand
    ``magnitude``x the bus bandwidth per unit of work, so overlapping
    sub-jobs fleet-wide see more stall cycles.  Same draw scheme as
    :func:`slowdown_schedule`.
    """
    return _degradation_schedule(rng, periods=periods, num_sas=num_sas,
                                 n=n, window=window, magnitude=magnitude)


@dataclasses.dataclass
class TimeBudget:
    seconds: float

    def __post_init__(self):
        self._t0 = time.monotonic()

    def reset(self):
        self._t0 = time.monotonic()

    @property
    def exhausted(self) -> bool:
        return time.monotonic() - self._t0 > self.seconds

    def collect(self, producers: Iterable[Callable[[], T]],
                min_items: int = 1) -> list[T]:
        """Run producers until the budget is gone (always >= min_items)."""
        out: list[T] = []
        for p in producers:
            if len(out) >= min_items and self.exhausted:
                break
            out.append(p())
        return out
