"""Failure injection + checkpoint-restart supervision, a port of
``repro.runtime.fault`` (NumPy and the standard library only).

``run_with_restarts`` is the fault-tolerance contract of the LM training
driver: the loop body is a function of restored state; an injected
``SimulatedFailure`` (standing in for a node loss) rolls back to the
last atomic checkpoint and replays.  With the step-indexed data pipeline
every optimizer update then happens exactly once, at checkpoint
granularity.  ``failure_schedule`` draws the fail-stop events of the
in-episode churn schedule (``sim/churn.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np


class SimulatedFailure(RuntimeError):
    """Stand-in for a node crash / preemption."""


def failure_schedule(rng: np.random.Generator, *, periods: int,
                     num_sas: int, n: int = 1,
                     window: tuple[float, float] = (0.25, 0.75)
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Draw ``n`` fail-stop events for the in-episode churn schedule.

    Returns ``(period, sa)`` int32 arrays: each event marks one SA as
    failed from that period onward.  Events land uniformly inside
    ``window`` (fractions of the episode) and target *distinct* SAs;
    ``n`` is clamped to ``num_sas - 1`` so at least one SA survives.
    The same draws, in the same order, as the JAX package's.
    """
    n = max(0, min(int(n), num_sas - 1))
    lo = int(window[0] * periods)
    hi = max(lo + 1, int(window[1] * periods))
    p = rng.integers(lo, hi, size=n)
    sa = rng.choice(num_sas, size=n, replace=False)
    return p.astype(np.int32), sa.astype(np.int32)


@dataclasses.dataclass
class FailureInjector:
    """Raises at fixed steps (deterministic tests) or with prob/step."""
    at_steps: tuple[int, ...] = ()
    prob: float = 0.0
    seed: int = 0
    _fired: set = dataclasses.field(default_factory=set)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def maybe_fail(self, step: int):
        if step in self._fired:
            return                       # don't re-kill a replayed step
        if step in self.at_steps or (self.prob > 0
                                     and self._rng.random() < self.prob):
            self._fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")


def run_with_restarts(*, init_fn: Callable[[], tuple[Any, int]],
                      restore_fn: Callable[[], tuple[Any, int] | None],
                      step_fn: Callable[[Any, int], Any],
                      save_fn: Callable[[Any, int], None],
                      total_steps: int, ckpt_every: int,
                      max_restarts: int = 8,
                      on_event: Callable[[str], None] = lambda s: None):
    """Supervised training loop.  Returns (final_state, restarts)."""
    restarts = 0
    while True:
        restored = restore_fn()
        if restored is not None:
            state, start = restored
            on_event(f"restored at step {start}")
        else:
            state, start = init_fn()
        try:
            for step in range(start, total_steps):
                state = step_fn(state, step)
                if (step + 1) % ckpt_every == 0 or step == total_steps - 1:
                    save_fn(state, step + 1)
            return state, restarts
        except SimulatedFailure as e:
            state = None        # drop the failed attempt's state first
            restarts += 1
            on_event(f"failure: {e} (restart {restarts})")
            if restarts > max_restarts:
                raise
