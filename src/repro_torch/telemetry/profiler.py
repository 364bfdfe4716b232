"""Profiler hooks: ``torch.profiler`` trace capture for drivers, and the
port's spans and counters.

``--profile-dir PATH`` on ``launch/rl_train.py`` / ``launch/serve.py``
wraps the hot loop in :func:`profile_trace`.  The trace is a
Chrome-trace JSON file, ``<dir>/<host>_<pid>.<ns>.pt.trace.json``, for
TensorBoard or Perfetto; its ``user_annotation`` events are the spans
below on the host, its ``kernel`` and ``gpu_memcpy`` events the device's
work on the same clock.

Every range of the port opens through :func:`span`, which enters
``torch.profiler.record_function(name)`` only while a profiler runs and
is a no-op context otherwise (a ``record_function`` costs ~14 us of
host time even with no profiler; the check costs well under 1 us).
:func:`count` keeps ``(name, time.time_ns(), n)`` in a bounded buffer,
also only while a profiler runs; the profiler stamps its host events on
the same epoch clock, so a count lands inside the range that took it.
:func:`counts` returns the buffer.

The spans (:data:`SPANS`), by layer; the tick's and the training
round's carry the JAX package's ``jax.named_scope`` names:

- service loop (``serving/service.py::serve_stream``):
  ``serving.resolve`` (the requests into columns, once a call),
  ``serving.stage`` (a period's admission rows and their copies to the
  device), ``serving.readback`` (the admitted counts, the completion
  mask and the depth to the host), ``serving.record`` (the completion
  records of a period that has some), ``serving.flush`` (the flush,
  its records and the metrics, once a call);
- tick (``core/serve.py::make_serving_tick``): ``serving.admit``,
  ``serving.period``, ``serving.retire``, ``serving.telemetry``;
- period (``sim/env.py::SchedulingEnv.period``): ``env.drops``,
  ``env.slots`` (the ready queue), ``env.encode``, ``env.act`` (the
  actor or heuristic), ``env.commit``; the engine runs between
  ``env.act`` and ``env.commit``;
- engine (``sim/engine.py::_event_loop``): ``engine.simulate`` (the
  whole call), ``engine.check`` (each host check of the plain loop's
  condition, a device-to-host sync every ``CHECK_EVERY`` iterations; on
  the kernel route the one read-back of its iterations);
- training round (``core/train.py``): ``relmas.trace_gen``,
  ``relmas.rollout``, ``relmas.ring_write``, ``relmas.ddpg_update``,
  ``relmas.telemetry``.

The counters (:data:`COUNTERS`), once an engine call (engine layer):
``engine.iterations``, the event loop's iterations (on the kernel route
the most any stream ran); ``engine.kernel``, 1 on the kernel route
(``kernels/event_loop``) and 0 on the plain loop.

:func:`profiling` says whether a profiler runs, for a site whose count
costs a sync.
"""
from __future__ import annotations

import collections
import contextlib
import time

import torch
from torch.profiler import record_function

SPANS = frozenset({
    "serving.resolve", "serving.stage", "serving.readback",
    "serving.record", "serving.flush",
    "serving.admit", "serving.period", "serving.retire", "serving.telemetry",
    "env.drops", "env.slots", "env.encode", "env.act", "env.commit",
    "engine.simulate", "engine.check",
    "relmas.trace_gen", "relmas.rollout", "relmas.ring_write",
    "relmas.ddpg_update", "relmas.telemetry",
})
COUNTERS = frozenset({"engine.iterations", "engine.kernel"})
COUNT_CAP = 1 << 16

profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_COUNTS: collections.deque = collections.deque(maxlen=COUNT_CAP)


def span(name: str):
    """``record_function(name)`` while a profiler runs, else a no-op
    context."""
    if profiling():
        return record_function(name)
    return _OFF


def count(name: str, n: int) -> None:
    """Keep ``(name, time.time_ns(), n)`` while a profiler runs (the
    last :data:`COUNT_CAP` of them)."""
    if profiling():
        _COUNTS.append((name, time.time_ns(), int(n)))


def counts() -> list:
    """The kept counts, oldest first."""
    return list(_COUNTS)


def profile_trace(profile_dir: str | None,
                  device: str | torch.device | None = None):
    """Context manager capturing a ``torch.profiler`` trace into
    ``profile_dir``; a falsy dir is a no-op (the zero-overhead default,
    so drivers can wrap their loop unconditionally).  The device's
    activity is traced when ``device`` is a CUDA device."""
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(profile_dir))
