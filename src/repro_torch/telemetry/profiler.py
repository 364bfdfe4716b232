"""Profiler hooks: ``torch.profiler`` trace capture for drivers.

``--profile-dir PATH`` on ``launch/rl_train.py`` / ``launch/serve.py``
wraps the hot loop in :func:`profile_trace`.  The trace is readable
because the round body and the serving tick are annotated with
``torch.profiler.record_function`` ranges under the JAX package's
``jax.named_scope`` names (``relmas.trace_gen``, ``relmas.rollout``,
``relmas.ring_write``, ``relmas.ddpg_update``, ``relmas.telemetry``;
``serving.admit``, ``serving.period``, ``serving.retire``,
``serving.telemetry``).  The trace is a Chrome-trace JSON file,
``<dir>/<host>_<pid>.<ns>.pt.trace.json``, for TensorBoard or
Perfetto; its ``user_annotation`` events are those ranges on the host,
its ``kernel`` and ``gpu_memcpy`` events the device's work.
"""
from __future__ import annotations

import contextlib

import torch


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
