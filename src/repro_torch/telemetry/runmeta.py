"""Run provenance: git commit, wall-clock timestamp, torch identity.

The counterpart of the JAX package's ``telemetry/runmeta.py``:
:func:`git_sha` and :func:`iso_now` are the same functions, and
:func:`run_meta` returns the same fields without importing JAX
(``jax_version`` is ``"none"``: schema v1 requires the field and this
package never imports JAX), plus the PyTorch build, the device and its
power limit, so a number in a stream can be read beside the card and
the limit it ran under.  Telemetry never fails a run: whatever cannot
be read (no git, a checkout without ``.git``, no ``nvidia-smi``)
reads ``"unknown"``.
"""
from __future__ import annotations

import datetime
import functools
import os
import subprocess

import torch


@functools.lru_cache(maxsize=1)
def git_sha() -> str:
    """HEAD commit of the repo containing this file (``unknown`` when
    git is unavailable — telemetry must never fail a run).  A dirty
    working tree is marked with a ``-dirty`` suffix."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=repo, capture_output=True,
            text=True, timeout=10, check=True).stdout.strip()
        dirty = subprocess.run(
            ["git", "status", "--porcelain"], cwd=repo,
            capture_output=True, text=True, timeout=10, check=True)
        return sha + ("-dirty" if dirty.stdout.strip() else "")
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def iso_now() -> str:
    """Current UTC time as an ISO-8601 string (second precision)."""
    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ")


@functools.lru_cache(maxsize=1)
def power_limit_w() -> float | str:
    """Power limit of the first card in watts, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` reports it (``unknown``
    when it cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=10, check=True).stdout
        return float(out.splitlines()[0].rsplit(",", 1)[1].split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return "unknown"


def run_meta(device: str | torch.device | None = None) -> dict:
    """The provenance block: commit, timestamp, the reference's
    ``jax_version``/``backend``/``host_cores`` fields and the torch
    identity.  ``backend`` is the run's device type (``cuda`` or
    ``cpu``); without a ``device``, ``cuda`` when a card is present."""
    backend = (torch.device(device).type if device is not None else
               "cuda" if torch.cuda.is_available() else "cpu")
    on_card = backend == "cuda"
    return dict(git_sha=git_sha(), created_at=iso_now(),
                jax_version="none", backend=backend,
                host_cores=os.cpu_count() or 1,
                torch_version=torch.__version__,
                cuda_version=torch.version.cuda or "none",
                device_name=(torch.cuda.get_device_name(0) if on_card
                             else "cpu"),
                power_limit_w=power_limit_w() if on_card else "unknown")
