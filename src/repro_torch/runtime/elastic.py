"""Elastic scaling: restore a checkpoint onto a *different* mesh.  A
port of ``repro.runtime.elastic``.

Checkpoints are mesh-agnostic host NumPy (``repro_torch.ckpt``, the
JAX package's format); this module re-places them: every leaf becomes a
DTensor with the placements the partition rules give **for the new
mesh**, each rank keeping only its block.  A run checkpointed on one
mesh restores onto another (or onto one device) with no format
conversion; the divisibility fallbacks of ``sharding.logical_spec``
make any mesh legal.  On a mesh of one rank the leaves stay plain
tensors on the mesh's device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.ckpt import restore_checkpoint
from repro_torch.models import partition as PT
from repro_torch.models import sharding as shd


def join_schedule(rng: np.random.Generator, *, periods: int,
                  num_sas: int, n: int = 1,
                  window: tuple[float, float] = (0.25, 0.75)
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Draw ``n`` elastic-join events: (period, sa) int32 arrays.

    The scheduling twin of :func:`reshard_restore`: capacity appears
    mid-run.  A join target is *absent* (invalid) from period 0 until
    its event period, then flips valid (``repro_torch.sim.churn``
    compiles the rows into per-period validity masks).  Distinct SAs,
    uniform periods inside ``window``.
    """
    n = max(0, min(int(n), num_sas))
    lo = int(window[0] * periods)
    hi = max(lo + 1, int(window[1] * periods))
    p = rng.integers(lo, hi, size=n)
    sa = rng.choice(num_sas, size=n, replace=False)
    return p.astype(np.int32), sa.astype(np.int32)


def _tensor(x, device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    return t.to(device)


def device_put_like(tree, mesh, rules, *, kind: str = "param"):
    """Place a tree (nested dicts of tensors or NumPy arrays, the whole
    tree on every rank) onto ``mesh`` per the partition rules: DTensors
    on a mesh of several ranks, each rank keeping its block; plain
    tensors on the mesh's device on a mesh of one rank."""
    device = torch.device(getattr(mesh, "device_type", "cpu"))
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    if not shd.is_multi(mesh):
        return PT.map_with_path(lambda p, x: _tensor(x, device), tree)
    return PT.map_with_path(lambda p, x: shd.place(
        _tensor(x, device), mesh, shd.placements(
            PT.leaf_spec(p, x, mesh, rules, kind), mesh)), tree)


def reshard_restore(directory: str, like, mesh, *, multi_pod: bool = False,
                    rules: shd.ShardingRules | None = None,
                    step: int | None = None, kind: str = "param"):
    """Restore the latest checkpoint (or ``step``) and place it for
    ``mesh``.  ``like`` gives structure, shapes and dtypes (meta tensors
    do).  Returns (placed tree, step, meta)."""
    rules = rules or shd.make_rules(multi_pod)
    host_tree, step, meta = restore_checkpoint(directory, like, step)
    return device_put_like(host_tree, mesh, rules, kind=kind), step, meta
