"""Read the JAX package's checkpoints with NumPy alone.

A checkpoint is ``<dir>/ckpt_<step:010d>.npz`` holding one array per
pytree leaf, keyed by its key path as ``jax.tree_util.keystr`` writes it
(``['lstm']['wx']``), plus a JSON ``__meta__`` record.  This module
lists, reads and unflattens such files into nested dicts of NumPy
arrays, so a JAX-trained specialist actor serves in this package.
Writing checkpoints comes with the training slice.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np

_KEY = re.compile(r"\['([^']*)'\]")


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:010d}.npz")


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def read_checkpoint_meta(directory: str,
                         step: int | None = None) -> dict | None:
    """The ``__meta__`` record of a checkpoint (None if there is none)."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        return None
    with np.load(_path(directory, step), allow_pickle=False) as z:
        return json.loads(str(z["__meta__"]))


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, arr in flat.items():
        parts = _KEY.findall(key)
        if not parts or "".join(f"['{p}']" for p in parts) != key:
            raise KeyError(f"checkpoint key {key!r} is not a dict key path")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def restore_checkpoint(directory: str, step: int | None = None):
    """Restore a checkpoint of nested dicts.  Returns
    ``(tree, step, meta)`` with NumPy leaves."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    with np.load(_path(directory, step), allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    return _unflatten(flat), step, meta
