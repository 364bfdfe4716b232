"""Atomic checkpoints in the JAX package's format.

A checkpoint is ``<dir>/ckpt_<step:010d>.npz`` holding one array per
pytree leaf, keyed by its key path as ``jax.tree_util.keystr`` writes it,
plus a JSON ``__meta__`` record:

- a dict key is ``['name']`` (``['lstm']['wx']``);
- a child of a registered pytree class whose flatten gives no keys is
  ``[<flat index i>]``: a learner state (``DDPGState``, the JAX package's
  and this package's alike) is saved as ``[<flat index 0>]['fc1']['b']``
  ... ``[<flat index 6>]`` for its seven fields in order (actor, critic,
  target_actor, target_critic, actor_opt, critic_opt, step).

So checkpoints cross between the two packages both ways: this module
reads what ``repro.ckpt`` writes and writes what its ``restore`` reads.
Tensors are saved as host NumPy arrays; :func:`restore_checkpoint`
returns NumPy leaves, and the caller moves them to its device.  A
bfloat16 tensor is saved as ``repro.ckpt`` saves a bfloat16 array: 2-byte
``|V2`` records holding its raw bits.  Restored with a bfloat16 tensor
as ``like``'s leaf, the records come back as a bfloat16 tensor, bit for
bit; without ``like`` they stay ``|V2`` (nothing says they are bf16).

- writes are atomic: ``<dir>/tmp.<step>.npz``, then ``os.replace``;
- :class:`CheckpointManager` keeps the newest ``keep`` checkpoints;
- a tree of DTensors (the LM state on a mesh) is saved by every rank:
  each leaf is gathered (``full_tensor``, a collective) and rank 0
  writes; the ranks then meet at a barrier, so any of them may read the
  file next.  The format stays mesh-agnostic.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re

import numpy as np
import torch
from torch.distributed.tensor import DTensor

_PART = re.compile(r"\['([^']*)'\]|\[<flat index (\d+)>\]")


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:010d}.npz")


def _children(tree):
    """-> [(key string, child)] of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(f"['{k}']", tree[k]) for k in sorted(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f"[<flat index {i}>]", getattr(tree, f.name))
                for i, f in enumerate(dataclasses.fields(tree))]
    return None


def _is_int(v) -> bool:
    return isinstance(v, (bool, int)) and not isinstance(v, np.generic)


def _shape(v) -> tuple:
    return tuple(v.shape) if hasattr(v, "shape") else np.shape(v)


BF16_RECORD = np.dtype("V2")     # how NumPy stores a bfloat16 leaf


def _leaf(v) -> np.ndarray:
    if isinstance(v, DTensor):
        v = v.full_tensor()
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(BF16_RECORD)
        return v.numpy()
    if _is_int(v):
        return np.asarray(v, np.int32)          # a step counter
    return np.asarray(v)


def flatten(tree, prefix: str = "") -> dict[str, object]:
    """Key path -> leaf, in the order ``jax.tree_util`` flattens (dict
    keys sorted, dataclass fields in order)."""
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out: dict[str, object] = {}
    for key, child in kids:
        out.update(flatten(child, prefix + key))
    return out


def _rebuild(like, prefix: str, get):
    kids = _children(like)
    if kids is None:
        return get(prefix, like)
    vals = [_rebuild(child, prefix + key, get) for key, child in kids]
    if isinstance(like, dict):
        return dict(zip(sorted(like), vals))
    return type(like)(*vals)


def save_checkpoint(directory: str, step: int, tree,
                    meta: dict | None = None) -> str:
    """Write ``tree`` (nested dicts / a learner-state dataclass of
    tensors, arrays or ints) as ``ckpt_<step>.npz``, atomically."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}.npz")
    final = _path(directory, step)
    flat = flatten(tree)
    arrays = {k: _leaf(v) for k, v in flat.items()}
    sharded = any(isinstance(v, DTensor) for v in flat.values())
    if not sharded or torch.distributed.get_rank() == 0:
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta or {}), **arrays)
        os.replace(tmp, final)
    if sharded:
        torch.distributed.barrier()
    return final


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
    """Nested dicts from key paths; ``[<flat index i>]`` parts become
    int keys."""
    tree: dict = {}
    for key, arr in flat.items():
        parts, pos = [], 0
        for m in _PART.finditer(key):
            if m.start() != pos:
                break
            name, flat_i = m.groups()
            parts.append(name if name is not None else int(flat_i))
            pos = m.end()
        if not parts or pos != len(key):
            raise KeyError(f"checkpoint key {key!r} is not a key path")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def restore_checkpoint(directory: str, like=None, step: int | None = None):
    """Restore a checkpoint.  Returns ``(tree, step, meta)`` with NumPy
    leaves.

    With ``like`` (any tree :func:`save_checkpoint` takes), the result
    has its structure: every key ``like`` flattens to must be in the file
    (``KeyError`` otherwise) with ``like``'s shape (``ValueError``
    otherwise); a Python int leaf comes back as an int, and a bfloat16
    tensor leaf as a bfloat16 CPU tensor of the saved bits.  Without it, the
    result is nested dicts, with int keys for ``[<flat index i>]``
    parts.
    """
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    with np.load(_path(directory, step), allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        if like is None:
            return (_unflatten({k: z[k] for k in z.files if k != "__meta__"}),
                    step, meta)

        def get(key, ref):
            if key not in z.files:
                raise KeyError(f"checkpoint missing {key}")
            arr = z[key]
            if arr.shape != _shape(ref):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"{_shape(ref)}")
            if _is_int(ref):
                return int(arr)
            if isinstance(ref, torch.Tensor) and \
                    ref.dtype == torch.bfloat16:
                if arr.dtype.itemsize != 2:
                    raise TypeError(f"{key}: checkpoint dtype {arr.dtype} "
                                    f"is not a bfloat16 record")
                return torch.from_numpy(np.ascontiguousarray(arr).view(
                    np.int16)).view(torch.bfloat16)
            return arr
        tree = _rebuild(like, "", get)
    return tree, step, meta


class CheckpointManager:
    """Retention + convenience wrapper used by the training driver."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree, meta: dict | None = None) -> str:
        path = save_checkpoint(self.directory, step, tree, meta)
        if not torch.distributed.is_initialized() \
                or torch.distributed.get_rank() == 0:
            self._gc()
        return path

    def restore(self, like, step: int | None = None):
        return restore_checkpoint(self.directory, like, step)

    def latest_step(self):
        return latest_step(self.directory)

    def _gc(self):
        files = sorted(f for f in os.listdir(self.directory)
                       if re.match(r"ckpt_\d+\.npz$", f))
        for f in files[:-self.keep]:
            os.remove(os.path.join(self.directory, f))
