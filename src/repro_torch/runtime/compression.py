"""Gradient compression with error feedback, a port of
``repro.runtime.compression``.

Two schemes, both carrying the residual of the lossy round-trip into
the next step (Karimireddy et al. 2019):

- **int8 quantization**: per-leaf symmetric max-abs scaling (scale =
  max |x| / 127, rounded half to even as ``jnp.round``), 4x fewer bytes;
- **top-k sparsification**: keep the entries with |x| at least the
  k-th largest, ``k = max(1, int(k_frac * n))``.

The LM driver calls ``compress_grads`` / ``decompress_grads`` around
the data-parallel boundary under ``--compress`` (``launch/train.py``).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import tree_leaves, tree_map

F32 = torch.float32
Tree = Any


def quantize_int8(x):
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(F32) * scale


def topk_sparsify(x, k_frac: float):
    """Zero all but the ``max(1, int(k_frac * n))`` largest-|x| entries
    (ties with the k-th kept, as the reference)."""
    flat = x.reshape(-1)
    k = max(1, int(k_frac * flat.shape[0]))
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    return torch.where(torch.abs(x) >= thresh, x, torch.zeros_like(x))


class CompressionState:
    """Per-leaf error-feedback residuals."""

    @staticmethod
    def init(params) -> Tree:
        return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                              device=p.device), params)


def compress_grads(grads: Tree, residual: Tree, *, scheme: str = "int8",
                   k_frac: float = 0.01):
    """-> (payload tree, new_residual).  The payload is what would cross
    the data-parallel fabric: ``{"q": int8, "s": scale}`` or ``{"v":
    sparse values}`` per leaf."""
    def one(g, r):
        gf = g.to(F32) + r
        if scheme == "int8":
            q, s = quantize_int8(gf)
            return {"q": q, "s": s}, gf - dequantize_int8(q, s)
        sp = topk_sparsify(gf, k_frac)
        return {"v": sp}, gf - sp

    pairs = tree_map(one, grads, residual)
    return (tree_map(lambda p: p[0], pairs),
            tree_map(lambda p: p[1], pairs))


def decompress_grads(payload: Tree, *, scheme: str = "int8"):
    def one(p):
        if "q" in p or "v" in p:
            return dequantize_int8(p["q"], p["s"]) if scheme == "int8" \
                else p["v"]
        return {k: one(v) for k, v in p.items()}
    return one(payload)


def compression_ratio(grads: Tree, *, scheme: str = "int8",
                      k_frac: float = 0.01) -> float:
    leaves = tree_leaves(grads)
    raw = sum(g.numel() * 4 for g in leaves)
    if scheme == "int8":
        comp = sum(g.numel() * 1 + 4 for g in leaves)
    else:
        comp = sum(int(max(1, k_frac * g.numel())) * 8 for g in leaves)
    return raw / comp
