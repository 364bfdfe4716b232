"""Decoder stack of the dense family: a loop over layers whose
parameters are stacked with a leading layer dimension ``(L, ...)``, as
in ``repro.models.transformer`` (where the loop is a ``lax.scan``).

The other families (MoE, Mamba-2, the Jamba hybrid, encoder-decoder,
VLM) are ported with later slices and raise ``NotImplementedError``.
Caches for serving are dicts of stacked ``(L, B, Hkv, S, D)`` tensors.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

LATER = {
    "moe": "the MoE slice (mixtral-8x7b, olmoe-1b-7b)",
    "ssm": "the Mamba-2 slice (mamba2-2.7b, ssd_chunk kernel)",
    "hybrid": "the Mamba-2 and MoE slices (jamba-v0.1-52b)",
    "encdec": "the encoder-decoder slice (whisper-tiny)",
    "vlm": "the VLM slice (internvl2-76b)",
}


def check_family(cfg: ArchConfig) -> None:
    """Raise for a family this package does not run yet."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is ported with "
            f"{LATER.get(cfg.family, 'a later slice')}; this package runs "
            f"the dense family")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def layer_init(gen, cfg: ArchConfig, dtype):
    return {"mixer": L.attention_init(gen, cfg.d_model, cfg.n_heads,
                                      cfg.n_kv, cfg.head_dim, dtype),
            "norm1": L.rmsnorm_init(cfg.d_model, dtype, gen.device),
            "ffn": L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype),
            "norm2": L.rmsnorm_init(cfg.d_model, dtype, gen.device)}


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def stack_init(gen, cfg: ArchConfig, dtype):
    check_family(cfg)
    return _stack([layer_init(gen, cfg, dtype)
                   for _ in range(cfg.n_layers)])


def layer_params(params, i: int):
    """Layer ``i``'s slice of the stacked parameters."""
    if isinstance(params, dict):
        return {k: layer_params(v, i) for k, v in params.items()}
    return params[i]


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------
def _layer_fwd(p, x, cfg: ArchConfig):
    """Full-sequence layer. Returns (x, cache)."""
    h = L.rmsnorm(p["norm1"], x)
    a, (k, v) = L.attention_fwd(p["mixer"], h, window=cfg.window,
                                rope_theta=cfg.rope_theta)
    x = x + a
    x = x + L.mlp_fwd(p["ffn"], L.rmsnorm(p["norm2"], x))
    return x, {"k": k, "v": v}


def _layer_decode(p, x, cache, pos, cfg: ArchConfig):
    h = L.rmsnorm(p["norm1"], x)
    a, cache = L.attention_decode(p["mixer"], h, cache, pos,
                                  window=cfg.window,
                                  rope_theta=cfg.rope_theta)
    x = x + a
    x = x + L.mlp_fwd(p["ffn"], L.rmsnorm(p["norm2"], x))
    return x, cache


# ---------------------------------------------------------------------------
# stacks
# ---------------------------------------------------------------------------
def stack_fwd(params, x, cfg: ArchConfig, collect_cache: bool = False):
    """x (B,S,d) -> (x, stacked cache or None)."""
    check_family(cfg)
    caches = []
    for i in range(cfg.n_layers):
        x, cache = _layer_fwd(layer_params(params, i), x, cfg)
        if collect_cache:
            caches.append(cache)
    return x, (_stack(caches) if collect_cache else None)


def stack_decode(params, caches, x, pos, cfg: ArchConfig):
    """One token through every layer; ``caches`` is updated in place."""
    check_family(cfg)
    for i in range(cfg.n_layers):
        x, _ = _layer_decode(layer_params(params, i), x,
                             layer_params(caches, i), pos, cfg)
    return x, caches
