"""Decoder stacks of the dense and Mamba-2 (``ssm``) families: a loop
over layers whose parameters are stacked with a leading layer dimension
``(L, ...)``, as in ``repro.models.transformer`` (where the loop is a
``lax.scan``).  A dense layer is attention + gated MLP; an SSM layer is
a Mamba-2 mixer with no FFN.

The other families (MoE, the Jamba hybrid, encoder-decoder, VLM) are
ported with later slices and raise ``NotImplementedError``.  Caches for
serving are dicts of stacked tensors: ``k``/``v`` ``(L, B, Hkv, S, D)``
for the dense family, ``ssm`` ``(L, B, H, N, P)`` and ``conv``
``(L, B, K-1, conv_dim)`` for the SSM family.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM

FAMILIES = ("dense", "ssm")
LATER = {
    "moe": "the MoE slice (mixtral-8x7b, olmoe-1b-7b)",
    "hybrid": "the MoE slice (jamba-v0.1-52b: its Mamba-2 layers are "
              "ported, its MoE layers are not)",
    "encdec": "the encoder-decoder slice (whisper-tiny)",
    "vlm": "the VLM slice (internvl2-76b)",
}
# parameter keys of one layer and of its mixer, by (mixer, ffn) kind
LAYER_KEYS = {("attn", "mlp"): {"mixer", "norm1", "ffn", "norm2"},
              ("ssm", ""): {"mixer", "norm1"}}
MIXER_KEYS = {"attn": {"wq", "wk", "wv", "wo"},
              "ssm": {"w_in", "conv_w", "A_log", "D", "dt_bias", "norm",
                      "w_out"}}


def check_family(cfg: ArchConfig) -> None:
    """Raise for a family this package does not run yet."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is ported with "
            f"{LATER.get(cfg.family, 'a later slice')}; this package runs "
            f"the {' and '.join(FAMILIES)} families")


def _kinds(cfg: ArchConfig) -> tuple[str, str]:
    """(mixer, ffn) kind of every layer: ("ssm", "") for Mamba-2 (no
    FFN), ("attn", "mlp") for the dense family."""
    return ("ssm", "") if cfg.family == "ssm" else ("attn", "mlp")


def check_stack_keys(cfg: ArchConfig, stack) -> None:
    """Raise unless the stacked layer params ``stack`` have the keys of
    the family's layers and mixers."""
    mixer, ffn = _kinds(cfg)
    for what, got, want in (("layer", stack, LAYER_KEYS[(mixer, ffn)]),
                            ("mixer", stack.get("mixer", {}),
                             MIXER_KEYS[mixer])):
        if set(got) != want:
            raise ValueError(f"{cfg.name}: {what} params have keys "
                             f"{sorted(got)}, expected {sorted(want)}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def layer_init(gen, cfg: ArchConfig, mixer: str, ffn: str, dtype):
    if mixer == "attn":
        m = L.attention_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv,
                             cfg.head_dim, dtype)
    else:
        m = SSM.ssm_init(gen, cfg.d_model, cfg.ssm_expand, cfg.ssm_headdim,
                         cfg.ssm_state, cfg.ssm_conv, dtype)
    p = {"mixer": m, "norm1": L.rmsnorm_init(cfg.d_model, dtype, gen.device)}
    if ffn:
        p["ffn"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)
        p["norm2"] = L.rmsnorm_init(cfg.d_model, dtype, gen.device)
    return p


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def stack_init(gen, cfg: ArchConfig, dtype):
    check_family(cfg)
    mixer, ffn = _kinds(cfg)
    return _stack([layer_init(gen, cfg, mixer, ffn, dtype)
                   for _ in range(cfg.n_layers)])


def layer_params(params, i: int):
    """Layer ``i``'s slice of the stacked parameters."""
    if isinstance(params, dict):
        return {k: layer_params(v, i) for k, v in params.items()}
    return params[i]


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------
def _layer_fwd(p, x, cfg: ArchConfig, mixer: str, ffn: str):
    """Full-sequence layer. Returns (x, cache)."""
    h = L.rmsnorm(p["norm1"], x)
    if mixer == "attn":
        a, (k, v) = L.attention_fwd(p["mixer"], h, window=cfg.window,
                                    rope_theta=cfg.rope_theta)
        cache = {"k": k, "v": v}
    else:
        a, cache = SSM.ssm_fwd(p["mixer"], h, cfg)
    x = x + a
    if ffn:
        x = x + L.mlp_fwd(p["ffn"], L.rmsnorm(p["norm2"], x))
    return x, cache


def _layer_decode(p, x, cache, pos, cfg: ArchConfig, mixer: str, ffn: str):
    h = L.rmsnorm(p["norm1"], x)
    if mixer == "attn":
        a, cache = L.attention_decode(p["mixer"], h, cache, pos,
                                      window=cfg.window,
                                      rope_theta=cfg.rope_theta)
    else:
        a, cache = SSM.ssm_decode(p["mixer"], h, cache, cfg)
    x = x + a
    if ffn:
        x = x + L.mlp_fwd(p["ffn"], L.rmsnorm(p["norm2"], x))
    return x, cache


# ---------------------------------------------------------------------------
# stacks
# ---------------------------------------------------------------------------
def stack_fwd(params, x, cfg: ArchConfig, collect_cache: bool = False):
    """x (B,S,d) -> (x, stacked cache or None)."""
    check_family(cfg)
    mixer, ffn = _kinds(cfg)
    caches = []
    for i in range(cfg.n_layers):
        x, cache = _layer_fwd(layer_params(params, i), x, cfg, mixer, ffn)
        if collect_cache:
            caches.append(cache)
    return x, (_stack(caches) if collect_cache else None)


def stack_decode(params, caches, x, pos, cfg: ArchConfig):
    """One token through every layer; ``caches`` is updated in place."""
    check_family(cfg)
    mixer, ffn = _kinds(cfg)
    for i in range(cfg.n_layers):
        x, _ = _layer_decode(layer_params(params, i), x,
                             layer_params(caches, i), pos, cfg, mixer, ffn)
    return x, caches
