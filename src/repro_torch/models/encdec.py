"""Encoder-decoder stack (Whisper-class), a port of
``repro.models.encdec``.  Its blocks take the sharding context
(``layers.Ctx``) at the reference's sites, and its steps run on a mesh
of several ranks.

The audio frontend (log-mel and two convolutions) is a stub in the
reference too: the batch carries precomputed frame embeddings
``frames`` (B, n_frames, d), and the transformer backbone is what runs.
Positions are fixed sinusoids; attention is bidirectional in the
encoder and causal in the decoder, and every decoder layer has a
cross-attention sublayer reading the encoder output.  Neither side
uses RoPE.

Parameters are stacked with a leading layer dimension, ``enc`` (L_enc,
...) and ``dec`` (L, ...), as the reference's ``lax.scan`` stacks them.
The serving cache is ``{"self": {"k", "v"}, "cross": {"k", "v"}}``,
each ``(L, B, H, S or Se, D)``: the decoder's self-attention keys and
values, written in place one slot per decode step as the dense decode
writes its cache, and the cross-attention keys and values of the
encoder output, computed once at prefill.  Under autograd with
``cfg.remat`` every encoder and decoder layer is recomputed in the
backward, as the reference's ``jax.checkpoint`` of its scan bodies.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import (layer_params, remat,
                                            stack_trees)

# parameter keys of one encoder and one decoder layer
ENC_LAYER_KEYS = {"attn", "mlp", "norm1", "norm2"}
DEC_LAYER_KEYS = {"attn", "cross", "mlp", "norm1", "norm2", "norm3"}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _attn_init(gen, cfg: ArchConfig, dtype):
    return L.attention_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv,
                            cfg.head_dim, dtype)


def _enc_layer_init(gen, cfg: ArchConfig, dtype):
    d = cfg.d_model
    return {"attn": _attn_init(gen, cfg, dtype),
            "mlp": L.mlp_init(gen, d, cfg.d_ff, dtype, gated=False),
            "norm1": L.rmsnorm_init(d, dtype, gen.device),
            "norm2": L.rmsnorm_init(d, dtype, gen.device)}


def _dec_layer_init(gen, cfg: ArchConfig, dtype):
    d = cfg.d_model
    return {"attn": _attn_init(gen, cfg, dtype),
            "cross": _attn_init(gen, cfg, dtype),
            "mlp": L.mlp_init(gen, d, cfg.d_ff, dtype, gated=False),
            "norm1": L.rmsnorm_init(d, dtype, gen.device),
            "norm2": L.rmsnorm_init(d, dtype, gen.device),
            "norm3": L.rmsnorm_init(d, dtype, gen.device)}


def encdec_init(gen, cfg: ArchConfig, dtype):
    """{"enc", "dec", "enc_norm"}: the stacked encoder and decoder
    layers and the encoder's final norm."""
    enc = stack_trees([_enc_layer_init(gen, cfg, dtype)
                       for _ in range(cfg.enc_layers)])
    dec = stack_trees([_dec_layer_init(gen, cfg, dtype)
                       for _ in range(cfg.n_layers)])
    return {"enc": enc, "dec": dec,
            "enc_norm": L.rmsnorm_init(cfg.d_model, dtype, gen.device)}


def check_keys(cfg: ArchConfig, params) -> None:
    """Raise unless the stacked encoder and decoder layers have the
    reference's keys (attention ``wq``/``wk``/``wv``/``wo``, a GELU MLP
    of ``w_up``/``w_down``)."""
    attn = {"wq", "wk", "wv", "wo"}
    mlp = {"w_up", "w_down"}
    for side, want in (("enc", ENC_LAYER_KEYS), ("dec", DEC_LAYER_KEYS)):
        lp = params[side]
        checks = [(side, lp, want), (f"{side}.mlp", lp.get("mlp", {}), mlp)]
        checks += [(f"{side}.{a}", lp.get(a, {}), attn)
                   for a in ("attn", "cross") if a in want]
        for what, got, keys in checks:
            if set(got) != keys:
                raise ValueError(f"{cfg.name}: {what} params have keys "
                                 f"{sorted(got)}, expected {sorted(keys)}")


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------
def encode(params, frames, cfg: ArchConfig, ctx: L.Ctx = L.NO_CTX):
    """frames (B, Se, d) stub embeddings -> encoder output (B, Se, d):
    non-causal attention without RoPE over all Se frames."""
    _, Se, d = frames.shape
    x = frames + L.sinusoidal_positions(Se, d, device=frames.device
                                        )[None].to(frames.dtype)
    x = ctx.shard(x, ("batch", None, None))
    for i in range(cfg.enc_layers):
        x = remat(_enc_layer_fwd, cfg, layer_params(params["enc"], i), x,
                  ctx)
    return L.rmsnorm(params["enc_norm"], x)


def _enc_layer_fwd(lp, x, ctx):
    a, _ = L.attention_fwd(lp["attn"], L.rmsnorm(lp["norm1"], x),
                           causal=False, use_rope=False, ctx=ctx)
    x = x + a
    return x + L.mlp_fwd(lp["mlp"], L.rmsnorm(lp["norm2"], x), ctx)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------
def _dec_layer_fwd(lp, x, enc_out, ctx):
    """One decoder layer over the whole sequence.  Returns (x, cache)."""
    a, (k, v) = L.attention_fwd(lp["attn"], L.rmsnorm(lp["norm1"], x),
                                causal=True, use_rope=False, ctx=ctx)
    x = x + a
    ck, cv = L.cross_kv(lp["cross"], enc_out, ctx)
    x = x + L.cross_attention_fwd(lp["cross"], L.rmsnorm(lp["norm2"], x),
                                  (ck, cv), ctx)
    x = x + L.mlp_fwd(lp["mlp"], L.rmsnorm(lp["norm3"], x), ctx)
    return x, {"self": {"k": k, "v": v}, "cross": {"k": ck, "v": cv}}


def decode_fwd(params, x, enc_out, cfg: ArchConfig,
               collect_cache: bool = False, ctx: L.Ctx = L.NO_CTX):
    """Teacher-forced decoder pass over token embeddings x (B,S,d), the
    sinusoid of 0..S-1 added.  Returns (x, stacked cache or None)."""
    S, d = x.shape[1], x.shape[2]
    x = x + L.sinusoidal_positions(S, d, device=x.device)[None].to(x.dtype)
    caches = []
    for i in range(cfg.n_layers):
        x, cache = remat(_dec_layer_fwd, cfg, layer_params(params["dec"], i),
                         x, enc_out, ctx)
        if collect_cache:
            caches.append(cache)
    return x, (stack_trees(caches) if collect_cache else None)


def decode_step(params, caches, x, pos, cfg: ArchConfig,
                ctx: L.Ctx = L.NO_CTX):
    """One token x (B,1,d) at positions ``pos`` (B,); the self cache is
    written in place, the cross cache only read."""
    x = x + L.sinusoid(pos, x.shape[-1])[:, None, :].to(x.dtype)
    for i in range(cfg.n_layers):
        lp = layer_params(params["dec"], i)
        cache = layer_params(caches, i)
        a, _ = L.attention_decode(lp["attn"], L.rmsnorm(lp["norm1"], x),
                                  cache["self"], pos, use_rope=False,
                                  ctx=ctx)
        x = x + a
        x = x + L.cross_attention_decode(lp["cross"],
                                         L.rmsnorm(lp["norm2"], x),
                                         cache["cross"], ctx)
        x = x + L.mlp_fwd(lp["mlp"], L.rmsnorm(lp["norm3"], x), ctx)
    return x, caches


def init_cache(cfg: ArchConfig, B: int, smax: int, dtype, device):
    """Zero self cache of ``smax`` slots and zero cross cache of
    ``cfg.n_frames`` (what a decode step attends to when no prefill
    filled it, as in the reference batcher)."""
    def kv(S):
        shape = (cfg.n_layers, B, cfg.n_kv, S, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    return {"self": kv(smax), "cross": kv(cfg.n_frames)}
