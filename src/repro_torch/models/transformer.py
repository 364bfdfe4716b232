"""Decoder stacks of the dense, MoE and Mamba-2 (``ssm``) families: a
loop over layers whose parameters are stacked with a leading layer
dimension ``(L, ...)``, as in ``repro.models.transformer`` (where the
loop is a ``lax.scan``).  A dense layer is attention + gated MLP, a MoE
layer attention + the MoE FFN (``models/moe.py``); an SSM layer is a
Mamba-2 mixer with no FFN.  The encoder-decoder family has its own
stack (``models/encdec.py``).

The Jamba hybrid and the VLM are ported with later slices and raise
``NotImplementedError``.  Caches for serving are dicts of stacked
tensors: ``k``/``v`` ``(L, B, Hkv, S, D)`` for the dense and MoE
families, ``ssm`` ``(L, B, H, N, P)`` and ``conv`` ``(L, B, K-1,
conv_dim)`` for the SSM family.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

FAMILIES = ("dense", "moe", "ssm", "encdec")
LATER = {
    "hybrid": "the hybrid slice (jamba-v0.1-52b: its Mamba-2 and MoE "
              "layers are ported, its super-block layout is not)",
    "vlm": "the VLM slice (internvl2-76b)",
}
# parameter keys of one layer, of its mixer and of its FFN, by kind
LAYER_KEYS = {("attn", "mlp"): {"mixer", "norm1", "ffn", "norm2"},
              ("attn", "moe"): {"mixer", "norm1", "ffn", "norm2"},
              ("ssm", ""): {"mixer", "norm1"}}
MIXER_KEYS = {"attn": {"wq", "wk", "wv", "wo"},
              "ssm": {"w_in", "conv_w", "A_log", "D", "dt_bias", "norm",
                      "w_out"}}
FFN_KEYS = {"mlp": {"w_up", "w_down", "w_gate"}, "moe": MOE.KEYS}


def check_family(cfg: ArchConfig) -> None:
    """Raise for a family this package does not run yet."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is ported with "
            f"{LATER.get(cfg.family, 'a later slice')}; this package runs "
            f"the {', '.join(FAMILIES)} families")


def _kinds(cfg: ArchConfig) -> tuple[str, str]:
    """(mixer, ffn) kind of every layer: ("ssm", "") for Mamba-2 (no
    FFN), ("attn", "moe") for the MoE family, ("attn", "mlp") for the
    dense family."""
    if cfg.family == "ssm":
        return "ssm", ""
    return "attn", ("moe" if cfg.is_moe else "mlp")


def check_stack_keys(cfg: ArchConfig, stack) -> None:
    """Raise unless the stacked layer params ``stack`` have the keys of
    the family's layers, mixers and FFNs."""
    mixer, ffn = _kinds(cfg)
    checks = [("layer", stack, LAYER_KEYS[(mixer, ffn)]),
              ("mixer", stack.get("mixer", {}), MIXER_KEYS[mixer])]
    if ffn:
        checks.append(("ffn", stack.get("ffn", {}), FFN_KEYS[ffn]))
    for what, got, want in checks:
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
    if ffn == "moe":
        p["ffn"] = MOE.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                                dtype)
    elif ffn:
        p["ffn"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)
    if ffn:
        p["norm2"] = L.rmsnorm_init(cfg.d_model, dtype, gen.device)
    return p


def stack_trees(trees):
    """Nested dicts of equal layout -> one nested dict whose tensors
    are stacked along a new leading dimension."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def stack_init(gen, cfg: ArchConfig, dtype):
    check_family(cfg)
    mixer, ffn = _kinds(cfg)
    return stack_trees([layer_init(gen, cfg, mixer, ffn, dtype)
                        for _ in range(cfg.n_layers)])


def layer_params(params, i: int):
    """Layer ``i``'s slice of the stacked parameters."""
    if isinstance(params, dict):
        return {k: layer_params(v, i) for k, v in params.items()}
    return params[i]


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------
def _ffn(p, x, cfg: ArchConfig, ffn: str, with_aux: bool = False):
    """The layer's FFN on x: (out, MoE aux loss, or None without MoE or
    ``with_aux``)."""
    if ffn == "moe":
        return MOE.moe_fwd(p, x, top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor,
                           with_aux=with_aux)
    return L.mlp_fwd(p, x), None


def _layer_fwd(p, x, cfg: ArchConfig, mixer: str, ffn: str,
               with_aux: bool = False):
    """Full-sequence layer. Returns (x, cache, aux or None)."""
    h = L.rmsnorm(p["norm1"], x)
    if mixer == "attn":
        a, (k, v) = L.attention_fwd(p["mixer"], h, window=cfg.window,
                                    rope_theta=cfg.rope_theta)
        cache = {"k": k, "v": v}
    else:
        a, cache = SSM.ssm_fwd(p["mixer"], h, cfg)
    x = x + a
    aux = None
    if ffn:
        f, aux = _ffn(p["ffn"], L.rmsnorm(p["norm2"], x), cfg, ffn,
                      with_aux)
        x = x + f
    return x, cache, aux


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
        x = x + _ffn(p["ffn"], L.rmsnorm(p["norm2"], x), cfg, ffn)[0]
    return x, cache


# ---------------------------------------------------------------------------
# stacks
# ---------------------------------------------------------------------------
def stack_fwd(params, x, cfg: ArchConfig, collect_cache: bool = False,
              with_aux: bool = False):
    """x (B,S,d) -> (x, stacked cache or None, aux): with ``with_aux``
    aux is the mean of the layers' MoE auxiliary losses, a float32 0
    without MoE; else None, and no MoE layer computes it."""
    check_family(cfg)
    mixer, ffn = _kinds(cfg)
    caches = []
    aux = (torch.zeros((), dtype=torch.float32, device=x.device)
           if with_aux else None)
    for i in range(cfg.n_layers):
        x, cache, a = _layer_fwd(layer_params(params, i), x, cfg, mixer,
                                 ffn, with_aux)
        if a is not None:
            aux = aux + a
        if collect_cache:
            caches.append(cache)
    return (x, (stack_trees(caches) if collect_cache else None),
            aux / cfg.n_layers if with_aux else None)


def stack_decode(params, caches, x, pos, cfg: ArchConfig):
    """One token through every layer; ``caches`` is updated in place."""
    check_family(cfg)
    mixer, ffn = _kinds(cfg)
    for i in range(cfg.n_layers):
        x, _ = _layer_decode(layer_params(params, i), x,
                             layer_params(caches, i), pos, cfg, mixer, ffn)
    return x, caches
