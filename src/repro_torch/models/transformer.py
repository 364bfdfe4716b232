"""Decoder stacks of the dense, MoE, Mamba-2 (``ssm``), VLM and hybrid
(Jamba) families: a loop over layers whose parameters are stacked with
a leading layer dimension ``(L, ...)``, as in
``repro.models.transformer`` (where the loop is a ``lax.scan``).  A
dense (or VLM) layer is attention + gated MLP, a MoE layer attention +
the MoE FFN (``models/moe.py``); an SSM layer is a Mamba-2 mixer with
no FFN.  The hybrid stacks super-blocks of ``attn_every`` sublayers
``{"l0": ..., "l{P-1}": ...}`` (:func:`sb_layout`), each stacked over
the ``n_layers // attn_every`` super-blocks.  The encoder-decoder
family has its own stack (``models/encdec.py``).

Caches for serving are dicts of stacked tensors: ``k``/``v`` ``(L, B,
Hkv, S, D)`` for the dense, MoE and VLM families, ``ssm`` ``(L, B, H,
N, P)`` and ``conv`` ``(L, B, K-1, conv_dim)`` for the SSM family, and
for the hybrid one such dict per sublayer, ``{"l{i}": ...}``, with the
super-blocks as the leading dimension.

Under autograd with ``cfg.remat`` (every FULL config), each layer, or
each hybrid super-block, is recomputed in the backward
(``torch.utils.checkpoint``), where the reference wraps the same unit
in ``jax.checkpoint``.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
# parameter keys of one layer, of its mixer and of its FFN, by kind
LAYER_KEYS = {("attn", "mlp"): {"mixer", "norm1", "ffn", "norm2"},
              ("attn", "moe"): {"mixer", "norm1", "ffn", "norm2"},
              ("ssm", "mlp"): {"mixer", "norm1", "ffn", "norm2"},
              ("ssm", "moe"): {"mixer", "norm1", "ffn", "norm2"},
              ("ssm", ""): {"mixer", "norm1"}}
MIXER_KEYS = {"attn": {"wq", "wk", "wv", "wo"},
              "ssm": {"w_in", "conv_w", "A_log", "D", "dt_bias", "norm",
                      "w_out"}}
FFN_KEYS = {"mlp": {"w_up", "w_down", "w_gate"}, "moe": MOE.KEYS}


def check_family(cfg: ArchConfig) -> None:
    """Raise for a family the reference does not know."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; the "
                         f"families are {', '.join(FAMILIES)}")


def _kinds(cfg: ArchConfig) -> tuple[str, str]:
    """(mixer, ffn) kind of every layer of a homogeneous stack: ("ssm",
    "") for Mamba-2 (no FFN), ("attn", "moe") for the MoE family,
    ("attn", "mlp") for the dense and VLM families."""
    if cfg.family == "ssm":
        return "ssm", ""
    return "attn", ("moe" if cfg.is_moe else "mlp")


def sb_layout(cfg: ArchConfig) -> list[tuple[str, str]]:
    """(mixer, ffn) kind of each sublayer of a hybrid super-block:
    attention at ``attn_index`` and Mamba-2 elsewhere; the MoE FFN
    where ``i % moe_every == 1`` (with experts), else the MLP."""
    return [("attn" if i == cfg.attn_index else "ssm",
             "moe" if cfg.is_moe and i % cfg.moe_every == 1 else "mlp")
            for i in range(cfg.attn_every)]


def _check_layer_keys(cfg: ArchConfig, where: str, layer, mixer: str,
                      ffn: str) -> None:
    checks = [("layer", layer, LAYER_KEYS[(mixer, ffn)]),
              ("mixer", layer.get("mixer", {}), MIXER_KEYS[mixer])]
    if ffn:
        checks.append(("ffn", layer.get("ffn", {}), FFN_KEYS[ffn]))
    for what, got, want in checks:
        if set(got) != want:
            raise ValueError(f"{cfg.name}: {where}{what} params have keys "
                             f"{sorted(got)}, expected {sorted(want)}")


def check_stack_keys(cfg: ArchConfig, stack) -> None:
    """Raise unless the stacked layer params ``stack`` have the keys of
    the family's layers, mixers and FFNs (for the hybrid, of every
    sublayer ``l0 .. l{P-1}`` of the super-block)."""
    if cfg.family != "hybrid":
        _check_layer_keys(cfg, "", stack, *_kinds(cfg))
        return
    layout = sb_layout(cfg)
    want = {f"l{i}" for i in range(len(layout))}
    if set(stack) != want:
        raise ValueError(f"{cfg.name}: super-block params have keys "
                         f"{sorted(stack)}, expected {sorted(want)}")
    for i, (mixer, ffn) in enumerate(layout):
        _check_layer_keys(cfg, f"l{i} ", stack[f"l{i}"], mixer, ffn)


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
    """Layer params stacked over layers; for the hybrid (the
    reference's ``hybrid_init``) ``{"l{i}": sublayer i's params stacked
    over the super-blocks}``."""
    if cfg.family != "hybrid":
        mixer, ffn = _kinds(cfg)
        return stack_trees([layer_init(gen, cfg, mixer, ffn, dtype)
                            for _ in range(cfg.n_layers)])
    P = cfg.attn_every
    if cfg.n_layers % P:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of attn_every {P}")
    layout = sb_layout(cfg)
    return stack_trees([{f"l{i}": layer_init(gen, cfg, mixer, ffn, dtype)
                         for i, (mixer, ffn) in enumerate(layout)}
                        for _ in range(cfg.n_layers // P)])


def layer_params(params, i: int):
    """Layer ``i``'s slice of the stacked parameters."""
    if isinstance(params, dict):
        return {k: layer_params(v, i) for k, v in params.items()}
    return params[i]


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------
def _ffn(p, x, cfg: ArchConfig, ffn: str, with_aux: bool = False,
         ctx: L.Ctx = L.NO_CTX):
    """The layer's FFN on x: (out, MoE aux loss, or None without MoE or
    ``with_aux``)."""
    if ffn == "moe":
        return MOE.moe_fwd(p, x, top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor,
                           with_aux=with_aux, ctx=ctx)
    return L.mlp_fwd(p, x, ctx), None


def _layer_fwd(p, x, cfg: ArchConfig, mixer: str, ffn: str,
               with_aux: bool = False, ctx: L.Ctx = L.NO_CTX):
    """Full-sequence layer. Returns (x, cache, aux or None)."""
    h = L.rmsnorm(p["norm1"], x)
    if mixer == "attn":
        a, (k, v) = L.attention_fwd(p["mixer"], h, window=cfg.window,
                                    rope_theta=cfg.rope_theta, ctx=ctx)
        cache = {"k": k, "v": v}
    else:
        a, cache = SSM.ssm_fwd(p["mixer"], h, cfg, ctx)
    x = x + a
    aux = None
    if ffn:
        f, aux = _ffn(p["ffn"], L.rmsnorm(p["norm2"], x), cfg, ffn,
                      with_aux, ctx)
        x = x + f
    return x, cache, aux


def _layer_decode(p, x, cache, pos, cfg: ArchConfig, mixer: str, ffn: str,
                  ctx: L.Ctx = L.NO_CTX):
    h = L.rmsnorm(p["norm1"], x)
    if mixer == "attn":
        a, cache = L.attention_decode(p["mixer"], h, cache, pos,
                                      window=cfg.window,
                                      rope_theta=cfg.rope_theta, ctx=ctx)
    else:
        a, cache = SSM.ssm_decode(p["mixer"], h, cache, cfg, ctx)
    x = x + a
    if ffn:
        x = x + _ffn(p["ffn"], L.rmsnorm(p["norm2"], x), cfg, ffn,
                     ctx=ctx)[0]
    return x, cache


# ---------------------------------------------------------------------------
# stacks
# ---------------------------------------------------------------------------
def _walk(params, cfg: ArchConfig, caches=None):
    """Every layer in order as (cache key, params, cache slice or None,
    mixer, ffn): key None in a homogeneous stack, ``"l{i}"`` for
    sublayer i of a hybrid super-block (the reference's
    ``hybrid_fwd`` / ``hybrid_decode``).  Slices are views, so a decode
    writes into ``caches``."""
    if cfg.family != "hybrid":
        mixer, ffn = _kinds(cfg)
        for i in range(cfg.n_layers):
            yield (None, layer_params(params, i),
                   None if caches is None else layer_params(caches, i),
                   mixer, ffn)
        return
    layout = sb_layout(cfg)
    for sb in range(cfg.n_layers // cfg.attn_every):
        sbp = layer_params(params, sb)
        sbc = None if caches is None else layer_params(caches, sb)
        for i, (mixer, ffn) in enumerate(layout):
            key = f"l{i}"
            yield (key, sbp[key], None if sbc is None else sbc[key], mixer,
                   ffn)


def remat(fn, cfg: ArchConfig, *args):
    """``fn(*args)``, its activations recomputed in the backward (the
    reference's ``jax.checkpoint``) when ``cfg.remat`` is set and
    autograd records: serving under ``no_grad`` runs ``fn`` as it is."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _units(params, cfg: ArchConfig):
    """The stack's layers grouped as the reference's remat units: one
    layer of a homogeneous stack, one super-block of the hybrid."""
    layers = list(_walk(params, cfg))
    n = cfg.attn_every if cfg.family == "hybrid" else 1
    return [layers[i:i + n] for i in range(0, len(layers), n)]


def _unit_fwd(unit, x, aux, cfg: ArchConfig, ctx: L.Ctx = L.NO_CTX):
    """The layers of one unit in order -> (x, [(cache key, cache)],
    ``aux`` plus each MoE layer's aux loss; None stays None)."""
    caches = []
    for key, p, _, mixer, ffn in unit:
        x, cache, a = _layer_fwd(p, x, cfg, mixer, ffn, aux is not None,
                                 ctx)
        if a is not None:
            aux = aux + a
        caches.append((key, cache))
    return x, caches, aux


def stack_fwd(params, x, cfg: ArchConfig, collect_cache: bool = False,
              with_aux: bool = False, ctx: L.Ctx = L.NO_CTX):
    """x (B,S,d) -> (x, stacked cache or None, aux).  The cache is
    stacked over layers, or for the hybrid ``{"l{i}": sublayer i's cache
    stacked over super-blocks}``.  With ``with_aux`` aux is the sum of
    the MoE layers' auxiliary losses over ``n_layers`` (a float32 0
    without MoE); else None, and no MoE layer computes it.  Each layer
    (each hybrid super-block) is a :func:`remat` unit."""
    caches = {}
    aux = (torch.zeros((), dtype=torch.float32, device=x.device)
           if with_aux else None)
    for unit in _units(params, cfg):
        x, unit_caches, aux = remat(_unit_fwd, cfg, unit, x, aux, cfg, ctx)
        for key, cache in unit_caches if collect_cache else ():
            caches.setdefault(key, []).append(cache)
    if collect_cache:
        caches = {k: stack_trees(v) for k, v in caches.items()}
        if cfg.family != "hybrid":
            caches = caches[None]
    return (x, caches if collect_cache else None,
            aux / cfg.n_layers if with_aux else None)


def _split_layers(caches) -> list:
    """(dict, key) of every DTensor cache leaf whose layer dim is split:
    the rules place the Mamba-2 conv state by the k/v rule
    (``partition._CACHE_RULES``), its layers over the batch's axes, and
    a layer's slice of it is then no view to write into."""
    out = []
    for k, v in caches.items():
        if isinstance(v, dict):
            out += _split_layers(v)
        elif isinstance(v, DTensor) and Shard(0) in v.placements:
            out.append((caches, k))
    return out


def stack_decode(params, caches, x, pos, cfg: ArchConfig,
                 ctx: L.Ctx = L.NO_CTX):
    """One token through every layer; ``caches`` is updated in place (on
    a mesh, a leaf whose layer dim is split is gathered along it for the
    writes and put back in its own placements)."""
    split = [(d, k, d[k].placements) for d, k in _split_layers(caches)]
    for d, k, pls in split:
        d[k] = d[k].redistribute(d[k].device_mesh, tuple(
            Replicate() if p == Shard(0) else p for p in pls))
    for _, p, cache, mixer, ffn in _walk(params, cfg, caches):
        x, _ = _layer_decode(p, x, cache, pos, cfg, mixer, ffn, ctx)
    for d, k, pls in split:
        d[k] = d[k].redistribute(d[k].device_mesh, pls)
    return x, caches
