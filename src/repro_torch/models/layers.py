"""Model building blocks: RMSNorm, RoPE, GQA attention and Whisper's
cross-attention, gated (SiLU) and GELU MLPs, embeddings, sinusoidal
positions, and their initialisers.

A port of ``repro.models.layers``.  Every block takes a sharding
context :class:`Ctx` (the reference's ``ctx``) and constrains its
activations by the reference's logical names: on no mesh, or a mesh of
one rank, the constraints are the identity and tensors are plain; on a
mesh of several ranks parameters and activations are DTensors and the
attention runs on each rank's head shard
(``repro_torch.kernels.head_shards``).  Parameters are plain dicts of
tensors; the forward functions are pure except :func:`attention_decode`,
which writes the new key and value into the cache in place (one slot
per sequence; on a mesh, into the rank's block that owns the slot)
instead of returning a rewritten copy.  Compute dtype follows the input; norm and softmax
statistics are float32.  Attention goes through the hand-written
kernels' wrappers: their CUDA kernels for tensors on the card, their
plain versions for CPU tensors.

Initialisers take an explicit ``torch.Generator`` and draw on its
device; they match the JAX package's distributions, not its numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import head_shards as HS
from repro_torch.kernels.decode_gqa.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import sharding as shd


@dataclasses.dataclass(frozen=True)
class Ctx:
    """The sharding context: a mesh and its rules, either None."""
    mesh: Any = None
    rules: Any = None

    @property
    def active(self) -> bool:
        """Whether tensors are DTensors here (a mesh of several ranks)."""
        return shd.is_multi(self.mesh)

    def shard(self, x, logical):
        if not self.active:
            return x
        return shd.shard(x, logical, self.mesh, self.rules)

    def weight(self, w):
        """``w`` whole over the FSDP axes (the mesh axes ``fsdp`` maps
        to), its tensor-parallel split kept: the reference's partitioner
        gathers an FSDP weight before the layer uses it, and the backward
        reduce-scatters its gradient back to the weight's placements."""
        if not isinstance(w, DTensor):
            return w
        fsdp = set(self.rules.axes_for("fsdp"))
        pls = tuple(Replicate() if name in fsdp else p for name, p in
                    zip(shd.axis_sizes(self.mesh), w.placements))
        return w if pls == tuple(w.placements) else \
            w.redistribute(self.mesh, pls)


NO_CTX = Ctx()


def _attend(q, k, v, *, causal, window=0):
    if isinstance(q, DTensor):
        return HS.flash_attention_shards(q, k, v, causal=causal,
                                         window=window)
    return flash_attention(q, k, v, causal=causal, window=window)


def truncated_normal(gen, shape, scale, dtype):
    """N(0, 1) truncated to [-2, 2], times ``scale``, drawn in float32
    and cast to ``dtype``.  Under ``FakeTensorMode`` (the dry run's
    abstract init, the counterpart of ``jax.eval_shape(model.init)``)
    nothing is drawn: the tensor has a shape and a dtype, no data."""
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    if not is_fake(x):
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * scale).to(dtype)


def dense_init(gen, shape, dtype, fan_in=None):
    fan_in = fan_in if fan_in is not None else shape[0]
    return truncated_normal(gen, shape, fan_in ** -0.5, dtype)


# ---------------------------------------------------------------------------
def rmsnorm_init(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps=1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"]


# ---------------------------------------------------------------------------
def rope(x, positions, theta: float = 10000.0):
    """x (..., S, H, D) rotated at ``positions`` (..., S); float32
    arithmetic, the result cast back to ``x.dtype``."""
    D = x.shape[-1]
    half = D // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs              # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------
def attention_init(gen, d, n_heads, n_kv, head_dim, dtype):
    return {
        "wq": dense_init(gen, (d, n_heads, head_dim), dtype, d),
        "wk": dense_init(gen, (d, n_kv, head_dim), dtype, d),
        "wv": dense_init(gen, (d, n_kv, head_dim), dtype, d),
        "wo": dense_init(gen, (n_heads, head_dim, d), dtype,
                         n_heads * head_dim),
    }


def _proj(x, w):
    """x (..., d) @ w (d, H, Dh) -> (..., H, Dh)."""
    d, H, Dh = w.shape
    return (x @ w.reshape(d, H * Dh)).unflatten(-1, (H, Dh))


def _out_proj(o, w):
    """o (B, S, H, Dh) @ w (H, Dh, d) -> (B, S, d)."""
    H, Dh, d = w.shape
    return o.flatten(-2) @ w.reshape(H * Dh, d)


def attention_fwd(p, x, *, causal=True, window=0, rope_theta=10000.0,
                  use_rope=True, ctx: Ctx = NO_CTX):
    """Full-sequence attention (prefill) at positions 0..S-1, causal or
    not, with or without RoPE.  x (B,S,d) -> (out (B,S,d), (k, v) each
    (B,Hkv,S,D))."""
    S = x.shape[1]
    q, k, v = (_proj(x, ctx.weight(p[w])) for w in ("wq", "wk", "wv"))
    if use_rope:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None, :]
        q, k = rope(q, positions, rope_theta), rope(k, positions, rope_theta)
    q = ctx.shard(q.transpose(1, 2).contiguous(),
                  ("batch", "model", None, None))
    k = ctx.shard(k.transpose(1, 2).contiguous(),
                  ("batch", "cache_kv", None, None))
    v = ctx.shard(v.transpose(1, 2).contiguous(),
                  ("batch", "cache_kv", None, None))
    o = _attend(q, k, v, causal=causal, window=window)
    out = _out_proj(o.transpose(1, 2), ctx.weight(p["wo"]))
    return ctx.shard(out, ("batch", None, None)), (k, v)


def _write_slot(cache_x, new, slot):
    """``cache_x[b, :, slot[b]] = new[b]`` for every row b, in place.
    On a mesh each rank writes into its own block: the rows and kv heads
    it holds, where it holds the slot (the cache may be split along the
    sequence)."""
    if not isinstance(cache_x, DTensor):
        rows = torch.arange(cache_x.shape[0], device=cache_x.device)
        cache_x[rows, :, slot] = new.to(cache_x.dtype)
        return
    mesh, pls = cache_x.device_mesh, cache_x.placements
    B, _, S, _ = cache_x.shape
    new_pls = tuple(Replicate() if p == Shard(2) else p
                    for p in pls)
    if tuple(new.placements) != new_pls:        # the cache's rows and heads
        new = new.redistribute(mesh, new_pls)
    local, nl = cache_x.to_local(), new.to_local()
    b0 = shd.local_offset(0, B, pls, mesh)
    s0 = shd.local_offset(2, S, pls, mesh)
    Bl, _, Sl, _ = local.shape
    at = slot[b0:b0 + Bl] - s0
    own = (at >= 0) & (at < Sl)
    at = torch.clamp(at, 0, Sl - 1)
    rows = torch.arange(Bl, device=local.device)
    local[rows, :, at] = torch.where(own[:, None, None],
                                     nl.to(local.dtype), local[rows, :, at])


def attention_decode(p, x, cache, pos, *, window=0, rope_theta=10000.0,
                     use_rope=True, ctx: Ctx = NO_CTX):
    """One-token decode. x (B,1,d); cache dict(k, v (B,Hkv,Smax,D)),
    updated in place; pos (B,) int.  Returns (out (B,1,d), cache).

    With a sliding window the cache is a ring buffer of ``window`` slots
    (keys carry absolute-position RoPE before being written): the slot
    is ``pos % window``, clipped to ``Smax - 1``, and the attended
    length is ``min(pos + 1, Smax)``.
    """
    x = ctx.shard(x, (None, None, "dec_embed"))
    q, k, v = (_proj(x, ctx.weight(p[w])) for w in ("wq", "wk", "wv"))
    if use_rope:
        q = rope(q, pos[:, None], rope_theta)
        k = rope(k, pos[:, None], rope_theta)
    Smax = cache["k"].shape[2]
    slot = pos % max(window, 1) if window > 0 else pos
    slot = torch.clamp(slot, max=Smax - 1).long()
    _write_slot(cache["k"], k[:, 0], slot)
    _write_slot(cache["v"], v[:, 0], slot)
    length = torch.clamp(pos + 1, max=Smax).to(torch.int32)
    q = q.transpose(1, 2).contiguous()
    if isinstance(q, DTensor):
        q = ctx.shard(q, ("batch", "heads", None, None))
        o = HS.decode_attention_shards(q, cache["k"], cache["v"], length)
        o = ctx.shard(o, (None, "heads", None, None))
    else:
        o = decode_attention(q, cache["k"], cache["v"], length)
    out = _out_proj(o.transpose(1, 2), ctx.weight(p["wo"]))
    return out, cache


# ---------------------------------------------------------------------------
# Cross-attention (Whisper decoder): queries from the token stream, keys
# and values from the fixed encoder output.  No RoPE: positions enter as
# sinusoids added at the stack level.
# ---------------------------------------------------------------------------
def cross_kv(p, enc_out, ctx: Ctx = NO_CTX):
    """The cross-attention K/V of the encoder output (B,Se,d): each
    (B,Hkv,Se,D), contiguous."""
    k = _proj(enc_out, ctx.weight(p["wk"])).transpose(1, 2).contiguous()
    v = _proj(enc_out, ctx.weight(p["wv"])).transpose(1, 2).contiguous()
    return (ctx.shard(k, ("batch", "cache_kv", None, None)),
            ctx.shard(v, ("batch", "cache_kv", None, None)))


def cross_attention_fwd(p, x, enc_kv, ctx: Ctx = NO_CTX):
    """x (B,S,d) against enc_kv = (k, v) each (B,Hkv,Se,D), not causal:
    the prefill kernel with Sq = S and Sk = Se."""
    q = _proj(x, ctx.weight(p["wq"])).transpose(1, 2).contiguous()
    q = ctx.shard(q, ("batch", "model", None, None))
    k, v = enc_kv
    o = _attend(q, k, v, causal=False)
    return ctx.shard(_out_proj(o.transpose(1, 2), ctx.weight(p["wo"])),
                     ("batch", None, None))


def cross_attention_decode(p, x, cross_cache, ctx: Ctx = NO_CTX):
    """One token x (B,1,d) against the whole fixed encoder K/V cache; on
    a mesh each rank's q heads against its kv heads of the cache
    (``head_shards.decode_attention_shards``), as :func:`attention_decode`."""
    B = x.shape[0]
    q = _proj(x, ctx.weight(p["wq"])).transpose(1, 2).contiguous()
    k, v = cross_cache["k"], cross_cache["v"]
    length = torch.full((B,), k.shape[2], dtype=torch.int32, device=x.device)
    if isinstance(q, DTensor):
        q = ctx.shard(q, ("batch", "heads", None, None))
        o = HS.decode_attention_shards(q, k, v, length)
        o = ctx.shard(o, (None, "heads", None, None))
    else:
        o = decode_attention(q, k, v, length)
    return _out_proj(o.transpose(1, 2), ctx.weight(p["wo"]))


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------
def embedding_init(gen, vocab: int, d: int, dtype):
    return truncated_normal(gen, (vocab, d), d ** -0.5, dtype)


def embedding(table, tokens):
    """tokens (...) int -> (..., d) rows of ``table``.  A DTensor table
    (vocab rows split over the model axis, the d columns over the data
    axis) is gathered along d, as the reference's partitioner gathers a
    weight; each rank then looks its own tokens (the rows of a batch
    split over the data axis, all of a plain tensor) up in its vocab
    rows, zeros where it does not hold the row, and the output is the
    sum over the vocab's ranks (``Partial``), exact since one term is the
    row and the rest zeros.  The table's gradient from a rank's rows is
    its part of the sum over the data axis."""
    if not isinstance(table, DTensor):
        return table[tokens.long()]
    mesh = table.device_mesh
    pls = tuple(p if p == Shard(0) else Replicate()
                for p in table.placements)
    if pls != tuple(table.placements):
        table = table.redistribute(mesh, pls)
    rows = [Replicate()] * len(pls)
    if isinstance(tokens, DTensor):
        rows = [p if p == Shard(0) and v != Shard(0) else Replicate()
                for p, v in zip(tokens.placements, pls)]
        if tuple(rows) != tuple(tokens.placements):
            tokens = tokens.redistribute(mesh, rows)
        tok = tokens.to_local().long()
    else:
        tok = tokens.long()
    # a rank's rows give its part of the table's gradient
    local = table.to_local(grad_placements=tuple(
        Partial() if r == Shard(0) else v for r, v in zip(rows, pls)))
    v0 = shd.local_offset(0, table.shape[0], pls, mesh)
    at = tok - v0
    own = (at >= 0) & (at < local.shape[0])
    out = local[torch.clamp(at, 0, local.shape[0] - 1)] * own[..., None]
    return shd.from_local(
        out, mesh, tuple(Partial() if v == Shard(0) else r
                         for v, r in zip(pls, rows)),
        tuple(tokens.shape) + (table.shape[1],))


def sinusoid(pos, d: int):
    """Whisper's fixed position embedding of float positions ``pos``
    (...,) -> (..., d) float32: [sin | cos] of ``pos * freqs``, the
    frequencies ``exp(-log(10000) * i / max(d/2 - 1, 1))`` in float32
    throughout (the log taken of a float32 10000, as the reference)."""
    half = d // 2
    i = torch.arange(half, dtype=torch.float32, device=pos.device)
    # a factory op, not ``torch.tensor``: under the dry run's
    # FakeTensorMode a tensor made from data lands on the card
    freqs = torch.exp(-torch.log(torch.full((), 10000.0, device=pos.device))
                      * i / max(half - 1, 1))
    ang = pos[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_positions(S: int, d: int, device="cpu"):
    """Whisper-style sinusoidal position embeddings (S, d) of 0..S-1,
    float32."""
    return sinusoid(torch.arange(S, device=device), d)


# ---------------------------------------------------------------------------
# Gated MLP (SiLU) / GELU MLP
# ---------------------------------------------------------------------------
def mlp_init(gen, d, f, dtype, gated=True):
    p = {"w_up": dense_init(gen, (d, f), dtype),
         "w_down": dense_init(gen, (f, d), dtype, f)}
    if gated:
        p["w_gate"] = dense_init(gen, (d, f), dtype)
    return p


def mlp_fwd(p, x, ctx: Ctx = NO_CTX):
    """SiLU-gated where ``p`` has ``w_gate``, else GELU in its tanh form
    (``jax.nn.gelu``'s default, not torch's exact erf)."""
    x = ctx.shard(x, (None,) * (x.ndim - 1) + ("dec_embed",))
    h = x @ ctx.weight(p["w_up"])
    if "w_gate" in p:
        h = F.silu(x @ ctx.weight(p["w_gate"])) * h
    else:
        h = F.gelu(h, approximate="tanh")
    h = ctx.shard(h, ("batch", None, "model"))
    return ctx.shard(h @ ctx.weight(p["w_down"]), ("batch", None, None))
