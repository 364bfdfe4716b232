"""Mamba-2 block (SSD), a port of ``repro.models.ssm``: prefill through
the chunked SSD forward, decode through the one-token state recurrence.

Mamba-2 parameterisation: fused input projection -> [z | xBC | dt],
causal depthwise conv over xBC, scalar A per head, gated RMSNorm,
output projection.  G = 1 (B/C shared across heads), head dim P, state
N = ``cfg.ssm_state``.  ``A_log``, ``D`` and ``dt_bias`` are float32
whatever the weights' dtype; the SSD itself runs in float32.

Prefill always goes through ``kernels.ssd_chunk.ssd_forward`` (its
intra-chunk term is the hand-written kernel on the card), which pads T
to the chunk; on a mesh of several ranks each rank runs it on its own
batch rows and heads (``kernels.head_shards.ssd_forward_shards``).  The
JAX block instead runs its plain ``ssd_chunked_ref`` and, when T is not
a multiple of the chunk, a smaller chunk that divides T
(``_pick_chunk``); both compute the same function.

:func:`ssm_decode` writes the new SSM and conv states into the state
tensors it is given, in place (views of the stacked cache), as the
dense decode writes its KV slot.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels import head_shards as HS
from repro_torch.kernels.ssd_chunk.ops import ssd_forward
from repro_torch.kernels.ssd_chunk.ref import ssd_decode_step
from repro_torch.models import sharding as shd
from repro_torch.models.layers import dense_init, rmsnorm, rmsnorm_init

# leaves kept in float32 whatever the weights' dtype
FLOAT32_KEYS = ("A_log", "D", "dt_bias")


def ssm_dims(d_model: int, expand: int, headdim: int, n_state: int):
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    conv_dim = d_inner + 2 * n_state
    return d_inner, n_heads, conv_dim


def ssm_init(gen, d_model, expand, headdim, n_state, conv_k, dtype):
    d_inner, H, conv_dim = ssm_dims(d_model, expand, headdim, n_state)
    in_dim = 2 * d_inner + 2 * n_state + H          # z | xBC | dt
    f32 = dict(dtype=torch.float32, device=gen.device)
    return {
        "w_in": dense_init(gen, (d_model, in_dim), dtype, d_model),
        "conv_w": dense_init(gen, (conv_k, conv_dim), dtype, conv_k),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "norm": rmsnorm_init(d_inner, dtype, gen.device),
        "w_out": dense_init(gen, (d_inner, d_model), dtype, d_inner),
    }


def _split(zxbcdt, d_inner, n_state, H):
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:d_inner * 2 + 2 * n_state]
    dt = zxbcdt[..., -H:]
    return z, xBC, dt


def _gathered(p, ctx):
    """``p`` with its projections whole over the FSDP axes
    (``layers.Ctx.weight``), as the dense layers read theirs."""
    if ctx is None:
        return p
    return {**p, "w_in": ctx.weight(p["w_in"]),
            "w_out": ctx.weight(p["w_out"])}


def _causal_dwconv(xBC, w, conv_state=None):
    """xBC (B,T,C), w (K,C) -> (y (B,T,C), new_state (B,K-1,C)).

    A K-term sum of shifted products in the input's dtype, in the
    reference's order (not ``F.conv1d``, which sums in another).  The
    new state is a copy: a view of the padded input would keep all of
    it alive in the prefill cache."""
    K, T = w.shape[0], xBC.shape[1]
    if conv_state is None:
        conv_state = shd.new_zeros(xBC, (xBC.shape[0], K - 1,
                                         xBC.shape[-1]))
    xp = torch.cat([conv_state, xBC], dim=1)
    y = xp[:, 0:T] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + T] * w[i]
    return F.silu(y), xp[:, T:].clone()


def _gate_out(p, y, xs, z, dtype, shape):
    """The skip term D*x, the SiLU(z) gate, the gated RMSNorm and the
    output projection: y (float32, heads split) -> (..., d_model)."""
    y = y + p["D"][:, None] * xs.float()
    y = y.reshape(shape).to(dtype) * F.silu(z)
    return rmsnorm(p["norm"], y) @ p["w_out"]


def ssm_fwd(p, x, cfg, ctx=None):
    """Prefill.  x (B,T,d) -> (y (B,T,d), state {"ssm" (B,H,N,P) float32,
    "conv" (B,K-1,conv_dim)} for decode).  ``ctx`` (``layers.Ctx``)
    constrains the heads and the output by the reference's names."""
    shard = ctx.shard if ctx is not None else (lambda t, logical: t)
    p = _gathered(p, ctx)
    B, T, d = x.shape
    N, P = cfg.ssm_state, cfg.ssm_headdim
    d_inner, H, _ = ssm_dims(d, cfg.ssm_expand, P, N)
    z, xBC, dt = _split(x @ p["w_in"], d_inner, N, H)
    xBC, conv_state = _causal_dwconv(xBC, p["conv_w"])
    xs = xBC[..., :d_inner].reshape(B, T, H, P)
    Bm = xBC[..., d_inner:d_inner + N]
    Cm = xBC[..., d_inner + N:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xs = shard(xs, ("batch", None, "model", None))
    ssd = HS.ssd_forward_shards if isinstance(xs, DTensor) else ssd_forward
    y, S = ssd(xs.float(), dt, A, Bm.float(), Cm.float(),
               chunk=cfg.ssd_chunk)
    out = _gate_out(p, y, xs, z, x.dtype, (B, T, d_inner))
    return shard(out, ("batch", None, None)), {"ssm": S.contiguous(),
                                               "conv": conv_state}


def ssm_init_state(B, d_model, cfg, dtype=torch.float32, device="cpu"):
    _, H, conv_dim = ssm_dims(d_model, cfg.ssm_expand, cfg.ssm_headdim,
                              cfg.ssm_state)
    return {
        "ssm": torch.zeros((B, H, cfg.ssm_state, cfg.ssm_headdim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((B, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
    }


def _write(dst, src) -> None:
    """``dst.copy_(src)``; into a DTensor ``dst`` (a view of the stacked
    cache) each rank writes its own block of ``src``, brought to
    ``dst``'s placements first."""
    if not isinstance(dst, DTensor):
        dst.copy_(src)
        return
    if tuple(src.placements) != tuple(dst.placements):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.to_local().copy_(src.to_local())


def ssm_decode(p, x, state, cfg, ctx=None):
    """One token.  x (B,1,d); ``state`` (from :func:`ssm_init_state`,
    :func:`ssm_fwd` or a layer of the cache) is updated in place.
    Returns (y (B,1,d), state)."""
    if ctx is not None:
        x = ctx.shard(x, (None, None, "dec_embed"))
    p = _gathered(p, ctx)
    B, _, d = x.shape
    N, P = cfg.ssm_state, cfg.ssm_headdim
    d_inner, H, _ = ssm_dims(d, cfg.ssm_expand, P, N)
    z, xBC, dt = _split(x @ p["w_in"], d_inner, N, H)
    xp = torch.cat([state["conv"], xBC], dim=1)             # (B,K,c)
    xBC = F.silu(torch.einsum("bkc,kc->bc", xp, p["conv_w"]))
    _write(state["conv"], xp[:, 1:])
    xs = xBC[:, :d_inner].reshape(B, H, P)
    Bm = xBC[:, d_inner:d_inner + N]
    Cm = xBC[:, d_inner + N:]
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    S, y = ssd_decode_step(state["ssm"], xs.float(), dt, A, Bm.float(),
                           Cm.float())
    _write(state["ssm"], S)
    return _gate_out(p, y, xs, z[:, 0], x.dtype, (B, d_inner))[:, None], \
        state
