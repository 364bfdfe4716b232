"""Plain PyTorch versions of prefill attention (causal / sliding window
/ GQA), copies of ``repro.kernels.flash_attention.ref``.

- ``attention_naive``: materialises the whole score matrix in the
  inputs' dtype (small-S ground truth for tests).
- ``attention_chunked``: query blocks of ``BLOCK_Q`` rows, each with
  float32 scores and softmax over all keys, the output cast to
  ``q.dtype``.  It is what the CUDA kernel is held against, and what
  the model stack computes for CPU tensors.
- ``attention_chunked_vjp``: its gradient (the backward of
  ``ops.FlashAttention`` on either device).

Masked scores are ``NEG_INF = -1e30`` (not ``-inf``), as in the
reference.  GQA repeats the KV heads: query head h reads KV head
h // (Hq / Hkv).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
# rows of one query block: bounds the (B, Hq, BLOCK_Q, S) float32 scores
# held at once; rows are independent, so it changes no value
BLOCK_Q = 512


def _expand_kv(k, hq):
    hkv = k.shape[1]
    if hq == hkv:
        return k
    return torch.repeat_interleave(k, hq // hkv, dim=1)


def _mask(qpos, kpos, causal, window):
    mask = torch.ones((qpos.shape[0], kpos.shape[1]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= (qpos - kpos) < window
    return mask


def attention_naive(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B,Hq,S,D), k/v (B,Hkv,Sk,D) -> (B,Hq,S,D)."""
    B, Hq, S, D = q.shape
    Sk = k.shape[2]
    k = _expand_kv(k, Hq)
    v = _expand_kv(v, Hq)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / (D ** 0.5)
    # align ends (decode-friendly)
    qpos = torch.arange(S, device=q.device)[:, None] + (Sk - S)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = _mask(qpos, kpos, causal, window)
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)


def attention_chunked(q, k, v, *, causal: bool = True, window: int = 0):
    """Flash-style chunked attention: one query block at a time, float32
    scores and softmax, output in ``q.dtype``."""
    B, Hq, S, D = q.shape
    kf = _expand_kv(k, Hq).float()
    vf = _expand_kv(v, Hq).float()
    bq = min(BLOCK_Q, S)
    kpos = torch.arange(kf.shape[2], device=q.device)[None, :]
    out = torch.empty_like(q)
    for start in range(0, S, bq):
        # the last block is padded to bq rows in the reference and sliced
        # back; rows are independent, so computing only the real ones
        # gives the same values
        qi = q[:, :, start:start + bq].float()
        qpos = start + torch.arange(qi.shape[2], device=q.device)[:, None]
        s = torch.einsum("bhqd,bhkd->bhqk", qi, kf) / (D ** 0.5)
        s = torch.where(_mask(qpos, kpos, causal, window)[None, None], s,
                        NEG_INF)
        p = torch.softmax(s, dim=-1)
        out[:, :, start:start + bq] = torch.einsum(
            "bhqk,bhkd->bhqd", p, vf).to(q.dtype)
    return out


def attention_chunked_vjp(q, k, v, do, *, causal: bool = True,
                          window: int = 0):
    """The gradient of :func:`attention_chunked` at (q, k, v) against
    the output's gradient ``do``: (dq, dk, dv) in the inputs' dtypes.

    One query block of ``BLOCK_Q`` rows at a time, its float32 scores
    and softmax recomputed under autograd: the transient is one block's
    (B, Hq, BLOCK_Q, Sk) scores, never the whole score matrix.  The
    blocks' dk and dv are summed in float32 over float32 copies of k
    and v, so GQA's sum over the query heads that share a KV head, the
    masks and the cast to ``q.dtype`` all follow from autograd.
    """
    B, Hq, S, D = q.shape
    bq = min(BLOCK_Q, S)
    dq = torch.empty_like(q)
    kf = k.detach().float().requires_grad_()
    vf = v.detach().float().requires_grad_()
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    kpos = torch.arange(k.shape[2], device=q.device)[None, :]
    for start in range(0, S, bq):
        with torch.enable_grad():
            qi = q[:, :, start:start + bq].detach().float().requires_grad_()
            qpos = start + torch.arange(qi.shape[2], device=q.device)[:, None]
            s = torch.einsum("bhqd,bhkd->bhqk", qi,
                             _expand_kv(kf, Hq)) / (D ** 0.5)
            s = torch.where(_mask(qpos, kpos, causal, window)[None, None], s,
                            NEG_INF)
            o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1),
                             _expand_kv(vf, Hq))
            gq, gk, gv = torch.autograd.grad(
                o, (qi, kf, vf), do[:, :, start:start + bq].float())
        dq[:, :, start:start + bq] = gq.to(q.dtype)
        dk += gk
        dv += gv
        del s, o
    return dq, dk.to(k.dtype), dv.to(v.dtype)
