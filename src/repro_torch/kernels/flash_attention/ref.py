"""Plain PyTorch versions of prefill attention (causal / sliding window
/ GQA), copies of ``repro.kernels.flash_attention.ref``.

- ``attention_naive``: materialises the whole score matrix in the
  inputs' dtype (small-S ground truth for tests).
- ``attention_chunked``: query blocks of ``BLOCK_Q`` rows, each with
  float32 scores and softmax over all keys, the output cast to
  ``q.dtype``.  It is what the CUDA kernel is held against, and what
  the model stack computes for CPU tensors.

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
