"""Plain PyTorch versions of one-token GQA decode attention, copies of
``repro.kernels.decode_gqa.ref``.

``decode_attention_ref`` is the grouped form: q is reshaped to
(B, Hkv, group, D) and contracted against the un-expanded cache, scores
and softmax in float32, and the probabilities rounded to the cache's
dtype before the product with V (``p.astype(v.dtype)`` in the
reference), with a float32 sum.  It is what the CUDA kernel is held
against and what the model stack computes for CPU tensors.
``decode_attention_naive`` repeats the KV heads and stays in float32
(small-shape ground truth for tests).

Positions ``>= length[b]`` are masked with ``NEG_INF = -1e30``.  At
``length[b] == 0`` every score is masked and the softmax returns the
mean of V; the model path never asks for that (its length is at least
1).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k, v, length):
    """q (B,Hq,1,D), k/v (B,Hkv,S,D), length (B,) -> (B,Hq,1,D)."""
    B, Hq, _, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qg = q[:, :, 0, :].reshape(B, Hkv, g, D).float()
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k.float()) / (D ** 0.5)
    mask = torch.arange(S, device=q.device)[None, :] < length[:, None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Hq, 1, D).to(q.dtype)


def decode_attention_naive(q, k, v, length):
    """Materialised-repeat variant in float32."""
    B, Hq, _, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if Hq != Hkv:
        k = torch.repeat_interleave(k, Hq // Hkv, dim=1)
        v = torch.repeat_interleave(v, Hq // Hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / (D ** 0.5)
    mask = torch.arange(S, device=q.device)[None, :] < length[:, None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
