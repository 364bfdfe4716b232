"""Plain PyTorch versions of one-token GQA decode attention, copies of
``repro.kernels.decode_gqa.ref``.

``decode_attention_ref`` is the grouped form: q is reshaped to
(B, Hkv, group, D) and contracted against the un-expanded cache, scores
and softmax in float32, and the probabilities rounded to the cache's
dtype before the product with V (``p.astype(v.dtype)`` in the
reference), with a float32 sum.  It is what the CUDA kernel is held
against and what the model stack computes for CPU tensors.
``decode_attention_naive`` repeats the KV heads and stays in float32
(small-shape ground truth for tests).  ``decode_attention_split_ref``
does the kernel's own arithmetic: the cache cut into runs of ``rows``
positions, a float32 softmax state (m, l, acc) per run with p kept in
float32, and the log-sum-exp merge of the runs; it is a test oracle of
that arithmetic and on no main path.

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


def decode_attention_split_ref(q, k, v, length, rows):
    """The kernel's split-and-merge in plain PyTorch: q (B,Hq,1,D),
    k/v (B,Hkv,S,D), length (B,), runs of ``rows`` cache positions ->
    (B,Hq,1,D).  Runs that start at or past ``length[b]`` take no part;
    at ``length[b] == 0`` the row is zeros, as in the kernel."""
    B, Hq, _, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qg = q[:, :, 0, :].reshape(B, Hkv, g, D).float()
    length = length.to(q.device).long()
    pos = torch.arange(S, device=q.device)
    ms, ls, accs = [], [], []
    for s0 in range(0, max(S, 1), rows):
        kk, vv = k[:, :, s0:s0 + rows].float(), v[:, :, s0:s0 + rows].float()
        s = torch.einsum("bhgd,bhkd->bhgk", qg, kk) / (D ** 0.5)
        valid = (pos[s0:s0 + rows][None, :] < length[:, None])[:, None, None]
        s = torch.where(valid, s, NEG_INF)
        m = s.amax(dim=-1)                                  # (B,Hkv,g)
        p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
        ms.append(torch.where(valid.any(-1), m, NEG_INF))   # empty run
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhgk,bhkd->bhgd", p, vv))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    f = torch.exp(m - m.amax(dim=0, keepdim=True))
    num = (acc * f[..., None]).sum(0)
    den = (l * f).sum(0).clamp_min(1e-30)
    return (num / den[..., None]).reshape(B, Hq, 1, D).to(q.dtype)
