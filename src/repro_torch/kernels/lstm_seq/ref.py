"""Plain PyTorch version of the fused-sequence LSTM kernel."""
from __future__ import annotations

import torch


def lstm_seq_ref(xs, mask, wx, wh, b):
    """xs (T,B,F), mask (T,B) bool; wx (F,4H), wh (H,4H), b (4H,)
    -> hs (T,B,H).

    Zero initial carry, gates i, f, g, o.  A masked step keeps ``(h, c)``
    and emits the held ``h``; ``hs[t]`` is the post-mask hidden state.
    """
    T, B, _ = xs.shape
    H = wh.shape[0]
    h = xs.new_zeros((B, H))
    c = xs.new_zeros((B, H))
    out = []
    for t in range(T):
        gates = xs[t] @ wx + h @ wh + b
        i, f, g, o = torch.split(gates, H, dim=-1)
        c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h2 = torch.sigmoid(o) * torch.tanh(c2)
        m = mask[t][:, None]
        h = torch.where(m, h2, h)
        c = torch.where(m, c2, c)
        out.append(h)
    if not out:
        return xs.new_zeros((0, B, H))
    return torch.stack(out)
