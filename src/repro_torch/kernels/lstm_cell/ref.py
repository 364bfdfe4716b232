"""Plain PyTorch version of the fused LSTM cell kernel."""
from __future__ import annotations

import torch


def lstm_cell_ref(x, h, c, wx, wh, b):
    """x (B,F), h (B,H), c (B,H), wx (F,4H), wh (H,4H), b (4H,).

    Gate order: i, f, g, o (as ``repro_torch.core.policy``).  Computed in
    the inputs' type, as the JAX package's oracle.  Returns (h2, c2).
    """
    gates = x @ wx + h @ wh + b
    i, f, g, o = torch.split(gates, h.shape[-1], dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h2 = torch.sigmoid(o) * torch.tanh(c2)
    return h2, c2
