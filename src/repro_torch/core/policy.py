"""RELMAS actor (paper Sec. 4.1, Fig. 2) as an ``nn.Module``.

Actor:  LSTM(hidden=h) -> FC(h -> h/2) + ReLU -> FC(h/2 -> G) + Tanh,
        applied recurrently over the deadline-sorted ready queue, one
        sub-job encoding (length F = 4 + 2M) per timestep, with a
        *primer* virtual SJ (per-SA busy times) prepended.  Output per
        SJ: [temporal priority, u_1 .. u_M]; argmax(u) = SA allocation.

The recurrence goes through ``kernels.lstm_seq.ops.lstm_seq``: the
hand-written CUDA kernel when the tensors are on the card, its plain
version on the CPU.  The two FC products stay ``torch.matmul``.

Parameters keep the JAX package's pytree layout, ``{"lstm": {wx (F,4H),
wh (H,4H), b (4H)}, "fc1": {w, b}, "fc2": {w, b}}`` with gates i, f, g,
o, so :func:`actor_params_from_numpy` carries a JAX actor across
unchanged.  The critic comes with the training slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels.lstm_seq import ops as lstm_ops


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    feat_dim: int          # F = 4 + 2M
    act_dim: int           # G = 1 + M
    hidden: int = 256      # paper default (Sec. 5: >=128 saturates)


def _dense_init(gen: torch.Generator, fan_in: int, fan_out: int):
    scale = float(np.sqrt(6.0 / (fan_in + fan_out)))
    w = torch.rand((fan_in, fan_out), generator=gen, dtype=torch.float32)
    return w * (2.0 * scale) - scale


class Actor(nn.Module):
    """Actor over ``(S, T, F)`` features and ``(S, T)`` masks.

    Weights are drawn on the CPU from a ``torch.Generator`` seeded 0
    (the same numbers on any device; not the JAX package's numbers,
    whose generator differs) and then moved to ``device``.
    """

    def __init__(self, cfg: PolicyConfig, *,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator().manual_seed(0)
        h, F, G = cfg.hidden, cfg.feat_dim, cfg.act_dim
        b = torch.zeros((4 * h,))
        b[h:2 * h] = 1.0          # forget-gate bias = 1
        p = lambda x: nn.Parameter(x.to(dev), requires_grad=False)
        self.lstm = nn.ParameterDict(dict(
            wx=p(_dense_init(gen, F, 4 * h)),
            wh=p(_dense_init(gen, h, 4 * h)), b=p(b)))
        self.fc1 = nn.ParameterDict(dict(
            w=p(_dense_init(gen, h, h // 2)), b=p(torch.zeros((h // 2,)))))
        self.fc2 = nn.ParameterDict(dict(
            w=p(_dense_init(gen, h // 2, G)), b=p(torch.zeros((G,)))))

    def forward(self, feats, mask):
        """feats (S, T, F) with the primer at t=0, mask (S, T) bool ->
        actions (S, T-1, G) in [-1, 1] (primer timestep dropped)."""
        xs = feats.transpose(0, 1).contiguous()        # (T, S, F)
        m = mask.transpose(0, 1).contiguous()
        hs = lstm_ops.lstm_seq(xs, m, self.lstm["wx"], self.lstm["wh"],
                               self.lstm["b"]).transpose(0, 1)
        z = torch.relu(hs @ self.fc1["w"] + self.fc1["b"])
        a = torch.tanh(z @ self.fc2["w"] + self.fc2["b"])
        return a[:, 1:]

    def load_numpy(self, tree) -> "Actor":
        """Copy a JAX-layout actor pytree of NumPy arrays in place.  All
        shapes are checked before anything is copied."""
        pairs = []
        for mod, name in ((self.lstm, "lstm"), (self.fc1, "fc1"),
                          (self.fc2, "fc2")):
            for k, param in mod.items():
                arr = np.asarray(tree[name][k], np.float32)
                if arr.shape != tuple(param.shape):
                    raise ValueError(f"['{name}']['{k}']: shape {arr.shape} "
                                     f"!= {tuple(param.shape)}")
                pairs.append((param, arr))
        for param, arr in pairs:
            param.data.copy_(torch.tensor(arr))
        return self


def actor_params_from_numpy(tree, *, device: str | torch.device = "cuda"
                            ) -> Actor:
    """Build an :class:`Actor` from the JAX actor pytree (NumPy arrays):
    ``{"lstm": {wx, wh, b}, "fc1": {w, b}, "fc2": {w, b}}``."""
    wx = np.asarray(tree["lstm"]["wx"])
    F, H4 = wx.shape
    cfg = PolicyConfig(feat_dim=F, act_dim=np.asarray(tree["fc2"]["b"]).shape[0],
                       hidden=H4 // 4)
    return Actor(cfg, device=device).load_numpy(tree)
