"""RELMAS actor / critic networks (paper Sec. 4.1, Fig. 2).

Actor:  LSTM(hidden=h) -> FC(h -> h/2) + ReLU -> FC(h/2 -> G) + Tanh,
        applied recurrently over the deadline-sorted ready queue, one
        sub-job encoding (length F = 4 + 2M) per timestep, with a
        *primer* virtual SJ (per-SA busy times) prepended.  Output per
        SJ: [temporal priority, u_1 .. u_M]; argmax(u) = SA allocation.

Critic: same architecture, input per timestep = concat(state, action)
        (length F + G), projecting one Q value per timestep from the
        hidden state; the Q of the pair is the last valid timestep's.

Parameters keep the JAX package's pytree layout, ``{"lstm": {wx (F,4H),
wh (H,4H), b (4H)}, "fc1": {w, b}, "fc2": {w, b}}`` with gates i, f, g,
o, as plain dicts of tensors (training) or inside :class:`Actor` /
:class:`Critic` modules.  The JAX package ``vmap``s its apply functions
over a batch; here every input carries an explicit leading batch axis.

The recurrence has two routes, picked by ``PolicyConfig.use_pallas``
(the JAX package's field name; "pallas" there is the whole-sequence
kernel):

- ``use_pallas=True``: the whole T-step recurrence in one launch of the
  hand-written ``lstm_seq`` kernel (no backward).  :class:`Actor`, the
  serving actor, always takes this route;
- ``use_pallas=False`` (the default, and what training runs, as in the
  JAX package): the step-by-step recurrence, one launch of the
  hand-written ``lstm_cell`` kernel per timestep, differentiable.

``compute_dtype="bfloat16"`` changes the step route only, as in the JAX
package: each step's two gate products take bf16 inputs, their sum is
cast to float32 before the bias, and the carry stays float32.  Those
are PyTorch operations (the reference leaves them to XLA, outside any
Pallas kernel); the ``lstm_cell`` kernel stores c in its input type, so
it is not that function.  The sequence route ignores the field.

On CPU tensors both routes take their kernels' plain versions.  The two
FC products stay ``torch.matmul``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels.lstm_cell import ops as cell_ops
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref  # noqa: F401
from repro_torch.kernels.lstm_seq import ops as lstm_ops

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    feat_dim: int          # F = 4 + 2M
    act_dim: int           # G = 1 + M
    hidden: int = 256      # paper default (Sec. 5: >=128 saturates)
    # True: whole-sequence lstm_seq kernel; False: lstm_cell per step
    use_pallas: bool = False
    # compute dtype of the step route's gate products (params, bias and
    # carry stay float32): "float32" or "bfloat16"
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")

    @property
    def critic_in(self) -> int:
        return self.feat_dim + self.act_dim


def _dense_init(gen: torch.Generator, fan_in: int, fan_out: int):
    scale = float(np.sqrt(6.0 / (fan_in + fan_out)))
    w = torch.rand((fan_in, fan_out), generator=gen, dtype=torch.float32)
    return w * (2.0 * scale) - scale


def _net_init(gen: torch.Generator, in_dim: int, hidden: int,
              out_dim: int, device) -> Params:
    """LSTM + two FC layers, drawn on the CPU from ``gen`` (the same
    numbers on any device; not the JAX package's numbers, whose
    generator differs), then moved to ``device``."""
    h = hidden
    b = torch.zeros((4 * h,))
    b[h:2 * h] = 1.0          # forget-gate bias = 1
    tree = {"lstm": {"wx": _dense_init(gen, in_dim, 4 * h),
                     "wh": _dense_init(gen, h, 4 * h), "b": b},
            "fc1": {"w": _dense_init(gen, h, h // 2),
                    "b": torch.zeros((h // 2,))},
            "fc2": {"w": _dense_init(gen, h // 2, out_dim),
                    "b": torch.zeros((out_dim,))}}
    dev = resolve_device(device)
    return {k: {n: t.to(dev) for n, t in v.items()} for k, v in tree.items()}


def init_actor(gen: torch.Generator, cfg: PolicyConfig,
               device: str | torch.device = "cuda") -> Params:
    return _net_init(gen, cfg.feat_dim, cfg.hidden, cfg.act_dim, device)


def init_critic(gen: torch.Generator, cfg: PolicyConfig,
                device: str | torch.device = "cuda") -> Params:
    return _net_init(gen, cfg.critic_in, cfg.hidden, 1, device)


def _bf16_cell(x, h, c, wx, wh, b):
    """One step with bf16 gate products: ``(x.bf16 @ wx + h.bf16 @ wh)``
    summed in bf16, then float32 before the bias; float32 carry."""
    bf16 = torch.bfloat16
    gates = (x.to(bf16) @ wx + h.to(bf16) @ wh).float() + b
    i, f, g, o = torch.split(gates, h.shape[-1], dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c2), c2


def _lstm_scan(p: Params, xs, mask, hidden: int, use_pallas: bool = False,
               compute_dtype: str = "float32"):
    """xs (T, B, in), mask (T, B) bool -> hidden states (T, B, hidden).

    Zero initial carry; a masked step leaves the carry untouched and
    emits the held h.  ``use_pallas`` picks the whole-sequence kernel
    (whatever ``compute_dtype`` says), else the step recurrence through
    the ``lstm_cell`` kernel in float32 or :func:`_bf16_cell` in
    bfloat16, with the masked carry ``where(m, h2, h)`` outside the cell.
    """
    if use_pallas:
        return lstm_ops.lstm_seq(xs, mask, p["wx"], p["wh"], p["b"])
    if compute_dtype == "bfloat16":
        wx, wh = p["wx"].to(torch.bfloat16), p["wh"].to(torch.bfloat16)
        cell = lambda x, h, c: _bf16_cell(x, h, c, wx, wh, p["b"])
    else:
        cell = lambda x, h, c: cell_ops.lstm_cell(x, h, c, p["wx"], p["wh"],
                                                  p["b"])
    T, B, _ = xs.shape
    h = xs.new_zeros((B, hidden))
    c = xs.new_zeros((B, hidden))
    out = []
    for t in range(T):
        h2, c2 = cell(xs[t], h, c)
        m = mask[t][:, None]
        h = torch.where(m, h2, h)
        c = torch.where(m, c2, c)
        out.append(h)
    return torch.stack(out) if out else xs.new_zeros((0, B, hidden))


def _heads(params: Params, hs):
    z = torch.relu(hs @ params["fc1"]["w"] + params["fc1"]["b"])
    return z @ params["fc2"]["w"] + params["fc2"]["b"]


def _scan_batch(params: Params, cfg: PolicyConfig, xs, mask):
    """Batch-first (B, T, in) -> (B, T, hidden) through :func:`_lstm_scan`."""
    hs = _lstm_scan(params["lstm"], xs.transpose(0, 1).contiguous(),
                    mask.transpose(0, 1).contiguous(), cfg.hidden,
                    cfg.use_pallas, cfg.compute_dtype)
    return hs.transpose(0, 1)


def actor_apply(params: Params, cfg: PolicyConfig, feats, mask):
    """feats (B, T, F) with the primer at t=0, mask (B, T) bool ->
    actions (B, T-1, G) in [-1, 1] (primer timestep discarded)."""
    return torch.tanh(_heads(params, _scan_batch(params, cfg, feats,
                                                 mask)))[:, 1:]


def critic_apply(params: Params, cfg: PolicyConfig, feats, actions, mask):
    """feats (B, T, F); actions (B, T-1, G) (zero primer row prepended);
    mask (B, T) -> Q (B,), the projection at each row's last valid
    timestep (timestep 0 for an empty row)."""
    B, _, G = actions.shape
    act_full = torch.cat([actions.new_zeros((B, 1, G)), actions], dim=1)
    xs = torch.cat([feats, act_full], dim=-1)
    q = _heads(params, _scan_batch(params, cfg, xs, mask))[..., 0]   # (B, T)
    last = torch.clamp(mask.sum(1) - 1, min=0)
    return q.gather(1, last[:, None])[:, 0]


def actor_macs_per_timestep(cfg: PolicyConfig) -> int:
    """MAC count of one policy timestep (paper Sec. 5.3 overhead metric).

    For h=256, F=16, G=7 (M=6 SAs) this gives 316,288 + small FC terms,
    the paper's 316,288 MACs/layer for the LSTM+projections.
    """
    h = cfg.hidden
    lstm = (cfg.feat_dim + h) * 4 * h
    fc = h * (h // 2) + (h // 2) * cfg.act_dim
    return lstm + fc


def net_shapes(in_dim: int, hidden: int, out_dim: int) -> dict:
    h = hidden
    return {"lstm": {"wx": (in_dim, 4 * h), "wh": (h, 4 * h), "b": (4 * h,)},
            "fc1": {"w": (h, h // 2), "b": (h // 2,)},
            "fc2": {"w": (h // 2, out_dim), "b": (out_dim,)}}


def checked_numpy(tree, shapes: dict, where: str = "") -> dict:
    """NumPy float32 copies of ``tree``'s leaves, each checked against
    ``shapes`` (nested like the tree) before anything is returned."""
    out = {}
    for k, want in shapes.items():
        if isinstance(want, dict):
            out[k] = checked_numpy(tree[k], want, f"{where}['{k}']")
            continue
        arr = np.array(tree[k], np.float32)
        if arr.shape != want:
            raise ValueError(f"{where}['{k}']: shape {arr.shape} != {want}")
        out[k] = arr
    return out


def tree_to_device(tree, device) -> Params:
    if isinstance(tree, dict):
        return {k: tree_to_device(v, device) for k, v in tree.items()}
    return torch.tensor(tree, device=device)


class _Net(nn.Module):
    """Parameters in the pytree layout, frozen (inference modules)."""

    def __init__(self, cfg: PolicyConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        p = lambda x: nn.Parameter(x, requires_grad=False)
        for name in ("lstm", "fc1", "fc2"):
            setattr(self, name, nn.ParameterDict(
                {k: p(v) for k, v in params[name].items()}))

    def params(self) -> Params:
        return {name: dict(getattr(self, name).items())
                for name in ("lstm", "fc1", "fc2")}

    def load_numpy(self, tree):
        """Copy a JAX-layout pytree of NumPy arrays in place.  All shapes
        are checked before anything is copied."""
        shapes = {name: {k: tuple(v.shape) for k, v in mod.items()}
                  for name, mod in self.params().items()}
        arrays = checked_numpy(tree, shapes)
        for name, mod in self.params().items():
            for k, param in mod.items():
                param.data.copy_(torch.as_tensor(arrays[name][k]))
        return self


class Actor(_Net):
    """The serving actor over ``(S, T, F)`` features and ``(S, T)``
    masks.  It always runs the whole-sequence ``lstm_seq`` route, one
    launch per call, whatever ``cfg.use_pallas`` says.

    Weights are drawn on the CPU from a ``torch.Generator`` seeded 0
    (:func:`init_actor`), then moved to ``device``.
    """

    def __init__(self, cfg: PolicyConfig, *,
                 device: str | torch.device = "cuda"):
        super().__init__(cfg, init_actor(torch.Generator().manual_seed(0),
                                         cfg, device))
        self._seq_cfg = dataclasses.replace(cfg, use_pallas=True)

    def forward(self, feats, mask):
        """feats (S, T, F) with the primer at t=0, mask (S, T) bool ->
        actions (S, T-1, G) in [-1, 1] (primer timestep dropped)."""
        return actor_apply(self.params(), self._seq_cfg, feats, mask)


class Critic(_Net):
    """The critic as a module, beside :class:`Actor`: forward =
    :func:`critic_apply` with ``cfg``'s route."""

    def __init__(self, cfg: PolicyConfig, *,
                 device: str | torch.device = "cuda"):
        super().__init__(cfg, init_critic(torch.Generator().manual_seed(1),
                                          cfg, device))

    def forward(self, feats, actions, mask):
        return critic_apply(self.params(), self.cfg, feats, actions, mask)


def _actor_cfg(tree) -> PolicyConfig:
    F, h4 = np.shape(tree["lstm"]["wx"])
    return PolicyConfig(feat_dim=F, act_dim=np.shape(tree["fc2"]["b"])[0],
                        hidden=h4 // 4)


def actor_params_from_numpy(tree, cfg: PolicyConfig | None = None, *,
                            device: str | torch.device = "cuda") -> Actor:
    """Build an :class:`Actor` from the JAX actor pytree (NumPy arrays):
    ``{"lstm": {wx, wh, b}, "fc1": {w, b}, "fc2": {w, b}}``.  ``cfg``
    defaults to the shapes of ``wx`` and ``fc2.b``; every leaf is
    checked against it before anything is copied."""
    cfg = cfg or _actor_cfg(tree)
    arrays = checked_numpy(tree, net_shapes(cfg.feat_dim, cfg.hidden,
                                        cfg.act_dim))
    return Actor(cfg, device=device).load_numpy(arrays)


def critic_params_from_numpy(tree, cfg: PolicyConfig, *,
                             device: str | torch.device = "cuda") -> Params:
    """The JAX critic pytree (NumPy arrays) as a params dict of tensors
    on ``device``, every shape checked against ``cfg`` first."""
    arrays = checked_numpy(tree, net_shapes(cfg.critic_in, cfg.hidden, 1))
    return tree_to_device(arrays, resolve_device(device))
