"""AdamW and Adafactor as (init, update) transforms over the port's
parameter trees (nested dicts of tensors), a port of
``repro.optim.optimizers`` step for step:

- the gradients are clipped to a global norm taken in float32 over
  every leaf, each scaled in its own dtype;
- the bias corrections use ``t = step + 1``;
- moments are kept in ``moment_dtype`` (AdamW) or float32 (Adafactor);
- each update is computed in float32 and cast back to the parameter's
  dtype.

AdamW folds the decay into the step, ``p - lr * (m_hat / (sqrt(v_hat) +
eps) + wd * p)``, where ``torch.optim.AdamW`` scales ``p`` by ``1 - lr *
wd`` first, so the reference's arithmetic is written out here.
Adafactor (Shazeer & Stern 2018) factors the second moment of a leaf
whose last two dimensions are both at least ``min_dim`` (row and column
means), decays it by ``b2 = 1 - t^-0.8``, has no first moment and clips
the update by its RMS.

``update(grads, state, params, step, lr)`` takes the step as a host
int and ``lr`` as a float or a 0-d float32 tensor and returns
``(params, state, gnorm)``, ``gnorm`` a 0-d float32 tensor on the
parameters' device.  Each leaf's new values are written into the old
parameter and state tensors, which are returned: the reference's driver
donates both to its jitted step, and at full width a second copy of the
float32 moments would not fit beside the first.  A caller that needs
the pre-step values clones them first.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.tree import tree_leaves, tree_map

F32 = torch.float32
Params = Any


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in tree_leaves(tree)))


def _clip_scale(tree, max_norm: float):
    """(the factor each leaf is scaled by, the global norm)."""
    g = global_norm(tree)
    return torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0), g


def _scaled(x, scale):
    """One leaf of :func:`clip_by_norm`'s result, in float32."""
    return (x * scale.to(x.dtype)).to(F32)


def clip_by_norm(tree, max_norm: float):
    scale, g = _clip_scale(tree, max_norm)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), g


def _f32(x) -> float:
    """A host scalar rounded to float32, as the reference's ``jnp``
    scalars are."""
    return float(torch.as_tensor(x, dtype=F32))


def _pow(b: float, t: float) -> float:
    """``b ** t`` in float32 arithmetic."""
    return _f32(torch.as_tensor(b, dtype=F32) ** torch.as_tensor(
        t, dtype=F32))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], Any]
    update: Callable[..., tuple[Params, Any, torch.Tensor]]
    name: str = "opt"


def _unzip(out, n: int):
    """A tree of n-tuples -> n trees."""
    return tuple(tree_map(lambda o, i=i: o[i], out) for i in range(n))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw(*, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, moment_dtype=F32,
          clip: float = 1.0) -> Optimizer:
    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                  device=p.device)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    @torch.no_grad()
    def update(grads, state, params, step: int, lr):
        scale, gnorm = _clip_scale(grads, clip)
        t = _f32(step + 1.0)
        c1, c2 = _f32(1 - _pow(b1, t)), _f32(1 - _pow(b2, t))
        lr = _f32(lr)

        # the reference's expressions, one leaf at a time (the clip too)
        # and in place on fresh temporaries, so that a leaf holds at most
        # four float32 copies at once: at full width a whole clipped tree,
        # or a dozen copies of the embedding, would not fit
        def upd(g, m, v, p):
            g = _scaled(g, scale)
            m2 = b1 * m.to(F32)
            m2 += (1 - b1) * g                  # b1 m + (1 - b1) g
            v2 = b2 * v.to(F32)
            t = (1 - b2) * g
            t *= g
            v2 += t                             # b2 v + (1 - b2) g g
            del g, t
            den = v2 / c2
            den.sqrt_()
            den += eps
            step_ = m2 / c1
            step_ /= den                        # m_hat / (sqrt(v_hat) + eps)
            del den
            m.copy_(m2)
            v.copy_(v2)
            del m2, v2
            pf = p.to(F32)
            step_ += weight_decay * pf
            step_ *= lr
            step_.neg_()
            step_ += pf                         # p - lr * step
            return p.copy_(step_), m, v

        new_p, new_m, new_v = _unzip(tree_map(upd, grads, state["m"],
                                              state["v"], params), 3)
        return new_p, {"m": new_m, "v": new_v}, gnorm

    return Optimizer(init, update, "adamw")


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; no first moment)
# ---------------------------------------------------------------------------
def adafactor(*, eps: float = 1e-30, clip_rms: float = 1.0,
              weight_decay: float = 0.0, min_dim: int = 128,
              clip: float = 1.0) -> Optimizer:
    def factored(p) -> bool:
        return p.ndim >= 2 and p.shape[-1] >= min_dim and \
            p.shape[-2] >= min_dim

    def init(params):
        def one(p):
            z = lambda shape: torch.zeros(shape, dtype=F32, device=p.device)
            if factored(p):
                return {"v_row": z(p.shape[:-1]),
                        "v_col": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        return tree_map(one, params)

    @torch.no_grad()
    def update(grads, state, params, step: int, lr):
        scale, gnorm = _clip_scale(grads, clip)
        t = _f32(step + 1.0)
        b2 = _f32(1.0 - _pow(t, -0.8))
        lr = _f32(lr)

        def upd(g, p, s):
            g = _scaled(g, scale)
            g2 = g * g + eps
            if "v_row" in s:
                vr = b2 * s["v_row"] + (1 - b2) * g2.mean(dim=-1)
                vc = b2 * s["v_col"] + (1 - b2) * g2.mean(dim=-2)
                r = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
                u = g / (torch.sqrt(r)[..., None]
                         * torch.sqrt(vc)[..., None, :] + eps)
                ns = {"v_row": vr, "v_col": vc}
            else:
                v = b2 * s["v"] + (1 - b2) * g2
                u = g / (torch.sqrt(v) + eps)
                ns = {"v": v}
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms / clip_rms, min=1.0)
            p2 = p.to(F32) * _f32(1 - lr * weight_decay) - lr * u
            return p.copy_(p2), {k: s[k].copy_(x) for k, x in ns.items()}

        # the state mirrors the params with a dict at each leaf, so walk
        # the params and pick each leaf's state by the same path
        def walk(g, p, s):
            if isinstance(p, dict):
                out = {k: walk(g[k], p[k], s[k]) for k in p}
                return ({k: o[0] for k, o in out.items()},
                        {k: o[1] for k, o in out.items()})
            return upd(g, p, s)

        new_p, new_s = walk(grads, params, state)
        return new_p, new_s, gnorm

    return Optimizer(init, update, "adafactor")


def make_optimizer(name: str, *, moment_dtype: str = "float32",
                   clip: float = 1.0) -> Optimizer:
    md = torch.bfloat16 if moment_dtype == "bfloat16" else F32
    if name == "adafactor":
        return adafactor(clip=clip)
    return adamw(moment_dtype=md, clip=clip)
