"""DDPG learner adapted to the RELMAS problem (paper Sec. 4.2).

Standard Lillicrap-style DDPG (actor/critic + target twins, soft
updates, replay) with the paper's adaptations:

- both function approximators are the LSTM sequence nets of
  :mod:`repro_torch.core.policy` (state = variable-length ready queue),
  whose recurrence runs the hand-written ``lstm_cell`` kernel step by
  step, forward and (through its ``autograd.Function``) backward;
- the stored next state encodes the *residual* RQ only;
- actions are the full continuous (R, G) tanh outputs; exploration is
  additive clipped Gaussian noise.

The counterpart of the JAX package's ``core/ddpg.py``.  Over several
devices each replica runs :func:`ddpg_update_rounds` unchanged on the
batch gathered from every device's ring (its ``comm`` mode), or, in the
local-sample topology, each shard's gradients are averaged
(:func:`ddpg_update_shards`).
Parameters are the pytree layout as dicts of tensors; the learner state
is a dataclass whose seven fields flatten in the JAX ``DDPGState``'s
order, so checkpoints cross between the packages.  The optimizer is the
reference's own Adam, ported literally (:func:`_adam_step`): one
global-norm clip over the whole tree, bias correction at ``step + 1``.
``torch.optim.Adam`` and ``clip_grad_norm_`` are not used: their clip
epsilon differs.  The step counter is a host int.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import policy as P
from repro_torch.core.replay import (replay_sample, replay_sample_global,
                                     sample_indices)
from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves, tree_map

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    policy: P.PolicyConfig
    gamma: float = 0.99          # RL discount (unstated in paper; standard)
    tau: float = 0.005           # target soft-update rate
    actor_lr: float = 1e-4
    critic_lr: float = 1e-3
    noise_sigma: float = 0.2
    reward_scale: float = 0.1
    grad_clip: float = 10.0


@dataclasses.dataclass
class DDPGState:
    actor: Params
    critic: Params
    target_actor: Params
    target_critic: Params
    actor_opt: Params            # adam moments {"m": tree, "v": tree}
    critic_opt: Params
    step: int


def _unflatten_like(tree, leaves):
    it = iter(leaves)

    def take(node):
        if isinstance(node, dict):
            return {k: take(node[k]) for k in sorted(node)}
        return next(it)
    return take(tree)


def _adam_init(params: Params) -> Params:
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params)}


@torch.no_grad()
def _adam_step(params, grads, opt, lr: float, step: int, clip: float):
    """The reference's Adam (ddpg.py:71-83): clip the whole tree to
    global norm ``clip`` (``max(gnorm, 1e-9)``), then Adam with bias
    correction at ``t = step + 1``.  Returns ``(new_params, new_opt)``;
    nothing is updated in place."""
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in tree_leaves(grads)))
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    grads = tree_map(lambda g: g * scale, grads)
    b1, b2, eps = 0.9, 0.999, 1e-8
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, opt["m"], grads)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, opt["v"], grads)
    t = np.float32(step + 1)
    c1 = float(np.float32(1) - np.float32(b1) ** t)
    c2 = float(np.float32(1) - np.float32(b2) ** t)
    new = tree_map(lambda p, m_, v_: p - lr * (m_ / c1)
                   / (torch.sqrt(v_ / c2) + eps), params, m, v)
    return new, {"m": m, "v": v}


def init_ddpg(gen: torch.Generator, cfg: DDPGConfig,
              device: str | torch.device = "cuda") -> DDPGState:
    """Actor then critic drawn from ``gen`` (CPU), targets as copies,
    zero Adam moments, step 0."""
    actor = P.init_actor(gen, cfg.policy, device)
    critic = P.init_critic(gen, cfg.policy, device)
    return DDPGState(
        actor=actor, critic=critic,
        target_actor=tree_map(torch.clone, actor),
        target_critic=tree_map(torch.clone, critic),
        actor_opt=_adam_init(actor), critic_opt=_adam_init(critic), step=0)


def _field(tree, i: int, name: str):
    if isinstance(tree, dict):
        return tree[name] if name in tree else tree[i]
    return getattr(tree, name)


def ddpg_state_from_numpy(tree, cfg: DDPGConfig, *,
                          device: str | torch.device = "cuda") -> DDPGState:
    """A full JAX ``DDPGState`` as NumPy leaves -> a :class:`DDPGState`
    on ``device``.  ``tree`` is the JAX state after ``tree_map(np.asarray,
    ...)`` (fields by attribute), a dict by field name, or what
    :func:`repro_torch.ckpt.restore_checkpoint` returns without ``like``
    (fields by flat index 0-6).  Every shape is checked before anything
    is copied."""
    pc = cfg.policy
    a_shapes = P.net_shapes(pc.feat_dim, pc.hidden, pc.act_dim)
    c_shapes = P.net_shapes(pc.critic_in, pc.hidden, 1)
    shapes = dict(actor=a_shapes, critic=c_shapes, target_actor=a_shapes,
                  target_critic=c_shapes,
                  actor_opt={"m": a_shapes, "v": a_shapes},
                  critic_opt={"m": c_shapes, "v": c_shapes})
    arrays = {name: P.checked_numpy(_field(tree, i, name), want,
                                    f"[<flat index {i}>]")
              for i, (name, want) in enumerate(shapes.items())}
    step = np.asarray(_field(tree, 6, "step"))
    if step.shape != ():
        raise ValueError(f"[<flat index 6>]: step has shape {step.shape}")
    dev = resolve_device(device)
    return DDPGState(**{k: P.tree_to_device(v, dev)
                        for k, v in arrays.items()}, step=int(step))


def act(params: Params, cfg: P.PolicyConfig, feats, mask,
        gen: torch.Generator | None = None, sigma: float = 0.0):
    """feats (B,T,F), mask (B,T) -> (a (B,T-1,G), prio (B,T-1),
    sa (B,T-1)); with ``gen`` and ``sigma > 0`` the actions get clipped
    Gaussian noise drawn from ``gen``."""
    with torch.no_grad():
        a = P.actor_apply(params, cfg, feats, mask)
        if gen is not None and sigma > 0:
            noise = torch.randn(a.shape, generator=gen, device=a.device)
            a = torch.clamp(a + sigma * noise, -1.0, 1.0)
    return a, a[..., 0], torch.argmax(a[..., 1:], dim=-1)


def _grads(loss_fn, params: Params):
    """(loss, aux), d loss / d params as a tree like ``params``."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, aux = loss_fn(_unflatten_like(params, leaves))
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), aux, _unflatten_like(params, grads)


def ddpg_update(state: DDPGState, cfg: DDPGConfig,
                batch: dict) -> tuple[DDPGState, dict]:
    """One DDPG update from a replay batch.

    batch: s (B,T,F), mask (B,T), a (B,T-1,G), r (B,), s2 (B,T,F),
    mask2 (B,T), and an optional ``act_mask`` (B, G) that masks the
    action channels of the *regenerated* actions (the target actor's a2
    and the actor loss's a) as the behaviour policy masked the stored
    ones.  The target passes run under ``no_grad``; the critic loss and
    the actor loss backpropagate through the recurrence.  Returns the
    new state (fresh tensors; ``state`` is left as it was) and the info
    dict ``critic_loss``, ``actor_loss``, ``q_mean``, ``target_mean``.
    """
    return ddpg_update_shards(state, cfg, [batch], lambda xs: xs[0])


def ddpg_update_shards(state: DDPGState, cfg: DDPGConfig, batches: list,
                       mean) -> tuple[DDPGState, dict]:
    """:func:`ddpg_update` with the batch in shards (the reference's
    ``axis_name`` mode): each shard's critic gradients, actor gradients
    and info are averaged over the shards by ``mean`` (a list of
    tensors, one a shard, -> their mean) before the Adam steps, so
    every replica takes the same step.  Equal shards make the mean of
    the shards' means the global batch's mean."""
    pc = cfg.policy

    def remask(batch):
        am = batch.get("act_mask")
        return ((lambda a: a * am[:, None, :]) if am is not None
                else (lambda a: a))

    def mean_tree(trees):
        return tree_map(lambda *xs: mean(list(xs)), *trees)

    ys = []
    with torch.no_grad():
        for batch in batches:
            r = batch["r"] * cfg.reward_scale
            a2 = remask(batch)(P.actor_apply(state.target_actor, pc,
                                             batch["s2"], batch["mask2"]))
            q2 = P.critic_apply(state.target_critic, pc, batch["s2"], a2,
                                batch["mask2"])
            ys.append(r + cfg.gamma * q2)

    crit = []
    for batch, y in zip(batches, ys):
        def critic_loss(cp, batch=batch, y=y):
            q = P.critic_apply(cp, pc, batch["s"], batch["a"], batch["mask"])
            return torch.mean((q - y) ** 2), q.detach()
        crit.append(_grads(critic_loss, state.critic))
    new_critic, new_copt = _adam_step(
        state.critic, mean_tree([c[2] for c in crit]), state.critic_opt,
        cfg.critic_lr, state.step, cfg.grad_clip)

    act = []
    for batch in batches:
        def actor_loss(ap, batch=batch):
            a = remask(batch)(P.actor_apply(ap, pc, batch["s"],
                                            batch["mask"]))
            return -torch.mean(P.critic_apply(new_critic, pc, batch["s"], a,
                                              batch["mask"])), None
        act.append(_grads(actor_loss, state.actor))
    new_actor, new_aopt = _adam_step(
        state.actor, mean_tree([a[2] for a in act]), state.actor_opt,
        cfg.actor_lr, state.step, cfg.grad_clip)
    tau = cfg.tau
    with torch.no_grad():
        soft = lambda tgt, new: tree_map(
            lambda t_, n: (1 - tau) * t_ + tau * n, tgt, new)
        new_state = DDPGState(
            actor=new_actor, critic=new_critic,
            target_actor=soft(state.target_actor, new_actor),
            target_critic=soft(state.target_critic, new_critic),
            actor_opt=new_aopt, critic_opt=new_copt, step=state.step + 1)
    info = {"critic_loss": mean([c[0] for c in crit]),
            "actor_loss": mean([a[0] for a in act]),
            "q_mean": mean([torch.mean(c[1]) for c in crit]),
            "target_mean": mean([torch.mean(y) for y in ys])}
    return new_state, info


def ddpg_update_rounds(state: DDPGState, cfg: DDPGConfig, buf, idx,
                       transform=None, comm=None,
                       gather: bool = True) -> tuple[DDPGState, dict]:
    """``len(idx)`` updates, update ``u`` on the replay rows ``idx[u]``
    (idx: (num_updates, batch_size), drawn with
    :func:`repro_torch.core.replay.sample_indices` or passed in), each
    sampled batch mapped by ``transform`` when given.  Returns
    (new_state, infos stacked over the (num_updates,) axis).

    With ``comm``, ``buf`` and ``idx`` are lists: the local read rings
    this process holds and their (num_updates, per_device) indices.
    ``gather`` (the sharded rounds' gathered-batch mode, the reference's
    ``gather_axis``): update ``u`` runs on
    ``replay_sample_global(buf, [i[u] for i in idx], comm)``, the same
    global batch on every replica, which so stay bit-equal with no
    gradient collective; ``transform`` maps the gathered batch.  Not
    ``gather`` (the local-sample mode, the reference's ``axis_name``):
    update ``u`` runs :func:`ddpg_update_shards` on each ring's own
    rows, each mapped by ``transform``, averaged by ``comm.mean``."""
    tf = transform or (lambda b: b)
    infos = []
    for u in range(len(idx[0]) if comm is not None else len(idx)):
        if comm is None:
            state, info = ddpg_update(state, cfg, tf(replay_sample(
                buf, idx=idx[u])))
        elif gather:
            state, info = ddpg_update(state, cfg, tf(replay_sample_global(
                buf, [i[u] for i in idx], comm)))
        else:
            state, info = ddpg_update_shards(
                state, cfg, [tf(replay_sample(b, idx=i[u]))
                             for b, i in zip(buf, idx)], comm.mean)
        infos.append(info)
    if not infos:
        return state, {}
    return state, {k: torch.stack([i[k] for i in infos]) for k in infos[0]}


def ddpg_update_scan(state: DDPGState, cfg: DDPGConfig, buf: dict,
                     gen: torch.Generator | None, num_updates: int,
                     batch_size: int, idx=None
                     ) -> tuple[DDPGState, dict, dict]:
    """``num_updates`` updates of ``batch_size`` rows of the device ring
    ``buf`` through :func:`ddpg_update_rounds`, on indices drawn from
    ``gen`` (``replay.sample_indices``, one draw an update) or passed in
    as ``idx`` (num_updates, batch_size).  Returns ``(state, buf,
    infos)``: ``buf`` is the same object, unchanged and not copied (the
    port's reading of the reference's donated buffer, which aliases
    through to its output), ``infos`` stacked over the updates."""
    if idx is None:
        idx = torch.stack([sample_indices(buf, batch_size, gen)
                           for _ in range(num_updates)])
    state, infos = ddpg_update_rounds(state, cfg, buf, idx)
    return state, buf, infos
