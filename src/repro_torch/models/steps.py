"""Train-step and serving-step factories, a port of
``repro.models.steps`` for one device.

``make_train_step``: next-token cross entropy (a float32 log-softmax
over the padded vocab), the MoE aux loss, an optional z-loss, gradient
accumulation over microbatches, and the AdamW / Adafactor update with
global-norm clipping and the config's LR schedule.  Gradients come from
``torch.autograd.grad`` over the parameter leaves; the layers are
recomputed in the backward where ``cfg.remat`` is set
(``transformer.remat``).  Parameters and optimizer state are explicit
(nested dicts of tensors), and nothing is updated in place.

``make_prefill_step`` / ``make_decode_step``: batch prefill and one
greedy decode step for every family; the prefill passes the batch
through as it is (whisper's ``frames``, the VLM's ``patches``).
"""
from __future__ import annotations

import torch

from repro_torch.models.model import LM
from repro_torch.optim import make_optimizer, make_schedule
from repro_torch.tree import tree_leaves, tree_map

F32 = torch.float32


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def _ce(logits, labels, mask):
    """Cross entropy in float32.  logits (B,T,Vp), labels/mask (B,T) ->
    (mean over the mask, logsumexp (B,T))."""
    lf = logits.to(F32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0), lse


def make_loss_fn(model: LM):
    """-> ``loss_fn(params, batch) -> (loss, metrics)``: ``ce``, plus
    ``aux`` (MoE; weighted by ``aux_loss_w`` into the loss) and
    ``zloss`` (the mean squared logsumexp, weighted by ``cfg.zloss``
    when it is > 0).  The VLM's loss covers the text only: logits at
    position P + i predict token i + 1."""
    cfg = model.cfg

    def loss_fn(params, batch):
        logits, aux = model.forward(batch, with_aux=True, params=params)
        tokens = batch["tokens"].to(logits.device)
        if cfg.family == "vlm":
            P = cfg.n_patches
            logits = logits[:, P:P + tokens.shape[1] - 1]
        else:
            logits = logits[:, :-1]
        labels = tokens[:, 1:]
        mask = torch.ones(labels.shape, dtype=F32, device=logits.device)
        loss, lse = _ce(logits, labels, mask)
        metrics = {"ce": loss}
        if cfg.is_moe:
            loss = loss + cfg.aux_loss_w * aux
            metrics["aux"] = aux
        if cfg.zloss > 0:
            zl = torch.mean(lse ** 2)
            loss = loss + cfg.zloss * zl
            metrics["zloss"] = zl
        return loss, metrics

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """-> (loss, metrics, grads): the loss and metrics detached, the
    gradient of every parameter leaf in its dtype (zeros for a leaf the
    loss does not reach)."""
    with torch.enable_grad():
        tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = loss_fn(tracked, batch)
        leaves = tree_leaves(tracked)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    by_leaf = {id(p): g for p, g in zip(leaves, grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda p: by_leaf[id(p)], tracked))


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------
def make_train_step(model: LM, *, total_steps: int = 10_000,
                    peak_lr: float = 3e-4):
    """-> ``(train_step, opt)``: ``train_step(params, opt_state, batch,
    step) -> (params, opt_state, metrics)`` with ``step`` a host int and
    the metrics (``loss``, ``gnorm``, ``lr`` and the loss's own) 0-d
    tensors.  With ``cfg.grad_accum > 1`` the batch is split into that
    many microbatches, run one after another; their gradients are
    summed in float32 over ``accum`` and their metrics averaged.  The
    update is written into ``params`` and ``opt_state``
    (``Optimizer.update``), as the reference's driver donates them."""
    cfg = model.cfg
    loss_fn = make_loss_fn(model)
    opt = make_optimizer(cfg.optimizer, moment_dtype=cfg.moment_dtype)
    schedule = make_schedule(cfg.lr_schedule, peak=peak_lr,
                             warmup=max(1, total_steps // 100),
                             total=total_steps)
    accum = max(1, cfg.grad_accum)

    def train_step(params, opt_state, batch, step: int):
        if accum == 1:
            loss, metrics, grads = value_and_grad(loss_fn, params, batch)
        else:
            mbs = [{k: v.reshape((accum, v.shape[0] // accum)
                                 + tuple(v.shape[1:]))[i]
                    for k, v in batch.items()} for i in range(accum)]
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                   device=p.device), params)
            loss = torch.zeros((), dtype=F32, device=model.device)
            mstack = []
            for mb in mbs:
                l_, m, g = value_and_grad(loss_fn, params, mb)
                for a, g_ in zip(tree_leaves(grads), tree_leaves(g)):
                    a.add_(g_.to(F32) / accum)      # acc + g / accum
                del g
                loss = loss + l_ / accum
                mstack.append(m)
            metrics = {k: torch.stack([m[k] for m in mstack]).mean()
                       for k in mstack[0]}
        lr = schedule(step)
        new_params, new_opt, gnorm = opt.update(grads, opt_state, params,
                                                step, lr)
        metrics = {**metrics, "loss": loss, "gnorm": gnorm, "lr": lr}
        return new_params, new_opt, metrics

    return train_step, opt


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------
def make_prefill_step(model: LM, *, pad_to: int | None = None):
    @torch.no_grad()
    def prefill_step(batch):
        return model.prefill(batch, pad_to=pad_to)

    return prefill_step


def make_decode_step(model: LM):
    @torch.no_grad()
    def decode_step(cache, batch):
        logits, cache = model.decode_step(cache, batch)
        # greedy token out (serving returns ids, not logits, to the host)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, cache

    return decode_step
