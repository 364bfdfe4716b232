"""Train-step and serving-step factories, a port of
``repro.models.steps``.

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

Each factory takes ``mesh=`` and ``rules=`` as the reference's do.  On
no mesh, or a mesh of one rank, the steps are the one-device steps.  On
a mesh of several ranks (a ``DeviceMesh`` over the process group;
every family) the parameters, optimizer state and caches are DTensors
placed by ``models.partition`` (``runtime.elastic.device_put_like``),
the batch is split over the data axis (``batch_shardings``), and the
model constrains its activations by the reference's logical names:

- the loss is taken on each rank's block of the logits, its rows and
  vocab columns (:func:`_ce_blocks`), with explicit all-reduces over the
  mesh dims that split them: no rank holds the global batch's logits
  or their gradient, as the reference's vocab-sharded cross entropy;

- each gradient is redistributed to its parameter's placements before
  the clip and the update (DTensor's backward leaves some ``Partial``
  over the data axis), which is what the reference's in/out shardings
  do; the global norm reduces to a replicated scalar, and the update
  writes into the DTensor state in place;
- with ``grad_accum > 1`` each rank splits its own rows into the
  microbatches;
- the metrics (and the train step's loss) come back as plain replicated
  tensors; the prefill's logits and cache and the decode step's logits
  and cache stay DTensors, the decode step's greedy tokens are plain.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor import zeros as dtensor_zeros
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.models import partition as PT
from repro_torch.models import sharding as shd
from repro_torch.models.layers import NO_CTX, Ctx
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


def _ce_blocks(logits: DTensor, labels, mask, start: int = 0):
    """:func:`_ce` on a mesh, on each rank's block of the logits (B/dp
    rows, Vp/tp vocab columns; its positions ``start`` on, as many as
    this rank's rows of ``labels`` / ``mask`` have): the float32
    log-sum-exp from the local max and sum of exponentials, each
    all-reduced over the vocab's mesh dims (max, then sum), the gold
    logit from the rank that owns the label's column (a local mask,
    summed over the vocab's dims), and the mean over the mask as sums
    over the rows' dims.  The padded vocab columns enter the
    log-sum-exp as in :func:`_ce`.  No tensor holds another rank's rows
    or columns.  Returns (the loss, a plain tensor every rank holds; lse
    of this rank's rows (B/dp, T); the rows' mean of a (B/dp, T)
    tensor)."""
    mesh = logits.device_mesh
    rows = shd.split_by(logits.placements, 0)
    cols = shd.split_by(logits.placements, 2)
    if shd.split_by(logits.placements, 1):
        raise ValueError(f"the loss on a mesh: logits split along the "
                         f"sequence ({logits.placements})")
    T = labels.shape[1]
    lf = logits.to_local(grad_placements=logits.placements)[
        :, start:start + T].to(F32)
    v0 = shd.local_offset(2, logits.shape[2], logits.placements, mesh)
    m = shd.all_reduce(lf.detach().amax(dim=-1), "max", mesh, cols)
    sumexp = torch.exp(lf - m[..., None]).sum(dim=-1)
    lse = m + torch.log(shd.sum_over(sumexp, mesh, cols))
    at = labels.long() - v0
    own = (at >= 0) & (at < lf.shape[-1])
    pick = torch.gather(lf, -1, torch.clamp(at, 0, lf.shape[-1] - 1)
                        [..., None])[..., 0]
    gold = shd.sum_over(torch.where(own, pick, torch.zeros_like(pick)),
                        mesh, cols)

    def total(t):
        return shd.sum_over(t.sum(), mesh, rows)

    def mean(t):
        return total(t) / (logits.shape[0] * T)
    nll = (lse - gold) * mask
    return total(nll) / torch.clamp(total(mask), min=1.0), lse, mean


def _local_rows(tokens: DTensor, logits: DTensor):
    """This rank's rows of ``tokens`` (split over the batch), the rows of
    its logits block."""
    want = tuple(p if p == Shard(0) else Replicate()
                 for p in logits.placements)
    if tuple(tokens.placements) != want:
        tokens = tokens.redistribute(logits.device_mesh, want)
    return tokens.to_local()


def make_loss_fn(model: LM, ctx: Ctx = NO_CTX):
    """-> ``loss_fn(params, batch) -> (loss, metrics)``: ``ce``, plus
    ``aux`` (MoE; weighted by ``aux_loss_w`` into the loss) and
    ``zloss`` (the mean squared logsumexp, weighted by ``cfg.zloss``
    when it is > 0).  The VLM's loss covers the text only: logits at
    position P + i predict token i + 1.  ``ctx`` is the mesh and rules
    of a DTensor ``params`` tree; there the head leaves the logits split
    over the batch and the vocab, and the loss is taken on each rank's
    block (:func:`_ce_blocks`), never gathered."""
    cfg = model.cfg

    def loss_fn(params, batch):
        logits, aux = model.forward(batch, with_aux=True, params=params,
                                    ctx=ctx)
        P = cfg.n_patches if cfg.family == "vlm" else 0
        if isinstance(logits, DTensor):
            labels = _local_rows(batch["tokens"], logits)[:, 1:]
            mask = torch.ones(labels.shape, dtype=F32, device=labels.device)
            loss, lse, mean = _ce_blocks(logits, labels, mask, P)
        else:
            tokens = batch["tokens"].to(logits.device)
            if P:
                logits = logits[:, P:P + tokens.shape[1] - 1]
            else:
                logits = logits[:, :-1]
            labels = tokens[:, 1:]
            mask = torch.ones(labels.shape, dtype=F32, device=logits.device)
            loss, lse = _ce(logits, labels, mask)
            mean = torch.mean
        metrics = {"ce": loss}
        if cfg.is_moe:
            aux = whole(aux)
            loss = loss + cfg.aux_loss_w * aux
            metrics["aux"] = aux
        if cfg.zloss > 0:
            zl = mean(lse ** 2)
            loss = loss + cfg.zloss * zl
            metrics["zloss"] = zl
        return loss, metrics

    return loss_fn


def whole(x):
    """A DTensor as the plain tensor every rank holds (a no-op on a
    plain tensor)."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def value_and_grad(loss_fn, params, batch):
    """-> (loss, metrics, grads): the loss and metrics detached, the
    gradient of every parameter leaf in its dtype (zeros for a leaf the
    loss does not reach).  On a mesh the loss and metrics are plain
    replicated tensors and the gradients DTensors in whatever placements
    the backward left them."""
    with torch.enable_grad():
        tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = loss_fn(tracked, batch)
        loss, metrics = whole(loss), tree_map(whole, metrics)
        leaves = tree_leaves(tracked)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    by_leaf = {id(p): g for p, g in zip(leaves, grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda p: by_leaf[id(p)], tracked))


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------
def _placed_batch(batch, ctx: Ctx):
    """The batch's leaves split over the data axis (each rank keeps its
    rows of the batch every rank holds)."""
    pls = PT.batch_shardings(batch, ctx.mesh, ctx.rules)
    return {k: v if isinstance(v, DTensor) else
            shd.place(v, ctx.mesh, pls[k]) for k, v in batch.items()}


def _microbatches(batch, accum: int, ctx: Ctx) -> list:
    """``accum`` microbatches: on a mesh each rank splits its own rows."""
    if not ctx.active:
        return [{k: v.reshape((accum, v.shape[0] // accum)
                              + tuple(v.shape[1:]))[i]
                 for k, v in batch.items()} for i in range(accum)]

    def part(v, i):
        loc = v.to_local()
        loc = loc.reshape((accum, loc.shape[0] // accum)
                          + tuple(loc.shape[1:]))[i]
        shape = (v.shape[0] // accum,) + tuple(v.shape[1:])
        return DTensor.from_local(loc, ctx.mesh, v.placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=loc.stride())
    return [{k: part(v, i) for k, v in batch.items()} for i in range(accum)]


def _placed_optimizer(opt, ctx: Ctx):
    """``opt`` whose ``init`` places the moments like their parameters
    (``partition.opt_shardings``) on ``ctx``'s mesh."""
    if not ctx.active:
        return opt

    def init(params):
        shapes = opt.init(tree_map(lambda p: torch.empty(
            p.shape, dtype=p.dtype, device="meta"), params))
        return tree_map(lambda x, pls: dtensor_zeros(
            x.shape, dtype=x.dtype, device_mesh=ctx.mesh, placements=pls),
            shapes, PT.opt_shardings(shapes, ctx.mesh, ctx.rules))
    return dataclasses.replace(opt, init=init)


def make_train_step(model: LM, *, mesh=None, rules=None,
                    total_steps: int = 10_000, peak_lr: float = 3e-4):
    """-> ``(train_step, opt)``: ``train_step(params, opt_state, batch,
    step) -> (params, opt_state, metrics)`` with ``step`` a host int and
    the metrics (``loss``, ``gnorm``, ``lr`` and the loss's own) 0-d
    tensors.  With ``cfg.grad_accum > 1`` the batch is split into that
    many microbatches, run one after another; their gradients are
    summed in float32 over ``accum`` and their metrics averaged.  The
    update is written into ``params`` and ``opt_state``
    (``Optimizer.update``), as the reference's driver donates them.
    ``mesh`` / ``rules``: see the module docstring; ``opt.init`` then
    places the moments."""
    cfg = model.cfg
    ctx = Ctx(mesh=mesh, rules=rules)
    loss_fn = make_loss_fn(model, ctx)
    opt = _placed_optimizer(make_optimizer(cfg.optimizer,
                                          moment_dtype=cfg.moment_dtype), ctx)
    schedule = make_schedule(cfg.lr_schedule, peak=peak_lr,
                             warmup=max(1, total_steps // 100),
                             total=total_steps)
    accum = max(1, cfg.grad_accum)

    def like_params(grads, params):
        if not ctx.active:
            return grads
        return tree_map(lambda g, p: g if g.placements == p.placements
                        else g.redistribute(mesh, p.placements), grads,
                        params)

    def step_fn(params, opt_state, batch, step: int):
        if accum == 1:
            loss, metrics, grads = value_and_grad(loss_fn, params, batch)
            grads = like_params(grads, params)
        else:
            mbs = _microbatches(batch, accum, ctx)
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=F32),
                             params)
            loss = torch.zeros((), dtype=F32, device=model.device)
            mstack = []
            for mb in mbs:
                l_, m, g = value_and_grad(loss_fn, params, mb)
                g = like_params(g, params)
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
        metrics = {**metrics, "loss": loss, "gnorm": whole(gnorm),
                   "lr": lr}
        return new_params, new_opt, metrics

    if not ctx.active:
        return step_fn, opt

    def train_step(params, opt_state, batch, step: int):
        with implicit_replication():
            return step_fn(params, opt_state, _placed_batch(batch, ctx),
                           step)

    return train_step, opt


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------
def place_cache(cache, ctx: Ctx):
    """A cache placed by ``partition.cache_shardings`` on ``ctx``'s
    mesh: DTensors redistributed (a prefill's cache takes ``cache_seq``
    here), plain tensors split."""
    pls = PT.cache_shardings(cache, ctx.mesh, ctx.rules)

    def one(x, p):
        if not isinstance(x, DTensor):
            return shd.place(x, ctx.mesh, p)
        return x if tuple(x.placements) == p else x.redistribute(ctx.mesh, p)
    return tree_map(one, cache, pls)


def make_prefill_step(model: LM, *, pad_to: int | None = None, mesh=None,
                      rules=None):
    """-> ``prefill_step(batch) -> (last logits, cache)`` with the
    module's own parameters (DTensors placed on ``mesh`` there)."""
    ctx = Ctx(mesh=mesh, rules=rules)

    @torch.no_grad()
    def prefill_step(batch):
        if not ctx.active:
            return model.prefill(batch, pad_to=pad_to)
        with implicit_replication():
            logits, cache = model.prefill(_placed_batch(batch, ctx),
                                          pad_to=pad_to, ctx=ctx)
            return logits, place_cache(cache, ctx)

    return prefill_step


def make_decode_step(model: LM, *, mesh=None, rules=None):
    ctx = Ctx(mesh=mesh, rules=rules)

    @torch.no_grad()
    def decode_step(cache, batch):
        if not ctx.active:
            logits, cache = model.decode_step(cache, batch)
            # greedy token out (serving returns ids, not logits, to the
            # host)
            next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
            return next_tok, logits, cache
        with implicit_replication():
            logits, cache = model.decode_step(place_cache(cache, ctx), batch,
                                              ctx)
            next_tok = torch.argmax(logits.full_tensor(), dim=-1).to(
                torch.int32)
        return next_tok, logits, cache

    return decode_step
