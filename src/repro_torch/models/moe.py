"""Mixture-of-Experts FFN with sort-based capacity dispatch, a port of
``repro.models.moe``.  ``moe_fwd`` takes the sharding context at the
reference's sites; on a mesh of several ranks each rank dispatches and
combines its own groups, the reference's design (its group dim split
over the batch, so the sort is local).

Tokens are dispatched per group, one group being one sequence: each
group's ``(token, k)`` assignments (flattened token-major) are sorted
by expert with a stable sort, and an expert takes the first ``C`` of
them in that order, ``C = round_up_8(int(cf * S * k / E) + 1)``.  The
rest are dropped (they land on a sentinel row; the residual carries
those tokens).  The expert products are three batched matmuls over all
``E x C`` slots of every group, as the reference's einsums: every
expert runs, also at decode, where ``C = 8`` slots hold one token.

The router is float32 (weights and logits); the top-k gates are a
softmax over the top-k logits, cast to the activations' dtype.  An
auxiliary load-balancing loss ``E * sum(mean gate * share of first
choices)`` is computed for the trainer, and only where it is asked for:
decode and prefill skip its kernels.

The reference combines with a scatter-add in slot order.  Here each
assignment gathers its slot's output, and a token's k contributions
are added one by one in ascending expert order, which is the order in
which the reference's scatter reaches them: the same sums, with no
atomics and no order left to the device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial

from repro_torch.models import sharding as shd
from repro_torch.models.layers import dense_init

# leaves kept in float32 whatever the weights' dtype
FLOAT32_KEYS = ("router",)
KEYS = {"router", "w_gate", "w_up", "w_down"}


def moe_init(gen, d, f, n_experts, dtype):
    return {"router": dense_init(gen, (d, n_experts), torch.float32),
            "w_gate": dense_init(gen, (n_experts, d, f), dtype, d),
            "w_up": dense_init(gen, (n_experts, d, f), dtype, d),
            "w_down": dense_init(gen, (n_experts, f, d), dtype, f)}


def capacity(S: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert and group: ``int(cf * S * k / E) + 1`` rounded
    up to a multiple of 8."""
    C = int(capacity_factor * S * top_k / n_experts) + 1
    return -(-C // 8) * 8


def _group_dispatch(x, eidx, n_experts: int, C: int):
    """x (G, S, d), eidx (G, S, k) expert ids -> (slots (G, E*C, d),
    slot (G, S*k)): every assignment's slot in its group, token-major,
    ``E * C`` for a dropped one."""
    G, S, d = x.shape
    k = eidx.shape[-1]
    ef = eidx.reshape(G, S * k)
    order = torch.argsort(ef, dim=-1, stable=True)
    se = torch.gather(ef, 1, order)
    experts = torch.arange(n_experts, device=x.device, dtype=se.dtype)
    starts = torch.searchsorted(se, experts.expand(G, -1).contiguous())
    rank = torch.arange(S * k, device=x.device) - torch.gather(starts, 1, se)
    slot_sorted = torch.where(rank < C, se * C + rank, n_experts * C)
    slot = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    # the slots a group's assignments fill are distinct, so each kept
    # slot is written once; dropped ones all go to the sentinel row
    tok = torch.arange(S * k, device=x.device) // k
    slots = x.new_zeros((G, n_experts * C + 1, d))
    slots.scatter_(1, slot[..., None].expand(-1, -1, d), x[:, tok])
    return slots[:, :-1], slot


def _group_combine(y, slot, eidx, gates):
    """y (G, E*C, d) -> (G, S, d): each token's k slot outputs times
    their gates, added in ascending expert order from zero."""
    G, S, k = gates.shape
    d = y.shape[-1]
    y = torch.cat([y, y.new_zeros((G, 1, d))], dim=1)      # sentinel: 0
    by_expert = torch.argsort(eidx, dim=-1)
    slot = torch.gather(slot.reshape(G, S, k), 2, by_expert)
    gates = torch.gather(gates, 2, by_expert)
    val = torch.gather(y, 1, slot.reshape(G, S * k, 1).expand(-1, -1, d))
    val = val.reshape(G, S, k, d) * gates[..., None]
    out = y.new_zeros((G, S, d))
    for j in range(k):
        out = out + val[:, :, j]
    return out


def route(p, x, top_k: int):
    """The router: float32 logits of x (B,S,d) -> (top-k expert ids
    (B,S,k), highest first; their gates, a softmax over the top-k
    logits in x's dtype; the logits (B,S,E))."""
    logits = x.float() @ p["router"]                       # (B,S,E) f32
    top_logits, top_idx = torch.topk(logits, top_k, dim=-1, sorted=True)
    top_gates = torch.softmax(top_logits, dim=-1).to(x.dtype)
    return top_idx, top_gates, logits


def load_balance(logits, top_idx, mean=None):
    """The aux loss, a float32 scalar: ``E * sum(mean gate * share of
    first choices)`` over the batch and sequence.  ``mean`` takes the
    mean of a (B, S, E) tensor over (B, S) (on a mesh, this rank's rows'
    part of the whole batch's)."""
    E = logits.shape[-1]
    mean = mean or (lambda t: t.mean(dim=(0, 1)))
    me = mean(torch.softmax(logits, dim=-1))
    ce = mean(F.one_hot(top_idx[..., 0], E).float())
    return E * torch.sum(me * ce)


def _slot_rows(B: int, C: int, ctx) -> str | None:
    """The logical name of the slots' merged (B*C) dim on ``ctx``'s
    mesh: ``"batch"`` where the mesh splits it as it splits the batch B
    (each rank its groups' slots), else None (replicated: B does not
    split, and C must not)."""
    by_rows = shd.logical_spec((B,), ("batch",), ctx.mesh, ctx.rules)
    by_slots = shd.logical_spec((B * C,), ("batch",), ctx.mesh, ctx.rules)
    return "batch" if by_rows == by_slots else None


def moe_fwd(p, x, *, top_k: int, capacity_factor: float = 1.25,
            with_aux: bool = True, ctx=None):
    """x (B,S,d) -> (out (B,S,d), aux loss, a float32 scalar; None
    without ``with_aux``, where no kernel is spent on it).  ``ctx``
    (``layers.Ctx``) constrains the slots, the hidden and the output by
    the reference's logical names, in this module's (E, B*C, .)
    layout.  On a mesh of several ranks (``x`` a DTensor) the router
    reads its weight whole over the FSDP axes (a row's logits summed
    over d as on one device), the routing, dispatch and combine run on
    each rank's own groups (rows), the expert products on DTensors; the
    aux loss's means reduce over the whole batch."""
    shard = ctx.shard if ctx is not None else (lambda t, logical: t)
    B, S, d = x.shape
    E = p["router"].shape[-1]
    C = capacity(S, top_k, E, capacity_factor)
    if not isinstance(x, DTensor):
        top_idx, top_gates, logits = route(p, x, top_k)
        aux = load_balance(logits, top_idx) if with_aux else None
        slots, slot = _group_dispatch(x, top_idx, E, C)
        y = _experts(p, slots, B, C, shard, "batch")
        return _group_combine(y, slot, top_idx, top_gates), aux
    # this rank's rows (groups) and the whole router: the routing, the
    # dispatch and the combine are local
    mesh = ctx.mesh
    pls = shd.rows_placements(x.shape, mesh, ctx.rules)
    rows = shd.split_by(pls, 0)
    xl = shd.to_local_rows(x, mesh, ctx.rules)
    router = ctx.weight(p["router"])
    router = router.to_local(grad_placements=tuple(
        Partial() if i in rows else pl
        for i, pl in enumerate(router.placements)))
    top_idx, top_gates, logits = route({"router": router}, xl, top_k)
    aux = None
    if with_aux:
        aux = load_balance(logits, top_idx, lambda t: shd.sum_over(
            t.sum(dim=(0, 1)), mesh, rows) / (B * S))
    slots, slot = _group_dispatch(xl, top_idx, E, C)
    slots = shd.from_local(slots, mesh, pls, (B, E * C, d))
    y = _experts(p, slots, B, C, shard, _slot_rows(B, C, ctx))
    y = shd.to_local_rows(y, mesh, ctx.rules)
    out = _group_combine(y, slot, top_idx, top_gates)
    return shard(shd.from_local(out, mesh, pls, (B, S, d)),
                 ("batch", None, None)), aux


def _experts(p, slots, B: int, C: int, shard, rows):
    """The three expert products over every group's slots (B, E*C, d)
    -> (B, E*C, d), in (E, B*C, .) with the reference's constraints
    (``rows``: the merged dim's logical name, :func:`_slot_rows`)."""
    E, d = p["router"].shape[-1], slots.shape[-1]
    slots = shard(slots.reshape(B, E, C, d), ("batch", None, None, None))
    slots = slots.transpose(0, 1).reshape(E, B * C, d)
    h = F.silu(torch.bmm(slots, p["w_gate"])) * torch.bmm(slots, p["w_up"])
    h = shard(h, (None, rows, "model"))
    y = shard(torch.bmm(h, p["w_down"]), (None, rows, None))  # (E, B*C, d)
    return y.reshape(E, B, C, d).transpose(0, 1).reshape(B, E * C, d)
