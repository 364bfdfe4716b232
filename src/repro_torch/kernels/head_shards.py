"""``flash_attention``, ``decode_attention`` and ``ssd_forward`` on
head shards of a (data, model) mesh.

q is a DTensor ``("batch", "model", None, None)`` and k / v DTensors
``("batch", "cache_kv", ...)`` (the reference's constraints before its
attention).  Each rank runs the kernel's wrapper on its local block,
(B/dp, Hq/tp, S, D) against its kv heads, and the output is a DTensor
with q's placements; the launch counters count per rank.

Where the kv heads do not divide the model axis they are replicated
(``sharding.logical_spec``'s fallback): a rank's q heads then no longer
form whole groups of its kv heads.  Global q head ``j`` reads kv head
``j // G`` (``G = Hq / Hkv``), so each rank hands its q heads their own
kv heads: a contiguous slice when its heads are whole groups, the one
kv head its heads share, or one kv head each.  The kv gradient on such
a mesh dim is then a partial sum over the ranks (each holds its q
heads' part), which ``to_local``'s ``grad_placements`` states.

A decode cache whose sequence is split over the model axis (the same
fallback, ``cache_seq``) is gathered along the sequence before the
kernel.

:func:`ssd_forward_shards` runs the chunked SSD (``ssd_intra`` and the
inter-chunk pass) on a rank's own batch rows and Mamba-2 heads, so no
DTensor op sees its buffers; B / C, shared by the heads, are whole over
the heads' mesh dims, and their gradient is a partial sum there.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels.decode_gqa.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.ssd_chunk.ops import ssd_forward
from repro_torch.models import sharding as shd


def kv_heads_for(k, j0: int, hq: int, group: int, k0: int = 0):
    """The kv heads of local q heads ``j0 .. j0 + hq - 1`` (global
    numbers) as (kv tensor, its group): ``k`` (B, Hkv_local, S, D) holds
    global kv heads from ``k0``.  Global q head ``j`` reads kv head
    ``j // group``."""
    hkv = k.shape[1]
    if j0 % group == 0 and hq % group == 0:     # whole groups
        a = j0 // group - k0
        if a == 0 and hq // group == hkv:
            return k, group
        return k.narrow(1, a, hq // group).contiguous(), group
    if group % hq == 0 and j0 % hq == 0:        # all in one group
        return k.narrow(1, j0 // group - k0, 1).contiguous(), hq
    idx = (torch.arange(j0, j0 + hq, device=k.device) // group) - k0
    return k.index_select(1, idx).contiguous(), 1


def _heads(q: DTensor, k: DTensor):
    """(first global q head, first global kv head, global group) of this
    rank's blocks, and the kv gradient's placements."""
    mesh = q.device_mesh
    Hq, Hkv = q.shape[1], k.shape[1]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"attention on head shards: Hq={Hq} is not a "
                         f"multiple of Hkv={Hkv}")
    grad = []
    for pq, pk in zip(q.placements, k.placements):
        if pq == Shard(0) and pk != Shard(0):
            raise ValueError(f"q is split on the batch where k is not: "
                             f"{q.placements} against {k.placements}")
        if pk == Shard(1) and pq != Shard(1):
            raise ValueError(f"kv heads split where q heads are not: "
                             f"{q.placements} against {k.placements}")
        # replicated kv heads under split q heads: each rank holds its
        # heads' part of the kv gradient
        grad.append(Partial() if pq == Shard(1) and pk == Replicate()
                    else pk)
    j0 = shd.local_offset(1, Hq, q.placements, mesh)
    k0 = shd.local_offset(1, Hkv, k.placements, mesh)
    return j0, k0, Hq // Hkv, tuple(grad)


def flash_attention_shards(q: DTensor, k: DTensor, v: DTensor, *,
                           causal: bool = True, window: int = 0) -> DTensor:
    """:func:`flash_attention` on this rank's head shard; differentiable
    (the kernel forward, the plain backward, per shard)."""
    j0, k0, group, kgrad = _heads(q, k)
    ql = q.to_local(grad_placements=q.placements)
    kl = k.to_local(grad_placements=kgrad)
    vl = v.to_local(grad_placements=kgrad)
    hq = ql.shape[1]
    kl, _ = kv_heads_for(kl, j0, hq, group, k0)
    vl, _ = kv_heads_for(vl, j0, hq, group, k0)
    return shd.from_local(flash_attention(ql.contiguous(), kl, vl,
                                          causal=causal, window=window),
                          q.device_mesh, q.placements, q.shape)


def _seq_whole(x: DTensor) -> DTensor:
    """``x`` (B, H, S, D) with its sequence dim gathered on every rank."""
    pls = tuple(Replicate() if p == Shard(2) else p for p in x.placements)
    return x if pls == tuple(x.placements) else \
        x.redistribute(x.device_mesh, pls)


@torch.no_grad()
def decode_attention_shards(q: DTensor, k: DTensor, v: DTensor,
                            length: torch.Tensor) -> DTensor:
    """:func:`decode_attention` on this rank's head shard.  ``length``
    (B,) is the global (plain) tensor; a rank takes its batch rows."""
    k, v = _seq_whole(k), _seq_whole(v)
    j0, k0, group, _ = _heads(q, k)
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    hq = ql.shape[1]
    kl, _ = kv_heads_for(kl, j0, hq, group, k0)
    vl, _ = kv_heads_for(vl, j0, hq, group, k0)
    b0 = shd.local_offset(0, q.shape[0], q.placements, q.device_mesh)
    rows = shd.local_shape(q.shape, q.placements, q.device_mesh)[0]
    return shd.from_local(decode_attention(ql.contiguous(), kl, vl,
                                           length[b0:b0 + rows]),
                          q.device_mesh, q.placements, q.shape)


def ssd_forward_shards(x: DTensor, dt, A, Bm, Cm, *, chunk: int = 128):
    """:func:`ssd_forward` on this rank's rows and heads: x (B, T, H, P)
    split by its placements over the batch (dim 0) and the heads (dim
    2); dt (B, T, H), A (H,) and Bm / Cm (B, T, N) are brought to the
    matching placements (B / C whole over the heads' mesh dims).
    Returns (y (B, T, H, P) with x's placements, the final state
    (B, H, N, P) split over the same rows and heads); differentiable:
    the gradient of A is a partial sum over the rows' mesh dims, that
    of Bm / Cm over the heads' ones."""
    mesh, pls = x.device_mesh, tuple(x.placements)
    for p in pls:
        if p not in (Shard(0), Shard(2), Replicate()):
            raise ValueError(f"ssd on shards: x placed {pls}")
    rows = [p == Shard(0) for p in pls]
    heads = [p == Shard(2) for p in pls]

    def placed(t, row_dim, head_dim):
        want = tuple(Shard(row_dim) if r and row_dim is not None
                     else Shard(head_dim) if h and head_dim is not None
                     else Replicate() for r, h in zip(rows, heads))
        if not isinstance(t, DTensor):
            return shd.place(t, mesh, want)
        return t if tuple(t.placements) == want else \
            t.redistribute(mesh, want)

    def local(t, grad):
        return t.to_local(grad_placements=tuple(grad))

    dt = placed(dt, 0, 2)
    A = placed(A, None, 0)
    Bm, Cm = placed(Bm, 0, None), placed(Cm, 0, None)
    part_rows = [Partial() if r else p for r, p in zip(rows, A.placements)]
    part_heads = [Partial() if h else p for h, p in zip(heads, Bm.placements)]
    y, S = ssd_forward(local(x, pls), local(dt, dt.placements),
                       local(A, part_rows), local(Bm, part_heads),
                       local(Cm, part_heads), chunk=chunk)
    B, T, H, P = x.shape
    s_pls = tuple(Shard(0) if r else Shard(1) if h else Replicate()
                  for r, h in zip(rows, heads))
    return (shd.from_local(y, mesh, pls, (B, T, H, P)),
            shd.from_local(S, mesh, s_pls, (B, H, Bm.shape[2], P)))
