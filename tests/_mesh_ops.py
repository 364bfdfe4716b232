"""Rank entry that runs single operators of the LM on a (data, model)
mesh, for holding them against their one-process counterparts: the
loss on each rank's vocab block (``models.steps._ce_blocks``), the SSD
on head shards (``kernels.head_shards.ssd_forward_shards``) and the MoE
FFN on each rank's rows (``models.moe.moe_fwd``).

Spawn it with ``rl_train.spawn_ranks(_mesh_ops.mesh_ops_rank, n, jobs,
device=...)`` from a test that imports it by name (the tests' directory
is on ``sys.path``, and a spawned rank gets the parent's path): it
imports nothing of JAX, so the ranks stay free of it.  A job is a
dict: ``op`` ("loss", "ssd", "moe"), ``mesh`` (a (data, model) shape),
``device`` and the op's inputs as NumPy arrays (``inputs``, whole:
every rank gets all of them and keeps its block).  Each returns this rank's blocks of the outputs and of the
inputs' gradients, NumPy, with the blocks' offsets, and ``loaded``
(modules of JAX or ``repro`` the rank imported: none).
"""
from __future__ import annotations

import sys

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import sharding as shd
from repro_torch.models.layers import Ctx


def _np(t) -> np.ndarray:
    t = t.to_local() if isinstance(t, DTensor) else t
    return t.detach().float().cpu().numpy()


def _whole(t) -> np.ndarray:
    return _np(t.full_tensor() if isinstance(t, DTensor) else t)


def _leaf(x, mesh, pls=None):
    """A DTensor leaf that autograd tracks: ``x`` placed by ``pls``
    (replicated by default)."""
    pls = pls or tuple(Replicate() for _ in mesh.shape)
    return shd.place(x, mesh, pls).detach().requires_grad_()


def loss_job(job, mesh, device) -> dict:
    """``_ce_blocks`` on logits (B, T + 1, Vp) placed as the head leaves
    them (``("batch", None, "vocab")``) and tokens (B, T + 1) split over
    the batch: the loss, the z-loss (the mean of lse squared), this
    rank's lse block, and its block of the gradient of ``loss + zw *
    zloss`` with respect to the logits."""
    from repro_torch.models.steps import _ce_blocks, _local_rows
    rules = shd.make_rules(False)
    x = torch.as_tensor(job["inputs"]["logits"]).to(device)
    tokens = torch.as_tensor(job["inputs"]["tokens"]).to(device)
    pls = shd.logical_placements(x.shape, ("batch", None, "vocab"), mesh,
                                 rules)
    logits = _leaf(x, mesh, pls)
    tok = shd.place(tokens, mesh, shd.rows_placements(tokens.shape, mesh,
                                                      rules))
    labels = _local_rows(tok, logits)[:, 1:]
    mask = torch.ones(labels.shape, dtype=torch.float32, device=device)
    loss, lse, mean = _ce_blocks(logits, labels, mask)
    zl = mean(lse ** 2)
    (loss + job["zw"] * zl).backward()
    return {"loss": loss.item(), "zloss": zl.item(), "lse": _np(lse),
            "grad": _np(logits.grad), "placements": str(pls),
            "rows": (shd.local_offset(0, x.shape[0], pls, mesh),
                     labels.shape[0]),
            "cols": (shd.local_offset(2, x.shape[2], pls, mesh),
                     shd.local_shape(x.shape, pls, mesh)[2])}


def ssd_job(job, mesh, device) -> dict:
    """``ssd_forward_shards`` on x (B, T, H, P) split as the Mamba-2
    block constrains it (``("batch", None, "model", None)``) and dt, A,
    Bm, Cm replicated: y and the final state whole, and the whole
    gradients of ``sum(y * wy) + sum(state * ws)``."""
    from repro_torch.kernels.head_shards import ssd_forward_shards
    rules = shd.make_rules(False)
    inp = {k: torch.as_tensor(v).to(device) for k, v in job["inputs"].items()}
    xs = inp["x"]
    leaves = {"x": _leaf(xs, mesh, shd.logical_placements(
        xs.shape, ("batch", None, "model", None), mesh, rules))}
    leaves.update({k: _leaf(inp[k], mesh) for k in ("dt", "A", "Bm", "Cm")})
    y, S = ssd_forward_shards(*leaves.values(), chunk=job["chunk"])
    wy, ws = (shd.place(inp[k], mesh, t.placements)
              for k, t in (("wy", y), ("ws", S)))
    ((y * wy).sum() + (S * ws).sum()).full_tensor().backward()
    return {"y": _whole(y), "state": _whole(S),
            "y_local": tuple(y.to_local().shape),
            "state_placements": str(S.placements),
            "grads": {k: _whole(v.grad) for k, v in leaves.items()}}


def moe_job(job, mesh, device) -> dict:
    """``moe_fwd`` (one MoE FFN, with the aux loss) on x (B, S, d) split
    over the batch and the FFN's parameters placed by the rules: the
    output and the aux loss whole, and the whole gradients of ``sum(out
    * w) + aux`` with respect to x and every parameter."""
    from repro_torch.models import partition as PT
    from repro_torch.models.moe import moe_fwd
    rules = shd.make_rules(False, overrides=job.get("overrides"))
    inp = {k: torch.as_tensor(v).to(device) for k, v in job["inputs"].items()}
    stacked = {k: inp[k][None] for k in ("router", "w_gate", "w_up",
                                         "w_down")}
    pls = PT.param_shardings({"ffn": stacked}, mesh, rules)["ffn"]
    # a layer's placements: the stacked leaf's, less its layer dim
    params = {k: _leaf(v[0], mesh, tuple(
        Shard(p.dim - 1) if isinstance(p, Shard) else p for p in pls[k]))
        for k, v in stacked.items()}
    x = _leaf(inp["x"], mesh, shd.rows_placements(inp["x"].shape, mesh,
                                                  rules))
    out, aux = moe_fwd(params, x, top_k=job["top_k"],
                       ctx=Ctx(mesh=mesh, rules=rules))
    w = shd.place(inp["w"], mesh, out.placements)
    ((out * w).sum().full_tensor() + aux).backward()
    return {"out": _whole(out), "aux": aux.item(),
            "placements": {k: str(v.placements) for k, v in params.items()},
            "grads": {"x": _whole(x.grad),
                      **{k: _whole(v.grad) for k, v in params.items()}}}


JOBS = {"loss": loss_job, "ssd": ssd_job, "moe": moe_job}


def mesh_ops_rank(rank: int, relay, jobs: list) -> list:
    """One rank of the jobs (module docstring), one after another."""
    out = []
    for job in jobs:
        device = resolve_device(job["device"])
        mesh = make_mesh(tuple(job["mesh"]), ("data", "model"), device.type)
        res = JOBS[job["op"]](job, mesh, device)
        res["mesh"] = tuple(job["mesh"])
        res["loaded"] = sorted(m for m in sys.modules
                               if m == "jax" or m.startswith(("jax.",
                                                              "repro.")))
        out.append(res)
    return out
