"""Mesh construction, a port of ``repro.launch.mesh``: ``DeviceMesh``es
over the process group already initialised (one rank a device), with
the reference's axis names.

A DTensor's mesh must have the device type of its local tensors: ranks
on the card use a ``cuda`` mesh whatever the backend (NCCL, or gloo for
ranks that share one card: NCCL refuses two ranks on one GPU), ranks on
the CPU a ``cpu`` mesh over gloo.

Gloo carries CUDA tensors through the plain collectives (it stages them
in host memory itself), but DTensor's functional collectives on CUDA
tensors over gloo crash in ``wait_tensor`` (torch 2.11,
``scripts/gloo_cuda_probe.py``).  So a ``cuda`` mesh over a gloo group
installs :func:`stage_gloo_cuda_collectives`: those collectives on CUDA
tensors run their CPU kernels on host copies and copy the result back,
what gloo does inside its own CUDA path.  Only the collectives move
through the host; every computation stays on the card.  A process whose
groups are NCCL never installs it.

:func:`make_host_mesh` on a world of one rank needs no process group:
it returns an :class:`AbstractMesh` of shape (1, 1), on which
``sharding.shard`` is the identity and state stays plain tensors.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names with no ranks behind it: enough to
    resolve specs, placements and local shapes (the reference's
    ``jax.sharding.AbstractMesh``), and the one-rank host mesh."""
    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]
    device_type: str = "cpu"


# the functional collectives DTensor issues (the ``_c10d_functional`` ops)
STAGED_OPS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
              "all_to_all_single", "broadcast")
_STAGED_LIBS: list = []


def _through_host(op):
    """A CUDA kernel for the functional collective ``op``: run its CPU
    kernel on a host copy, wait for it, copy the result back."""
    import torch

    def kernel(x, *args):
        out = op(x.cpu(), *args)
        out = torch.ops._c10d_functional.wait_tensor(out)
        return out.to(x.device)
    return kernel


def _shard_dim_alltoall(x, gather_dim: int, shard_dim: int, group_name: str):
    """DTensor's Shard(i) -> Shard(j) exchange on CUDA tensors over gloo:
    gather along ``gather_dim`` through the host, keep this rank's chunk
    along ``shard_dim`` (what DTensor does on a ``cpu`` mesh)."""
    import torch
    from torch.distributed.distributed_c10d import _resolve_process_group
    pg = _resolve_process_group(group_name)
    xs = x.movedim(gather_dim, 0).contiguous().cpu()
    g = torch.ops._c10d_functional.all_gather_into_tensor(xs, pg.size(),
                                                          group_name)
    g = torch.ops._c10d_functional.wait_tensor(g).movedim(0, gather_dim)
    return torch.chunk(g, pg.size(), dim=shard_dim)[pg.rank()].contiguous(
        ).to(x.device)


def stage_gloo_cuda_collectives() -> None:
    """Register the host-staged CUDA kernels of :data:`STAGED_OPS` and of
    DTensor's ``shard_dim_alltoall`` (once a process).  For ranks whose
    groups are all gloo."""
    import torch
    if _STAGED_LIBS:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    for name in STAGED_OPS:
        lib.impl(name, _through_host(
            getattr(torch.ops._c10d_functional, name).default), "CUDA")
    dlib = torch.library.Library("_dtensor", "IMPL")
    dlib.impl("shard_dim_alltoall", _shard_dim_alltoall, "CUDA")
    _STAGED_LIBS.extend([lib, dlib])


def _device_type(device_type: str | None) -> str:
    import torch.distributed as dist
    if device_type is not None:
        return device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` over ranks 0 .. prod(shape) - 1 of
    the process group already initialised, with dims named ``axes``.
    ``device_type`` defaults to ``cuda`` on NCCL and ``cpu`` on gloo;
    ranks that share a card over gloo pass ``"cuda"``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the process group first "
                           "(torch.distributed.init_process_group)")
    n = 1
    for s in shape:
        n *= s
    if n > dist.get_world_size():
        raise ValueError(f"make_mesh: a {shape} mesh needs {n} ranks, the "
                         f"world has {dist.get_world_size()}")
    kind = _device_type(device_type)
    if kind == "cuda" and dist.get_backend() == "gloo":
        stage_gloo_cuda_collectives()
    return DeviceMesh(kind, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """16x16 (data, model); 2x16x16 (pod, data, model) for two pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(device_type: str = "cuda"):
    """The one-rank (1, 1) (data, model) mesh of the training driver:
    an :class:`AbstractMesh` when no process group is initialised (no
    rendezvous is needed), else a ``DeviceMesh`` over rank 0."""
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        return AbstractMesh((1, 1), ("data", "model"), device_type)
    return make_mesh((1, 1), ("data", "model"), device_type)
