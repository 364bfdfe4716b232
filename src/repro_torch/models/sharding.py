"""Logical-axis sharding rules (MaxText-style) with divisibility
fallback, as DTensor placements.

A port of ``repro.models.sharding``.  Every parameter and activation
dimension carries a *logical* name; the rule table maps logical names to
mesh axes.  :func:`logical_spec` resolves a tuple of logical names into
a spec against a concrete mesh and shape, dropping any mesh axis that
does not divide the dimension (kv_heads 8 on a model axis of 16 is
replicated rather than refused).  A spec is a tuple with one entry a
tensor dim: ``None``, a mesh-axis name, or a tuple of names (the
reference's ``PartitionSpec`` entries, with no JAX type).

Default 2D strategy (data, model) [+ pod folded into data]:
  batch            -> (pod?, data)     activations / token dims
  embed/d_model    -> data  (FSDP: weights sharded over the data axis)
  heads/ff/vocab   -> model (tensor parallelism)
  experts          -> expert = model axis when divisible
  kv_heads         -> model if divisible else replicated
  cache_seq        -> model when kv_heads cannot shard (long decode)

:func:`placements` turns a spec into DTensor placements on a
``DeviceMesh`` (one per mesh dim: ``Shard(d)`` where the spec names the
mesh axis on tensor dim ``d``, else ``Replicate()``), and :func:`shard`
plays the part of ``with_sharding_constraint``: it redistributes a
DTensor, and leaves a tensor as it is on no mesh or a mesh of one rank.

A mesh here is anything with ``mesh_dim_names`` and a ``shape`` (a
``DeviceMesh``, ``launch.mesh.AbstractMesh``), or a ``shape`` mapping
axis names to sizes (a JAX mesh, or a test's duck type).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: tuple[tuple[str, tuple[str, ...]], ...]

    def axes_for(self, logical: str) -> tuple[str, ...]:
        for name, axes in self.rules:
            if name == logical:
                return axes
        return ()


def make_rules(multi_pod: bool, overrides: dict[str, tuple[str, ...]] | None
               = None) -> ShardingRules:
    """Default rule table.  ``overrides`` remaps individual logical names
    (e.g. ``{"expert": ("data",)}``)."""
    dp = ("pod", "data") if multi_pod else ("data",)
    base = {
        "batch": dp,
        "fsdp": dp,                # weight dim sharded over the data axis
        "model": ("model",),       # tensor-parallel dim
        "vocab": ("model",),       # embedding/lm-head vocab dim
        "heads": ("model",),       # attention query heads
        "kv_heads": ("model",),    # attention kv heads (may fall back)
        "mlp": ("model",),         # FFN hidden dim
        "expert": ("model",),      # experts prefer the model axis
        "ssm_heads": ("model",),   # mamba heads
        "cache_kv": ("model",),    # kv heads of a decode cache
        "cache_seq": ("model",),   # decode-cache sequence sharding
        # decode-serving activation layout: () is a no-op; decode cells
        # may override it to ("data",) so the (B, 1, d) activations
        # co-shard with the FSDP weight contraction dim
        "dec_embed": (),
        "replicated": (),
    }
    if overrides:
        base.update(overrides)
    return ShardingRules(rules=tuple(base.items()))


def axis_sizes(mesh) -> dict[str, int]:
    """Mesh axis name -> size, in the mesh's order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def logical_spec(shape: tuple[int, ...], logical: tuple[str | None, ...],
                 mesh, rules: ShardingRules) -> tuple:
    """Resolve logical names to a spec, enforcing divisibility and never
    using a mesh axis twice."""
    assert len(shape) == len(logical), (shape, logical)
    sizes = axis_sizes(mesh)
    used: set[str] = set()
    out = []
    for dim, name in zip(shape, logical):
        if name is None:
            out.append(None)
            continue
        axes = []
        for ax in rules.axes_for(name):
            if ax in used or ax not in sizes:
                continue
            cur = 1
            for a in axes:
                cur *= sizes[a]
            if dim % (cur * sizes[ax]) == 0:
                axes.append(ax)
                used.add(ax)
        out.append(tuple(axes) if len(axes) > 1 else (axes[0] if axes else None))
    return tuple(out)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim the spec names on tensor dim ``d``, else ``Replicate()``.
    A dim over several axes (``("pod", "data")``) is split over them
    major to minor, JAX's order; DTensor splits in mesh-dim order, so
    the axes must come in the mesh's order."""
    names = list(axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"axis order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def logical_placements(shape, logical, mesh, rules) -> tuple:
    return placements(logical_spec(tuple(shape), logical, mesh, rules), mesh)


def local_shape(shape, pls, mesh) -> tuple[int, ...]:
    """The shape of one rank's block of a tensor of ``shape`` under
    placements ``pls`` (the divisibility :func:`logical_spec` enforces
    makes every block the same)."""
    out = list(shape)
    for p, n in zip(pls, axis_sizes(mesh).values()):
        if isinstance(p, Shard):
            out[p.dim] //= n
    return tuple(out)


def local_offset(dim: int, size: int, pls, mesh) -> int:
    """Where this rank's block of tensor dim ``dim`` (of ``size``)
    starts under ``pls``: the mesh dims sharding it split it in order,
    each taking its coordinate's chunk of what the earlier ones left."""
    off, cur = 0, size
    for p, n, c in zip(pls, axis_sizes(mesh).values(),
                       mesh.get_coordinate()):
        if isinstance(p, Shard) and p.dim == dim:
            cur //= n
            off += c * cur
    return off


def is_multi(mesh) -> bool:
    """A mesh of more than one rank (DTensors are used only there)."""
    if mesh is None:
        return False
    n = 1
    for s in axis_sizes(mesh).values():
        n *= s
    return n > 1


def place(x: torch.Tensor, mesh, pls) -> DTensor:
    """A DTensor on ``mesh`` from the full tensor ``x``, which every
    rank holds: each keeps its own block (a copy), with no
    communication."""
    local = x
    for d in range(x.ndim):
        n_off = local_offset(d, x.shape[d], pls, mesh)
        n = local_shape(x.shape, pls, mesh)[d]
        if n != x.shape[d]:
            local = local.narrow(d, n_off, n)
    return DTensor.from_local(local.contiguous().clone(), mesh, pls,
                              run_check=False, shape=x.shape,
                              stride=x.contiguous().stride())


def shard(x, logical: tuple[str | None, ...], mesh, rules: ShardingRules):
    """``with_sharding_constraint`` by logical names: a DTensor is
    redistributed to the placements the rules give; a plain tensor (no
    mesh, or a mesh of one rank) is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    pls = logical_placements(x.shape, logical, mesh, rules)
    if tuple(x.placements) == pls:
        return x
    return x.redistribute(mesh, pls)


def contiguous_stride(shape) -> tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (no tensor made:
    a meta tensor would count as storage under the dry run's counter)."""
    out, n = [], 1
    for s in reversed(tuple(shape)):
        out.append(n)
        n *= s
    return tuple(reversed(out))


def split_by(pls, dim: int) -> list[int]:
    """The mesh dims whose placement in ``pls`` splits tensor dim
    ``dim``."""
    return [i for i, p in enumerate(pls)
            if isinstance(p, Shard) and p.dim == dim]


def all_reduce(x: torch.Tensor, op: str, mesh, dims) -> torch.Tensor:
    """``op`` ("sum", "max") of the plain tensor ``x`` over the mesh
    dims ``dims``: a functional all-reduce a dim (those DTensor issues,
    so a ``cuda`` mesh over gloo stages it through the host as it does
    them, ``launch.mesh.stage_gloo_cuda_collectives``).  Not
    differentiable: :func:`sum_over` is."""
    import torch.distributed._functional_collectives  # noqa: F401 (ops)
    c10d = torch.ops._c10d_functional
    for d in dims:
        x = c10d.wait_tensor(c10d.all_reduce(
            x.contiguous(), op, mesh.get_group(d).group_name))
    return x


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims):
        return all_reduce(x, "sum", mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def sum_over(x: torch.Tensor, mesh, dims) -> torch.Tensor:
    """The sum of this rank's ``x`` over the mesh dims ``dims``, which
    every rank of them then holds as the one value.  Differentiable: the
    adjoint passes the gradient through unchanged, since the gradient of
    a replicated value is itself replicated (what DTensor's backward of
    a ``Partial`` -> ``Replicate`` redistribution does)."""
    return _SumOver.apply(x, mesh, tuple(dims)) if dims else x


def new_zeros(x, shape) -> torch.Tensor:
    """``x.new_zeros(shape)``; for a DTensor ``x`` a DTensor of ``x``'s
    placements whose every rank allocates only its own block (DTensor's
    ``new_zeros`` gives every rank the whole, replicated)."""
    if not isinstance(x, DTensor):
        return x.new_zeros(shape)
    from torch.distributed.tensor import zeros
    return zeros(shape, dtype=x.dtype, device_mesh=x.device_mesh,
                 placements=x.placements)


def rows_placements(shape, mesh, rules: ShardingRules) -> tuple:
    """The placements of a (B, ...) tensor split over the batch by the
    rules, replicated on every other dim."""
    return logical_placements(shape, ("batch",) + (None,) * (len(shape) - 1),
                              mesh, rules)


def to_local_rows(x: DTensor, mesh, rules: ShardingRules) -> torch.Tensor:
    """``x`` (B, ...) as this rank's rows (:func:`rows_placements`);
    differentiable."""
    pls = rows_placements(x.shape, mesh, rules)
    if tuple(x.placements) != pls:
        x = x.redistribute(mesh, pls)
    return x.to_local(grad_placements=pls)


def from_local(t: torch.Tensor, mesh, pls, shape) -> DTensor:
    """This rank's block ``t`` as the contiguous DTensor of global
    ``shape`` placed by ``pls``; differentiable."""
    return DTensor.from_local(t.contiguous(), mesh, tuple(pls),
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))
