"""Parameter / cache / optimizer partitioning: DTensor placements per
leaf.  A port of ``repro.models.partition``.

Leaves are classified by their *key path* (params are plain nested
dicts with stable, descriptive keys) plus rank: stacked (loop-over-
layers) parameters carry one extra leading dim which maps to ``None``
(layers are never sharded).  Key paths are the strings the reference
builds from JAX's key paths (``"stack/mixer/wq"``; a list index is its
number), so the same regexes match.

The same classification feeds three consumers:
  - ``param_shardings``  placements for the train and serve steps,
  - ``cache_shardings``  decode caches (kv-head TP with a sequence-
                         sharding fallback, see ``sharding.py``),
  - ``opt_shardings``    optimizer moments follow their parameter.
"""
from __future__ import annotations

import re

from torch.distributed.tensor import Replicate

from repro_torch.models import sharding as shd

# (key regex, logical axes for the *unstacked* parameter, by rank)
_PARAM_RULES: tuple[tuple[str, dict[int, tuple]], ...] = (
    (r"embed$",        {2: ("vocab", "fsdp")}),
    (r"lm_head$",      {2: ("fsdp", "vocab")}),
    (r"patch_proj$",   {2: (None, "fsdp")}),
    (r"wq$",           {3: ("fsdp", "heads", None)}),
    (r"w[kv]$",        {3: ("fsdp", "kv_heads", None)}),
    (r"wo$",           {3: ("heads", None, "fsdp")}),
    (r"router$",       {2: ("fsdp", None)}),
    # rank keys: stacked params add a leading layer dim, so rank-3 MLP
    # weights are stacked-dense (L, d, f); the MoE expert rule applies
    # at rank 4 (L, E, d, f) only.  Listing rank 3 under the expert rule
    # would shard the layer dim whenever n_layers divides the mesh axis.
    (r"w_(gate|up)$",  {2: ("fsdp", "mlp"),                    # dense MLP
                        4: (None, "expert", "fsdp", "mlp")}),  # MoE stacked
    (r"w_down$",       {2: ("mlp", "fsdp"),
                        4: (None, "expert", "mlp", "fsdp")}),
    (r"w_in$",         {2: ("fsdp", "model")}),        # ssm in-proj (packed)
    (r"w_out$",        {2: ("model", "fsdp")}),        # ssm out-proj
    (r"conv_w$",       {2: (None, "model")}),
    (r"(A_log|dt_bias|D)$", {1: ("ssm_heads",)}),
    (r"(scale|b|bias)$",    {1: (None,)}),
)

_CACHE_RULES: tuple[tuple[str, dict[int, tuple]], ...] = (
    (r"[kv]$",    {4: ("batch", "cache_kv", "cache_seq", None)}),
    (r"ssm$",     {4: ("batch", "ssm_heads", None, None)}),
    (r"conv$",    {3: ("batch", None, "model")}),
)


def _keystr(path) -> str:
    return "/".join(str(k) for k in path)


def _classify(path, ndim: int, rules, strip_state: bool = True) -> tuple:
    """Logical axes for a leaf, padding leading dims with None (stacking).

    Optimizer-state leaves nest *inside* the parameter key (Adafactor:
    ``.../wq/v_row``); the trailing state component is stripped so the
    parent parameter's rule applies, with factored rows/cols dropping
    the factored-away logical dim (v_row loses the last dim, v_col the
    second-to-last).  Only parameter and optimizer trees strip: a cache
    has a leaf literally named ``v`` (the value cache), which must match
    the cache rule.
    """
    ks = _keystr(path)
    parts = ks.split("/")
    suffix = parts[-1] if strip_state and parts[-1] in (
        "m", "v", "v_row", "v_col", "res") else None
    if suffix:
        ks = "/".join(parts[:-1])
    for pat, by_rank in rules:
        if re.search(pat, ks):
            ranks = sorted(by_rank, reverse=True)
            if suffix in ("v_row", "v_col"):
                # parent rank = ndim + 1 (one dim factored away)
                for r in ranks:
                    if ndim + 1 >= r:
                        base = list(by_rank[r])
                        base = base[:-1] if suffix == "v_row" else \
                            base[:-2] + base[-1:]
                        return (None,) * (ndim - len(base)) + tuple(base)
                break
            for r in ranks:
                if ndim >= r:
                    base = by_rank[r]
                    return (None,) * (ndim - r) + tuple(base)
    return (None,) * ndim


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts and lists (a path is the
    tuple of dict keys and list indices leading to the leaf)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def logical_axes(tree, *, rules=_PARAM_RULES):
    """Tree of logical-axis tuples mirroring ``tree`` (leaves need only
    ``.shape``)."""
    return map_with_path(lambda p, x: _classify(p, len(x.shape), rules), tree)


def leaf_spec(path, x, mesh, rules, kind: str = "param") -> tuple:
    """The spec of one leaf at ``path`` (a tuple of keys)."""
    table = _PARAM_RULES if kind == "param" else _CACHE_RULES
    logical = _classify(path, len(x.shape), table,
                        strip_state=(kind == "param"))
    return shd.logical_spec(tuple(x.shape), logical, mesh, rules)


def tree_shardings(tree, mesh, rules: shd.ShardingRules,
                   *, kind: str = "param"):
    """DTensor placements per leaf.  ``tree`` leaves need only
    ``.shape``."""
    return map_with_path(lambda p, x: shd.placements(
        leaf_spec(p, x, mesh, rules, kind), mesh), tree)


def param_shardings(params_shape, mesh, rules):
    return tree_shardings(params_shape, mesh, rules, kind="param")


def cache_shardings(cache_shape, mesh, rules):
    return tree_shardings(cache_shape, mesh, rules, kind="cache")


def opt_shardings(opt_shape, mesh, rules):
    """Optimizer state: moments mirror their parameter's placements (the
    parameter key is the innermost component of a moment's path, or the
    one before its state suffix)."""
    return tree_shardings(opt_shape, mesh, rules, kind="param")


def batch_shardings(batch_shape, mesh, rules: shd.ShardingRules):
    """Token/frame/patch inputs: leading batch dim over (pod?, data)."""

    def one(path, x):
        logical = ("batch",) + (None,) * (len(x.shape) - 1)
        return shd.logical_placements(x.shape, logical, mesh, rules)

    return map_with_path(one, batch_shape)


def replicated(mesh) -> tuple:
    return tuple(Replicate() for _ in shd.axis_sizes(mesh))
