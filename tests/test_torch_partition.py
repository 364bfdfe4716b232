"""The port's partition rules (``repro_torch.models.{sharding,partition}``)
against the JAX package's own functions, which run here without a mesh
of devices: ``make_rules``, ``logical_spec`` on a duck-typed mesh,
``logical_axes`` / ``tree_shardings`` of every family's smoke
parameter, AdamW and Adafactor state, cache and batch, and each leaf's
local shape under the port's DTensor placements against
``NamedSharding(AbstractMesh(...), spec).shard_shape`` on (2, 4),
(4, 2) and (2, 2, 2) meshes.  Everything is equal: the rules are pure
functions of shapes and key paths.  The reference's three regression
cases hold in the port too.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs.registry import get_arch as jax_get_arch
from repro.models import partition as JPT
from repro.models import sharding as jshd
from repro.models.model import build_model as jax_build_model
from repro.optim import make_optimizer as jax_make_optimizer
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import LM
from repro_torch.models import partition as PT
from repro_torch.models import sharding as shd
from repro_torch.optim import make_optimizer

torch.set_num_threads(1)
FAMILY_ARCHS = ["internlm2-1.8b", "olmoe-1b-7b", "mamba2-2.7b",
                "jamba-v0.1-52b", "whisper-tiny", "internvl2-76b"]
MESHES = [((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
B, SMAX = 8, 32


class _FakeMesh:
    """Duck-typed mesh for logical_spec (a ``shape`` mapping only), as
    tests/test_partition.py builds it."""

    def __init__(self, **axes):
        self.shape = dict(axes)


def _spec(p) -> tuple:
    return tuple(p)


def test_make_rules_match_jax():
    for multi_pod in (False, True):
        for over in (None, {"expert": ("data",)},
                     {"dec_embed": ("data",), "cache_seq": ()}):
            assert shd.make_rules(multi_pod, over).rules == \
                jshd.make_rules(multi_pod, over).rules


@pytest.mark.parametrize("axes", [dict(data=16, model=16),
                                  dict(data=4, model=4),
                                  dict(pod=2, data=16, model=16),
                                  dict(data=3, model=5)])
def test_logical_spec_matches_jax(axes):
    """Divisibility fallback, never an axis twice, multi-axis entries."""
    mesh = _FakeMesh(**axes)
    cases = [((128, 8, 32768, 128), ("batch", "cache_kv", "cache_seq", None)),
             ((128, 16, 32768, 128), ("batch", "cache_kv", "cache_seq", None)),
             ((64, 64), ("model", "model")),
             ((96, 30), ("fsdp", "mlp")),
             ((32, 7, 5), ("batch", "heads", None)),
             ((6,), ("replicated",)),
             ((64, 16), ("vocab", "fsdp"))]
    for multi_pod in (False, True):
        rules, jrules = shd.make_rules(multi_pod), jshd.make_rules(multi_pod)
        for shape, logical in cases:
            assert shd.logical_spec(shape, logical, mesh, rules) == _spec(
                jshd.logical_spec(shape, logical, mesh, jrules)), (
                    shape, logical, multi_pod)


def _trees(arch):
    """(port trees, JAX trees) of one family's smoke config: params,
    AdamW and Adafactor state, cache and batch; JAX's as shape structs."""
    cfg, jcfg = get_arch(arch, smoke=True), jax_get_arch(arch, smoke=True)
    model = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    jmodel = jax_build_model(jcfg)
    jparams = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    params = model.params
    port = {"params": params,
            "adamw": make_optimizer("adamw").init(params),
            "adafactor": make_optimizer("adafactor").init(params),
            "cache": model.init_cache(B, SMAX),
            "batch": {"tokens": torch.zeros((B, 16), dtype=torch.int32)}}
    jax_ = {"params": jparams,
            "adamw": jax.eval_shape(jax_make_optimizer("adamw").init,
                                    jparams),
            "adafactor": jax.eval_shape(
                jax_make_optimizer("adafactor").init, jparams),
            "cache": jax.eval_shape(
                lambda: jmodel.init_cache(B, SMAX, jnp.bfloat16)),
            "batch": {"tokens": jax.ShapeDtypeStruct((B, 16), jnp.int32)}}
    if cfg.family == "encdec":
        port["batch"]["frames"] = torch.zeros((B, cfg.n_frames, cfg.d_model))
        jax_["batch"]["frames"] = jax.ShapeDtypeStruct(
            (B, jcfg.n_frames, jcfg.d_model), jnp.float32)
    if cfg.family == "vlm":
        port["batch"]["patches"] = torch.zeros((B, cfg.n_patches,
                                                cfg.vit_dim))
        jax_["batch"]["patches"] = jax.ShapeDtypeStruct(
            (B, jcfg.n_patches, jcfg.vit_dim), jnp.float32)
    return port, jax_


def _flat(tree, path=()):
    """{path: leaf} of nested dicts (a JAX tree after ``tree_map``)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


@pytest.fixture(scope="module", params=FAMILY_ARCHS)
def trees(request):
    return request.param, _trees(request.param)


def test_logical_axes_match_jax(trees):
    arch, (port, jax_) = trees
    for name in ("params", "adamw", "adafactor"):
        got = _flat(PT.logical_axes(port[name]))
        want = _flat(JPT.logical_axes(jax_[name]))
        assert got == want, (arch, name)
    got = _flat(PT.logical_axes(port["cache"], rules=PT._CACHE_RULES))
    want = _flat(JPT.logical_axes(jax_["cache"], rules=JPT._CACHE_RULES))
    assert got == want, arch
    shapes = {k: tuple(v.shape) for k, v in _flat(port["params"]).items()}
    assert shapes == {k: tuple(v.shape)
                      for k, v in _flat(jax_["params"]).items()}


@pytest.mark.parametrize("shape,axes", MESHES, ids=lambda v: str(v))
def test_local_shapes_match_jax_shard_shape(trees, shape, axes):
    """Every leaf's spec equal to JAX's, and its local block under the
    port's placements equal to ``NamedSharding.shard_shape``."""
    arch, (port, jax_) = trees
    multi_pod = len(shape) == 3
    mesh, jmesh = AbstractMesh(shape, axes), JAbstractMesh(shape, axes)
    rules, jrules = shd.make_rules(multi_pod), jshd.make_rules(multi_pod)
    for name in ("params", "adamw", "adafactor", "cache", "batch"):
        tree, jtree = port[name], jax_[name]
        if name == "batch":
            pls = PT.batch_shardings(tree, mesh, rules)
            jsh = JPT.batch_shardings(jtree, jmesh, jrules)
        else:
            kind = "cache" if name == "cache" else "param"
            pls = PT.tree_shardings(tree, mesh, rules, kind=kind)
            jsh = JPT.tree_shardings(jtree, jmesh, jrules, kind=kind)
            jflat = _flat(jsh)
            for path, leaf in _flat(tree).items():
                assert PT.leaf_spec(path, leaf, mesh, rules, kind) == \
                    _spec(jflat[path].spec), (arch, name, path)
        flat, jflat = _flat(pls), _flat(jsh)
        leaves, jleaves = _flat(tree), _flat(jtree)
        assert flat.keys() == jflat.keys(), (arch, name)
        for path, p in flat.items():
            want = jflat[path].shard_shape(tuple(jleaves[path].shape))
            got = shd.local_shape(tuple(leaves[path].shape), p, mesh)
            assert got == tuple(want), (arch, name, path, got, want)


def test_regressions_of_the_reference():
    """The reference's three regression cases, in the port and in JAX."""
    for mod in (PT, JPT):
        # rank-3 stacked dense MLP (L, d, f) is not the rank-4 expert rule
        assert mod._classify(("stack", "ffn", "w_up"), 3, mod._PARAM_RULES) \
            == (None, "fsdp", "mlp")
        assert mod._classify(("stack", "ffn", "w_up"), 4, mod._PARAM_RULES) \
            == (None, "expert", "fsdp", "mlp")
        # a cache's value leaf "v" is not stripped as an optimizer moment
        assert mod._classify(("v",), 5, mod._CACHE_RULES,
                             strip_state=False) == (
            None, "batch", "cache_kv", "cache_seq", None)
        # Adafactor's factored moments drop the factored-away dim
        wq = ("stack", "mixer", "wq")
        assert mod._classify(wq + ("v_row",), 3, mod._PARAM_RULES) == (
            None, "fsdp", "heads")
        assert mod._classify(wq + ("v_col",), 3, mod._PARAM_RULES) == (
            None, "fsdp", None)
    mesh = AbstractMesh((4, 2), ("data", "model"))
    rules = shd.make_rules(False)
    state = {"stack": {"mixer": {"wq": {
        "v_row": torch.zeros((2, 64, 8)), "v_col": torch.zeros((2, 64, 16))}}}}
    pls = PT.opt_shardings(state, mesh, rules)["stack"]["mixer"]["wq"]
    assert shd.local_shape((2, 64, 8), pls["v_row"], mesh) == (2, 16, 4)
    assert shd.local_shape((2, 64, 16), pls["v_col"], mesh) == (2, 16, 16)


def test_placements_of_multi_axis_specs():
    mesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    pls = shd.placements((("pod", "data"), "model", None), mesh)
    assert pls == (shd.Shard(0), shd.Shard(0), shd.Shard(1))
    assert shd.local_shape((8, 6, 3), pls, mesh) == (2, 3, 3)
    with pytest.raises(ValueError, match="axis order"):
        shd.placements((("data", "pod"),), mesh)
    assert PT.replicated(mesh) == (shd.Replicate(),) * 3
    assert not shd.is_multi(AbstractMesh((1, 1), ("data", "model")))
    assert shd.is_multi(mesh)
