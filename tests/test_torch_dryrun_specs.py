"""The dry run's spec functions and arithmetic against the reference's.

- ``batch_specs`` for every arch and its shapes, ``cache_specs`` at
  smoke size for the decode shapes: equal shapes and dtypes (the port's
  cache fake, with no storage);
- ``_n_params``, ``_active_params`` and ``model_flops`` for every full
  arch, the port's fake init against ``jax.eval_shape(model.init,
  key)``;
- ``roofline``'s ``_unit_counts``, ``_cost_cfg``'s layer counts,
  ``_affine_total`` and ``dryrun._parse_overrides``: equal;
- ``roofline_terms`` and ``_terms`` on the same inputs: equal with the
  reference's hardware constants set to the port's (the H100's);
- ``_TRAFFIC_FACTOR`` on a grid of (z, n): equal.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` (512 host
devices) when it is imported; JAX's backend is started first and the
variable put back, so nothing else in the worker sees it.
"""
import os

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import is_fake

jax.devices()                       # the backend, before the flags change
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.configs import registry as ref_reg  # noqa: E402
from repro.launch import dryrun as ref_dry  # noqa: E402
from repro.launch import hlo_analysis as ref_ha  # noqa: E402
from repro.launch import roofline as ref_roof  # noqa: E402
from repro.models import partition as ref_pt  # noqa: E402
from repro.models.model import build_model  # noqa: E402

if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

from repro_torch.configs import registry as reg  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as HA  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.models import partition as PT  # noqa: E402

torch.set_num_threads(1)
ARCHS = list(reg.ARCHS)


def _jax_leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {ref_pt._keystr(p): (tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in flat}


def _torch_leaves(tree) -> dict:
    out = {}
    PT.map_with_path(lambda p, x: out.__setitem__(
        PT._keystr(p), (tuple(x.shape), str(x.dtype).removeprefix("torch."))),
        tree)
    return out


def test_archs_and_shape_grids_are_the_references():
    assert ARCHS == list(ref_reg.ARCHS)
    for a in ARCHS:
        assert reg.shapes_for(reg.get_arch(a)) == \
            ref_reg.shapes_for(ref_reg.get_arch(a))


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal(arch):
    cfg, ref_cfg = reg.get_arch(arch), ref_reg.get_arch(arch)
    for name in reg.shapes_for(cfg):
        got = reg.batch_specs(cfg, SHAPES[name])
        want = ref_reg.batch_specs(ref_cfg, ref_reg.SHAPES[name])
        assert _torch_leaves(got) == _jax_leaves(want), name
        assert all(x.device.type == "meta" for x in got.values())
        assert reg._text_len(cfg, SHAPES[name].seq_len) == \
            ref_reg._text_len(ref_cfg, SHAPES[name].seq_len)
    assert str(reg._act_dtype(cfg)).removeprefix("torch.") == \
        np.dtype(ref_reg._act_dtype(ref_cfg)).name


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_at_smoke_size(arch):
    cfg, ref_cfg = reg.get_arch(arch, smoke=True), \
        ref_reg.get_arch(arch, smoke=True)
    for name in reg.shapes_for(cfg):
        if SHAPES[name].kind != "decode":
            continue
        got = reg.cache_specs(cfg, SHAPES[name], "cpu")
        want = ref_reg.cache_specs(ref_cfg, ref_reg.SHAPES[name])
        assert _torch_leaves(got) == _jax_leaves(want), name
        leaves = []
        PT.map_with_path(lambda p, x: leaves.append(x), got)
        assert leaves and all(is_fake(x) for x in leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_model_flops_equal(arch):
    cfg, ref_cfg = reg.get_arch(arch), ref_reg.get_arch(arch)
    want_tree = jax.eval_shape(build_model(ref_cfg).init,
                               jax.random.PRNGKey(0))
    got_tree = dryrun.param_specs(cfg)
    assert _torch_leaves(got_tree) == _jax_leaves(want_tree)
    assert dryrun._n_params(got_tree) == ref_dry._n_params(want_tree)
    n, n_act = dryrun._n_params(got_tree)[0], \
        dryrun._active_params(cfg, got_tree)
    assert n_act == ref_dry._active_params(ref_cfg, want_tree)
    for name in reg.shapes_for(cfg):
        assert HA.model_flops(cfg, SHAPES[name], n, n_act) == \
            ref_ha.model_flops(ref_cfg, ref_reg.SHAPES[name], n, n_act)


def test_roofline_arithmetic_equal():
    for arch in ARCHS:
        cfg, ref_cfg = reg.get_arch(arch), ref_reg.get_arch(arch)
        assert roofline._unit_counts(cfg) == ref_roof._unit_counts(ref_cfg)
        for n in (1, 2, 8):
            got, want = roofline._cost_cfg(cfg, n), \
                ref_roof._cost_cfg(ref_cfg, n)
            assert (got.n_layers, got.enc_layers, got.grad_accum) == \
                (want.n_layers, want.enc_layers, want.grad_accum)
    rng = np.random.default_rng(0)
    A = {k: float(v) for k, v in zip(("flops", "bytes accessed",
                                      "coll/all-gather"), rng.uniform(
                                          1, 1e9, 3))}
    B = {k: v * 1.7 + 3 for k, v in A.items()}
    B["coll/all-reduce"] = 12.5
    for units in (1, 2, 24, 126):
        assert roofline._affine_total(A, B, units) == \
            ref_roof._affine_total(A, B, units)
    for pairs in ([], ["expert=data"], ["batch=pod+data", "heads="],
                  ["cache_seq=model", "fsdp=data+model"]):
        assert dryrun._parse_overrides(pairs) == \
            ref_dry._parse_overrides(pairs)


def test_roofline_terms_equal_apart_from_the_constants(monkeypatch):
    monkeypatch.setattr(ref_ha, "PEAK_FLOPS", HA.PEAK_FLOPS)
    monkeypatch.setattr(ref_ha, "HBM_BW", HA.HBM_BW)
    monkeypatch.setattr(ref_ha, "ICI_BW", HA.NVLINK_BW)
    for cost, by_op in (({"flops": 3.1e12, "bytes accessed": 2.2e9},
                         {"all-gather": 4.4e8, "all-reduce": 1.0e7}),
                        ({"flops": 1e9, "bytes accessed": 7.5e11},
                         {"reduce-scatter": 2.0e6}),
                        ({"flops": 5e8, "bytes accessed": 1e6},
                         {"all-to-all": 9.0e9})):
        counts = {k: 3 for k in by_op}
        got = HA.roofline_terms(cost, HA.CollectiveStats(
            sum(by_op.values()), by_op, counts), 256)
        want = ref_ha.roofline_terms(cost, ref_ha.CollectiveStats(
            sum(by_op.values()), by_op, counts), 256)
        assert got == want
        tot = {**cost, **{f"coll/{k}": v for k, v in by_op.items()}}
        assert roofline._terms(tot, 256, {"units": 24}) == \
            ref_roof._terms(tot, 256, {"units": 24})


def test_traffic_factors_equal():
    assert set(HA._TRAFFIC_FACTOR) == set(ref_ha._TRAFFIC_FACTOR)
    for kind, fn in HA._TRAFFIC_FACTOR.items():
        for z in (0, 1, 1000, 12345, 2 ** 31):
            for n in (1, 2, 4, 16, 256, 512):
                assert fn(z, n) == ref_ha._TRAFFIC_FACTOR[kind](z, n)
