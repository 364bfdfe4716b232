"""The port's dense LM (``repro_torch.models``) against the JAX package's
``LM`` on smoke configs, with the JAX parameters carried over by
``lm_params_from_numpy``.

Configs: internlm2 (GQA), minicpm (MHA, tied embeddings) and deepseek
(MHA), each in float32 (their smoke dtype) and in a bfloat16 variant
made with ``dataclasses.replace``.  Token ids are drawn with NumPy.

Tolerances:
- float32: atol = rtol = 2e-5 (the same float32 arithmetic, summed in
  another order; the largest difference seen is ~2e-6 on logits of
  magnitude ~4);
- bfloat16: atol = 0.1, rtol = 0.02 elementwise, and a mean absolute
  difference under 0.01.  Both packages round every matmul, norm and
  activation to bf16, but not always at the same place (a bf16 ulp is
  0.0156 at |x| in [2, 4)); over two layers the logits move by up to a
  few ulps, most by none.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.models.layers import Ctx
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import ARCHS, SMOKES, get_arch
from repro_torch.kernels.decode_gqa import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import (LM, lm_params_from_numpy, make_decode_step,
                                make_prefill_step)

torch.set_num_threads(1)
ARCH_NAMES = ["internlm2-1.8b", "minicpm-2b", "deepseek-7b"]
B, S, PAD, STEPS = 2, 12, 16, 3


def _close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    else:
        np.testing.assert_allclose(got, want, atol=0.1, rtol=0.02)
        assert np.abs(got - want).mean() < 0.01


@pytest.fixture(scope="module", params=[(a, d) for a in ARCH_NAMES
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    name, dtype = request.param
    jcfg = dataclasses.replace(jax_get_arch(name, smoke=True),
                               param_dtype=dtype)
    cfg = dataclasses.replace(get_arch(name, smoke=True), param_dtype=dtype)
    jmodel = jax_build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = LM(cfg, device="cpu").load_numpy(
        jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return dict(jmodel=jmodel, params=params, model=model, toks=toks,
                dtype=dtype, rng=rng, cfg=cfg)


def test_configs_are_the_jax_configs():
    from repro.configs.registry import ARCHS as JARCHS
    from repro.configs.registry import SMOKES as JSMOKES
    assert list(ARCHS) == list(JARCHS)
    for name in ARCHS:
        assert dataclasses.asdict(ARCHS[name]) == \
            dataclasses.asdict(JARCHS[name])
        assert dataclasses.asdict(SMOKES[name]) == \
            dataclasses.asdict(JSMOKES[name])
        assert ARCHS[name].vocab_padded == JARCHS[name].vocab_padded


def test_params_carry_over(pair):
    model, params = pair["model"], pair["params"]
    want = sum(x.size for x in jax.tree.leaves(params))
    assert model.param_count() == want
    assert model.params["embed"].dtype == (
        torch.bfloat16 if pair["dtype"] == "bfloat16" else torch.float32)
    np.testing.assert_array_equal(
        model.params["stack"]["mixer"]["wq"].float().numpy(),
        np.asarray(params["stack"]["mixer"]["wq"].astype(jnp.float32)))


def test_forward_matches_jax(pair):
    jlogits, _ = pair["jmodel"].forward(
        pair["params"], {"tokens": jnp.asarray(pair["toks"])}, Ctx())
    logits = pair["model"].forward({"tokens": torch.as_tensor(pair["toks"])})
    _close(logits, jlogits, pair["dtype"])


def test_prefill_and_decode_match_jax(pair):
    jmodel, params, model = pair["jmodel"], pair["params"], pair["model"]
    toks, dtype = pair["toks"], pair["dtype"]
    jl, jc = jmodel.prefill(params, {"tokens": jnp.asarray(toks)}, Ctx(),
                            pad_to=PAD)
    logits, cache = make_prefill_step(model, pad_to=PAD)(
        {"tokens": torch.as_tensor(toks)})
    _close(logits, jl, dtype)
    assert cache["k"].shape == jc["k"].shape
    for name in ("k", "v"):
        _close(cache[name], jc[name], dtype)
    rng = np.random.default_rng(2)
    decode = make_decode_step(model)
    for step in range(STEPS):
        tok = rng.integers(0, pair["cfg"].vocab, (B, 1)).astype(np.int32)
        # row 1 rewrites positions it has already filled
        pos = np.array([S + step, S - 2 + step], np.int32)
        jl, jc = jmodel.decode_step(params, jc, {"token": jnp.asarray(tok),
                                                 "pos": jnp.asarray(pos)},
                                    Ctx())
        nxt, logits, cache = decode(cache, {"token": torch.as_tensor(tok),
                                            "pos": torch.as_tensor(pos)})
        _close(logits, jl, dtype)
        for name in ("k", "v"):
            _close(cache[name], jc[name], dtype)
        assert nxt.dtype == torch.int32 and nxt.shape == (B,)
        np.testing.assert_array_equal(nxt.numpy(),
                                      logits.argmax(-1).numpy())


def test_prefill_plus_decode_is_forward(pair):
    """forward at position S-1 == prefill of S-1 tokens + one decode
    step of token S-1 at position S-1 (the port against itself)."""
    model, toks, dtype = pair["model"], pair["toks"], pair["dtype"]
    full = model.forward({"tokens": torch.as_tensor(toks)})[:, -1]
    _, cache = model.prefill({"tokens": torch.as_tensor(toks[:, :-1])},
                             pad_to=S)
    logits, _ = model.decode_step(
        cache, {"token": torch.as_tensor(toks[:, -1:]),
                "pos": torch.full((B,), S - 1, dtype=torch.int32)})
    _close(logits, full.float().numpy(), dtype)


def test_cpu_path_launches_no_kernel(pair):
    before = (fa_ops.LAUNCHES, dec_ops.LAUNCHES)
    model = pair["model"]
    _, cache = model.prefill({"tokens": torch.as_tensor(pair["toks"])},
                             pad_to=PAD)
    model.decode_step(cache, {"token": torch.zeros((B, 1), dtype=torch.int32),
                              "pos": torch.full((B,), S, dtype=torch.int32)})
    assert (fa_ops.LAUNCHES, dec_ops.LAUNCHES) == before


def test_init_draws_the_jax_layout():
    cfg = get_arch("internlm2-1.8b", smoke=True)
    jparams = jax_build_model(jax_get_arch("internlm2-1.8b", smoke=True)
                              ).init(jax.random.PRNGKey(0))
    model = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda x: tuple(x.shape), jparams)

    def tshapes(x):
        if isinstance(x, dict):
            return {k: tshapes(v) for k, v in x.items()}
        return tuple(x.shape)
    assert tshapes(model.params) == shapes
    w = model.params["stack"]["mixer"]["wq"].float()
    assert w.abs().max() <= 2 * cfg.d_model ** -0.5 + 1e-6
    assert torch.isfinite(model.forward(
        {"tokens": torch.zeros((1, 4), dtype=torch.int32)})).all()


def test_init_cache_layout():
    cfg = get_arch("internlm2-1.8b", smoke=True)
    cache = LM(cfg, device="cpu").init_cache(3, 40, torch.float32)
    assert cache["k"].shape == (cfg.n_layers, 3, cfg.n_kv, 40, cfg.head_dim)
    swa = dataclasses.replace(cfg, window=8)
    assert LM(swa, device="cpu").init_cache(3, 40)["v"].shape[3] == 8


def test_lm_params_from_numpy_checks_keys():
    cfg = get_arch("minicpm-2b", smoke=True)
    with pytest.raises(ValueError, match="lm_head"):
        lm_params_from_numpy(cfg, {"embed": np.zeros((2, 2)),
                                   "final_norm": {}, "stack": {},
                                   "lm_head": np.zeros((2, 2))})


@pytest.mark.parametrize("name", ["mixtral-8x7b", "olmoe-1b-7b",
                                  "mamba2-2.7b", "jamba-v0.1-52b",
                                  "whisper-tiny", "internvl2-76b"])
def test_later_families_raise(name):
    with pytest.raises(NotImplementedError, match="slice"):
        LM(get_arch(name, smoke=True), device="cpu")
    with pytest.raises(NotImplementedError, match="slice"):
        lm_params_from_numpy(get_arch(name, smoke=True), {})
