"""The port's LM (``repro_torch.models``) against the JAX package's
``LM`` on smoke configs, with the JAX parameters carried over by
``lm_params_from_numpy``.

Configs: internlm2 (GQA), minicpm (MHA, tied embeddings) and deepseek
(MHA) of the dense family, and mamba2 (the SSM family: 2 layers,
d_model 64, 8 SSM heads of 16, state 16, chunk 16), each in float32
(their smoke dtype) and in a bfloat16 variant made with
``dataclasses.replace``.  Token ids are drawn with NumPy.  The mamba2
prompts are S = 16 (a multiple of the chunk) and S = 37, where the JAX
stack falls back to chunk 1 (``_pick_chunk``) and the port pads to the
chunk: the same function either way.

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
from repro.models import ssm as jax_ssm
from repro.models.layers import Ctx
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import ARCHS, SMOKES, get_arch
from repro_torch.kernels.decode_gqa import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.models import (LM, lm_params_from_numpy, make_decode_step,
                                make_prefill_step)
from repro_torch.models import ssm as SSM
from repro_torch.models.transformer import layer_params

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


@pytest.mark.parametrize("name", list(ARCHS))
def test_every_smoke_config_builds_and_runs(name):
    """Every family of the reference runs in the port: each smoke
    config builds an LM on the CPU, draws its weights and runs a
    forward to finite logits of the reference's shape."""
    cfg = get_arch(name, smoke=True)
    model = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (1, 5)).astype(np.int32))}
    S = 5
    if cfg.family == "encdec":
        batch["frames"] = torch.as_tensor(rng.standard_normal(
            (1, cfg.n_frames, cfg.d_model)).astype(np.float32) * 0.1)
    if cfg.family == "vlm":
        batch["patches"] = torch.as_tensor(rng.standard_normal(
            (1, cfg.n_patches, cfg.vit_dim)).astype(np.float32))
        S += cfg.n_patches
    logits = model.forward(batch)
    assert logits.shape == (1, S, cfg.vocab_padded)
    assert torch.isfinite(logits.float()).all()


def test_an_unknown_family_is_refused():
    cfg = dataclasses.replace(get_arch("internlm2-1.8b", smoke=True),
                              family="rnn")
    with pytest.raises(ValueError, match="unknown family 'rnn'"):
        LM(cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown family 'rnn'"):
        lm_params_from_numpy(cfg, {})


# ---------------------------------------------------------------------------
# Mamba-2 (the SSM family)
# ---------------------------------------------------------------------------
MAMBA = "mamba2-2.7b"
SSM_S = (16, 37)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def mamba(request):
    dtype = request.param
    jcfg = dataclasses.replace(jax_get_arch(MAMBA, smoke=True),
                               param_dtype=dtype)
    cfg = dataclasses.replace(get_arch(MAMBA, smoke=True), param_dtype=dtype)
    jmodel = jax_build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = LM(cfg, device="cpu").load_numpy(
        jax.tree.map(np.asarray, params))
    return dict(jmodel=jmodel, params=params, model=model, dtype=dtype,
                cfg=cfg, jcfg=jcfg)


def _toks(cfg, S, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)


def test_ssm_family_builds():
    """mamba2 is no longer a later family: it builds, draws the JAX
    layout (A_log, D, dt_bias in float32 in a bf16 model) and runs."""
    cfg = get_arch(MAMBA, smoke=True)
    jparams = jax_build_model(jax_get_arch(MAMBA, smoke=True)).init(
        jax.random.PRNGKey(0))
    bf16 = dataclasses.replace(cfg, param_dtype="bfloat16")
    model = LM(bf16, device="cpu").init(torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda x: tuple(x.shape), jparams)

    def tshapes(x):
        if isinstance(x, dict):
            return {k: tshapes(v) for k, v in x.items()}
        return tuple(x.shape)
    assert tshapes(model.params) == shapes
    mixer = model.params["stack"]["mixer"]
    assert mixer["w_in"].dtype == torch.bfloat16
    for k in SSM.FLOAT32_KEYS:
        assert mixer[k].dtype == torch.float32
    np.testing.assert_allclose(mixer["A_log"][0].numpy(),
                               np.log(np.linspace(1.0, 16.0, 8)), rtol=1e-6)
    assert model.param_count() == sum(
        x.size for x in jax.tree.leaves(jparams))
    assert torch.isfinite(model.forward(
        {"tokens": torch.zeros((1, 5), dtype=torch.int32)}).float()).all()


def test_ssm_params_carry_over_bit_for_bit(mamba):
    """A_log, D and dt_bias stay float32 in the bf16 variant, bit for bit
    (cast to bf16, A_log would move every decay rate); the weights take
    the config's dtype."""
    model, params = mamba["model"], mamba["params"]
    mixer, jmixer = model.params["stack"]["mixer"], params["stack"]["mixer"]
    for k in SSM.FLOAT32_KEYS:
        assert mixer[k].dtype == torch.float32
        np.testing.assert_array_equal(mixer[k].numpy(), np.asarray(jmixer[k]))
    assert mixer["w_in"].dtype == model.dtype
    np.testing.assert_array_equal(
        mixer["w_in"].float().numpy(),
        np.asarray(jmixer["w_in"].astype(jnp.float32)))


def test_lm_params_from_numpy_checks_ssm_keys(mamba):
    tree = jax.tree.map(np.asarray, mamba["params"])
    del tree["stack"]["mixer"]["A_log"]
    with pytest.raises(ValueError, match="A_log"):
        lm_params_from_numpy(mamba["cfg"], tree)
    tree = jax.tree.map(np.asarray, mamba["params"])
    tree["stack"]["ffn"] = {}
    with pytest.raises(ValueError, match="ffn"):
        lm_params_from_numpy(mamba["cfg"], tree)


@pytest.mark.parametrize("S", SSM_S)
def test_ssm_forward_matches_jax(mamba, S):
    toks = _toks(mamba["cfg"], S)
    jlogits, _ = mamba["jmodel"].forward(
        mamba["params"], {"tokens": jnp.asarray(toks)}, Ctx())
    logits = mamba["model"].forward({"tokens": torch.as_tensor(toks)})
    _close(logits, jlogits, mamba["dtype"])


@pytest.mark.parametrize("S", SSM_S)
def test_ssm_prefill_and_decode_match_jax(mamba, S):
    """prefill(pad_to=) logits and the ssm/conv caches, then three
    decode steps' logits and caches, against the JAX LM."""
    jmodel, params, model = mamba["jmodel"], mamba["params"], mamba["model"]
    cfg, dtype = mamba["cfg"], mamba["dtype"]
    toks = _toks(cfg, S)
    jl, jc = jmodel.prefill(params, {"tokens": jnp.asarray(toks)}, Ctx(),
                            pad_to=S + STEPS)
    logits, cache = make_prefill_step(model, pad_to=S + STEPS)(
        {"tokens": torch.as_tensor(toks)})
    _close(logits, jl, dtype)
    assert set(cache) == {"ssm", "conv"}
    assert cache["ssm"].dtype == torch.float32
    assert cache["conv"].dtype == model.dtype
    for name in ("ssm", "conv"):
        _close(cache[name], jc[name], dtype)
    rng = np.random.default_rng(2)
    decode = make_decode_step(model)
    for step in range(STEPS):
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        pos = np.full((B,), S + step, np.int32)
        jl, jc = jmodel.decode_step(params, jc, {"token": jnp.asarray(tok),
                                                 "pos": jnp.asarray(pos)},
                                    Ctx())
        nxt, logits, cache = decode(cache, {"token": torch.as_tensor(tok),
                                            "pos": torch.as_tensor(pos)})
        _close(logits, jl, dtype)
        for name in ("ssm", "conv"):
            _close(cache[name], jc[name], dtype)
        np.testing.assert_array_equal(nxt.numpy(),
                                      logits.argmax(-1).numpy())


@pytest.mark.parametrize("S", SSM_S)
def test_ssm_fwd_matches_the_jax_pallas_route(mamba, S):
    """One layer's Mamba-2 block against the JAX block's kernel route,
    ``ssm_fwd(use_pallas=True)`` (the Pallas kernel in interpret mode),
    which pads T to the chunk as the port does."""
    cfg, jcfg, params = mamba["cfg"], mamba["jcfg"], mamba["params"]
    jp = jax.tree.map(lambda x: x[0], params["stack"]["mixer"])
    rng = np.random.default_rng(3)
    h = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jh = jnp.asarray(h, params["embed"].dtype)
    jy, jstate = jax_ssm.ssm_fwd(jp, jh, Ctx(), jcfg, use_pallas=True,
                                 chunk=jcfg.ssd_chunk)
    p = layer_params(mamba["model"].params["stack"]["mixer"], 0)
    y, state = SSM.ssm_fwd(p, torch.as_tensor(h).to(mamba["model"].dtype),
                           cfg)
    _close(y, jy, mamba["dtype"])
    for name in ("ssm", "conv"):
        _close(state[name], jstate[name], mamba["dtype"])


def test_ssm_cache_passes_through_pad_to_unchanged(mamba):
    """pad_to grows k/v caches only: the SSM and conv states have no
    sequence dimension and come out of prefill(pad_to=) as they are."""
    model = mamba["model"]
    toks = torch.as_tensor(_toks(mamba["cfg"], 16))
    _, plain = model.prefill({"tokens": toks})
    _, padded = model.prefill({"tokens": toks}, pad_to=64)
    for name in ("ssm", "conv"):
        assert padded[name].shape == plain[name].shape
        torch.testing.assert_close(padded[name], plain[name], atol=0, rtol=0)


def test_ssm_fwd_conv_state_owns_its_memory(mamba):
    """The conv state a prefill layer returns is a (B, K-1, conv_dim)
    copy, not a view that keeps the whole padded input alive until the
    layers' caches are stacked (64 x 88 MB at the mamba2-2.7b prefill)."""
    cfg = mamba["cfg"]
    p = layer_params(mamba["model"].params["stack"]["mixer"], 0)
    h = torch.zeros((B, 37, cfg.d_model), dtype=mamba["model"].dtype)
    _, state = SSM.ssm_fwd(p, h, cfg)
    conv = state["conv"]
    assert conv.untyped_storage().nbytes() == \
        conv.numel() * conv.element_size()


def test_ssm_prefill_plus_decode_is_forward(mamba):
    """forward at position S-1 == prefill of S-1 tokens + one decode
    step of token S-1 (the port against itself)."""
    model, dtype = mamba["model"], mamba["dtype"]
    toks = _toks(mamba["cfg"], 21)
    full = model.forward({"tokens": torch.as_tensor(toks)})[:, -1]
    _, cache = model.prefill({"tokens": torch.as_tensor(toks[:, :-1])})
    logits, _ = model.decode_step(
        cache, {"token": torch.as_tensor(toks[:, -1:]),
                "pos": torch.full((B,), 20, dtype=torch.int32)})
    _close(logits, full.float().numpy(), dtype)


def test_ssm_cpu_path_launches_no_kernel(mamba):
    before = ssd_ops.LAUNCHES
    model = mamba["model"]
    _, cache = model.prefill({"tokens": torch.as_tensor(
        _toks(mamba["cfg"], 37))})
    model.decode_step(cache, {"token": torch.zeros((B, 1), dtype=torch.int32),
                              "pos": torch.full((B,), 37, dtype=torch.int32)})
    assert ssd_ops.LAUNCHES == before


def test_ssm_init_cache_layout():
    cfg = get_arch(MAMBA, smoke=True)
    cache = LM(cfg, device="cpu").init_cache(3, 40, torch.bfloat16)
    conv_dim = cfg.ssm_expand * cfg.d_model + 2 * cfg.ssm_state
    assert cache["ssm"].shape == (cfg.n_layers, 3, cfg.n_ssm_heads,
                                  cfg.ssm_state, cfg.ssm_headdim)
    assert cache["ssm"].dtype == torch.float32
    assert cache["conv"].shape == (cfg.n_layers, 3, cfg.ssm_conv - 1,
                                   conv_dim)
    assert cache["conv"].dtype == torch.bfloat16
    jcache = jax_build_model(jax_get_arch(MAMBA, smoke=True)).init_cache(
        3, 40)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
