"""The port's encoder-decoder family (``repro_torch.models.encdec`` and
``LM`` on whisper-smoke: 2 encoder and 2 decoder layers, d_model 64, 4
heads of 16, 8 stub frames) against the JAX package's, with the JAX
parameters carried over by ``lm_params_from_numpy``.

Frames are N(0, 1) x 0.1 and token ids uniform, both drawn with NumPy
from a seed.  Tolerances are the dense slice's (``tests/test_torch_lm.py``):
float32 atol = rtol = 2e-5 (the largest difference seen is ~1.5e-6 on
logits of magnitude ~4); bfloat16 atol 0.1, rtol 0.02 and a mean
absolute difference under 0.01 (both packages round every product,
norm and activation to bf16, not always at the same place; ~0.023 seen).
The sinusoid is held to 2e-6 plus two float32 ulps of its angle
(2.4e-7 x position): the frequencies are float32 exps from two
libraries, one ulp apart on some entries (22 of 192 at d = 384), and at
position 1458 that moves the rounded angle by two of its ulps, 1.2e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.registry import get_arch as jax_get_arch
from repro.models import encdec as jax_ed
from repro.models import layers as jax_layers
from repro.models.layers import Ctx
from repro.models.model import _pad_cache_seq as jax_pad_cache_seq
from repro.models.model import build_model as jax_build_model
from repro.serving import ContinuousBatcher as JaxBatcher
from repro.serving import synth_requests as jax_synth_requests
from repro_torch.configs import get_arch
from repro_torch.kernels.decode_gqa import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import LM, lm_params_from_numpy, make_decode_step
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models.model import _pad_cache_seq
from repro_torch.serving import ContinuousBatcher, synth_requests

torch.set_num_threads(1)
NAME = "whisper-tiny"
B, S, PAD, STEPS = 2, 12, 16, 3


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype):
    got = got.float().numpy()
    want = _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    else:
        np.testing.assert_allclose(got, want, atol=0.1, rtol=0.02)
        assert np.abs(got - want).mean() < 0.01


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    dtype = request.param
    jcfg = dataclasses.replace(jax_get_arch(NAME, smoke=True),
                               param_dtype=dtype)
    cfg = dataclasses.replace(get_arch(NAME, smoke=True), param_dtype=dtype)
    jmodel = jax_build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = LM(cfg, device="cpu").load_numpy(
        jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    frames = (rng.standard_normal((B, cfg.n_frames, cfg.d_model))
              * 0.1).astype(np.float32)
    return dict(jmodel=jmodel, params=params, model=model, toks=toks,
                frames=frames, dtype=dtype, cfg=cfg, jcfg=jcfg)


def _batch(pair, n=S):
    return ({"tokens": jnp.asarray(pair["toks"][:, :n]),
             "frames": jnp.asarray(pair["frames"])},
            {"tokens": torch.as_tensor(pair["toks"][:, :n]),
             "frames": torch.as_tensor(pair["frames"])})


def test_params_carry_over_bit_for_bit(pair):
    model, params = pair["model"], pair["params"]
    assert set(model.params) == {"embed", "final_norm", "enc", "dec",
                                 "enc_norm"}
    got = dict(_leaves(model.params))
    want = dict(_leaves(jax.tree.map(np.asarray, params)))
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].dtype == model.dtype, name
        np.testing.assert_array_equal(got[name].float().numpy(), _np(w),
                                      err_msg=name)
    assert model.param_count() == sum(x.size for x in jax.tree.leaves(params))


def test_encode_matches_jax(pair):
    frames = pair["frames"]
    dt = pair["model"].dtype
    want = jax_ed.encode(pair["params"], jnp.asarray(
        frames, pair["params"]["embed"].dtype), Ctx(), pair["jcfg"])
    got = ED.encode(pair["model"].params, torch.as_tensor(frames).to(dt),
                    pair["cfg"])
    assert got.dtype == dt
    _close(got, want, pair["dtype"])


def test_decode_fwd_matches_jax(pair):
    """The teacher-forced decoder pass and the cache it collects: the
    self K/V of the S tokens and the cross K/V of the encoder output."""
    params, model, cfg = pair["params"], pair["model"], pair["cfg"]
    rng = np.random.default_rng(5)
    enc = rng.standard_normal((B, cfg.n_frames, cfg.d_model)
                              ).astype(np.float32)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32) * 0.1
    jdt = params["embed"].dtype
    jx, jc = jax_ed.decode_fwd(params, jnp.asarray(x, jdt),
                               jnp.asarray(enc, jdt), Ctx(), pair["jcfg"],
                               collect_cache=True)
    tx, tc = ED.decode_fwd(model.params, torch.as_tensor(x).to(model.dtype),
                           torch.as_tensor(enc).to(model.dtype), cfg,
                           collect_cache=True)
    _close(tx, jx, pair["dtype"])
    for part, S_ in (("self", S), ("cross", cfg.n_frames)):
        for name in ("k", "v"):
            assert tc[part][name].shape == (cfg.n_layers, B, cfg.n_kv, S_,
                                            cfg.head_dim)
            assert tc[part][name].is_contiguous()
            _close(tc[part][name], jc[part][name], pair["dtype"])
    _, none = ED.decode_fwd(model.params, torch.as_tensor(x).to(model.dtype),
                            torch.as_tensor(enc).to(model.dtype), cfg)
    assert none is None


def test_forward_matches_jax(pair):
    jb, tb = _batch(pair)
    jlogits, jaux = pair["jmodel"].forward(pair["params"], jb, Ctx())
    logits, aux = pair["model"].forward(tb, with_aux=True)
    _close(logits, jlogits, pair["dtype"])
    assert aux.dtype == torch.float32 and float(aux) == float(jaux) == 0.0


def test_prefill_and_decode_match_jax(pair):
    jmodel, params, model = pair["jmodel"], pair["params"], pair["model"]
    dtype, cfg = pair["dtype"], pair["cfg"]
    jb, tb = _batch(pair)
    jl, jc = jmodel.prefill(params, jb, Ctx(), pad_to=PAD)
    logits, cache = model.prefill(tb, pad_to=PAD)
    _close(logits, jl, dtype)
    assert cache["self"]["k"].shape == jc["self"]["k"].shape == \
        (cfg.n_layers, B, cfg.n_kv, PAD, cfg.head_dim)
    assert cache["cross"]["k"].shape == jc["cross"]["k"].shape == \
        (cfg.n_layers, B, cfg.n_kv, cfg.n_frames, cfg.head_dim)
    rng = np.random.default_rng(2)
    decode = make_decode_step(model)
    for step in range(STEPS):
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        # row 1 rewrites positions it has already filled
        pos = np.array([S + step, S - 2 + step], np.int32)
        jl, jc = jmodel.decode_step(params, jc, {"token": jnp.asarray(tok),
                                                 "pos": jnp.asarray(pos)},
                                    Ctx())
        nxt, logits, cache = decode(cache, {"token": torch.as_tensor(tok),
                                            "pos": torch.as_tensor(pos)})
        _close(logits, jl, dtype)
        for part in ("self", "cross"):
            for name in ("k", "v"):
                _close(cache[part][name], jc[part][name], dtype)
        np.testing.assert_array_equal(nxt.numpy(),
                                      logits.argmax(-1).numpy())


def test_prefill_plus_decode_is_forward(pair):
    """forward at position S-1 == prefill of S-1 tokens + one decode
    step of token S-1 at position S-1 (the port against itself)."""
    model, toks, dtype = pair["model"], pair["toks"], pair["dtype"]
    _, tb = _batch(pair)
    full = model.forward(tb)[:, -1]
    _, cache = model.prefill(_batch(pair, S - 1)[1], pad_to=S)
    logits, _ = model.decode_step(
        cache, {"token": torch.as_tensor(toks[:, -1:]),
                "pos": torch.full((B,), S - 1, dtype=torch.int32)})
    _close(logits, full.float().numpy(), dtype)


def test_pad_cache_seq_leaves_cross_untouched(pair):
    """pad_to grows the self cache only; the cross cache keeps its
    n_frames slots and values, as the reference's ``_pad_cache_seq``
    skips every path through "cross"."""
    model = pair["model"]
    _, cache = model.prefill(_batch(pair)[1])
    padded = _pad_cache_seq(cache, 40)
    for name in ("k", "v"):
        assert padded["cross"][name] is cache["cross"][name]
        assert padded["self"][name].shape[3] == 40
        torch.testing.assert_close(padded["self"][name][:, :, :, :S],
                                   cache["self"][name], atol=0, rtol=0)
        assert not padded["self"][name][:, :, :, S:].any()
    jpad = jax_pad_cache_seq(jax.tree.map(
        lambda x: jnp.asarray(x.float().numpy()), cache), 40)
    assert jax.tree.map(lambda x: tuple(x.shape), jpad) == {
        part: {n: tuple(padded[part][n].shape) for n in ("k", "v")}
        for part in ("self", "cross")}


def test_cpu_path_launches_no_kernel(pair):
    before = (fa_ops.LAUNCHES, dec_ops.LAUNCHES)
    model = pair["model"]
    _, cache = model.prefill(_batch(pair)[1], pad_to=PAD)
    model.decode_step(cache, {"token": torch.zeros((B, 1), dtype=torch.int32),
                              "pos": torch.full((B,), S, dtype=torch.int32)})
    assert (fa_ops.LAUNCHES, dec_ops.LAUNCHES) == before


def test_gelu_mlp_is_the_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh approximation; the port's
    GELU MLP (no ``w_gate``) matches it, and torch's default exact erf
    would not."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3
    w_up = rng.standard_normal((16, 32)).astype(np.float32) * 0.5
    w_down = rng.standard_normal((32, 16)).astype(np.float32) * 0.2
    want = jax_layers.mlp_fwd({"w_up": jnp.asarray(w_up),
                               "w_down": jnp.asarray(w_down)},
                              jnp.asarray(x), Ctx())
    got = L.mlp_fwd({"w_up": torch.as_tensor(w_up),
                     "w_down": torch.as_tensor(w_down)}, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5, rtol=2e-5)
    h = torch.as_tensor(x)
    assert (F.gelu(h) - F.gelu(h, approximate="tanh")).abs().max() > 1e-4
    np.testing.assert_allclose(F.gelu(h, approximate="tanh").numpy(),
                               _np(jax.nn.gelu(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("S_,d", [(1500, 384), (7, 16), (3, 2)])
def test_sinusoid_matches_jax(S_, d):
    want = _np(jax_layers.sinusoidal_positions(S_, d))
    got = L.sinusoidal_positions(S_, d)
    assert got.dtype == torch.float32 and got.shape == (S_, d)
    bound = 2e-6 + 2.4e-7 * np.arange(S_)[:, None]
    assert (np.abs(got.numpy() - want) <= bound).all()
    # the decode step's per-row sinusoid at absolute positions
    pos = np.array([0, S_ // 2, S_ - 1], np.int32)
    got = L.sinusoid(torch.as_tensor(pos), d).numpy()
    assert (np.abs(got - want[pos]) <= bound[pos]).all()


def test_init_draws_the_jax_layout():
    cfg = get_arch(NAME, smoke=True)
    jparams = jax_build_model(jax_get_arch(NAME, smoke=True)).init(
        jax.random.PRNGKey(0))
    model = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in _leaves(model.params)} == \
        {k: tuple(np.shape(v)) for k, v in _leaves(jparams)}
    assert torch.isfinite(model.forward(
        {"tokens": torch.zeros((1, 4), dtype=torch.int32),
         "frames": torch.zeros((1, cfg.n_frames, cfg.d_model))})).all()


def test_init_cache_layout():
    cfg = get_arch(NAME, smoke=True)
    cache = LM(cfg, device="cpu").init_cache(3, 40, torch.bfloat16)
    jcache = jax_build_model(jax_get_arch(NAME, smoke=True)).init_cache(
        3, 40)
    assert {p: {n: tuple(v.shape) for n, v in c.items()}
            for p, c in cache.items()} == \
        jax.tree.map(lambda x: tuple(x.shape), jcache)
    assert cache["self"]["k"].dtype == torch.bfloat16
    assert not cache["cross"]["v"].any()


def test_lm_params_from_numpy_checks_encdec_keys(pair):
    cfg = pair["cfg"]
    tree = jax.tree.map(np.asarray, pair["params"])
    del tree["dec"]["cross"]["wq"]
    with pytest.raises(ValueError, match="dec.cross"):
        lm_params_from_numpy(cfg, tree)
    tree = jax.tree.map(np.asarray, pair["params"])
    tree["enc"]["norm3"] = tree["enc"]["norm2"]
    with pytest.raises(ValueError, match="enc params"):
        lm_params_from_numpy(cfg, tree)
    tree = jax.tree.map(np.asarray, pair["params"])
    tree["lm_head"] = tree["embed"].T
    with pytest.raises(ValueError, match="lm_head"):
        lm_params_from_numpy(cfg, tree)


def test_batcher_streams_match_jax_on_a_zero_cross_cache():
    """The reference batcher passes no frames: an encdec model in it
    attends to the zero cross cache of ``init_cache``.  The port keeps
    that behaviour, and the token streams are equal (float32)."""
    jmodel = jax_build_model(jax_get_arch(NAME, smoke=True))
    params = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_arch(NAME, smoke=True)
    model = LM(cfg, device="cpu").load_numpy(jax.tree.map(np.asarray, params))

    def reqs(synth):
        return synth([cfg.name], n=4, horizon_us=100.0,
                     qos_budget_us={cfg.name: 1e9}, vocab=cfg.vocab,
                     prompt_len=4, max_new=5, seed=3)

    def serve(batcher, rs):
        pending, done = list(rs), []
        while pending or batcher.active():
            while pending and batcher.has_free_slot():
                batcher.add(pending.pop(0))
            done += batcher.step()
        return done

    jdone = serve(JaxBatcher(jmodel, params, n_slots=2, smax=32),
                  reqs(jax_synth_requests))
    batcher = ContinuousBatcher(model, n_slots=2, smax=32)
    assert set(batcher.cache) == {"self", "cross"}
    done = serve(batcher, reqs(synth_requests))
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for r, jr in zip(done, jdone):
        assert r.tokens_out == jr.tokens_out, r.rid
    assert not batcher.cache["cross"]["k"].any()
