"""The port's VLM family (``LM`` on internvl2-smoke: a projected
patch-embedding prefix before a dense decoder, the vision tower a stub
in the reference too) against the JAX package's, with the JAX
parameters carried over by ``lm_params_from_numpy``.  Tokens and the
stub patches (N(0, 1), as the reference's smoke tests draw them) are
drawn with NumPy from a seed.

The sequence is n_patches + S_txt long and positions run over all of
it, so the first decode position after a prefill is n_patches + S_txt.
Decode is text only, as in the dense family, and so is the batcher,
which passes no patches in the reference either.

Tolerances, as ``tests/test_torch_lm.py`` (the comparison is
``tests/test_torch_moe.py``'s): float32 atol = rtol = 2e-5; bfloat16
``LM_TOL`` (atol 0.1, rtol 0.02, mean 0.01).
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
from repro.serving import ContinuousBatcher as JaxBatcher
from repro.serving import synth_requests as jax_synth_requests
from repro_torch.configs import get_arch
from repro_torch.kernels.decode_gqa import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import (LM, lm_params_from_numpy, make_decode_step,
                                make_prefill_step)
from repro_torch.serving import ContinuousBatcher, synth_requests
from test_torch_moe import _close

torch.set_num_threads(1)
NAME = "internvl2-76b"
B, S_TXT, STEPS = 2, 8, 3


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
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S_TXT)
                                    ).astype(np.int32),
             "patches": rng.standard_normal(
                 (B, cfg.n_patches, cfg.vit_dim)).astype(np.float32)}
    return dict(jmodel=jmodel, params=params, model=model, batch=batch,
                dtype=dtype, cfg=cfg)


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_params_carry_over_with_the_projector(pair):
    model, params = pair["model"], pair["params"]
    cfg = pair["cfg"]
    assert model.param_count() == sum(x.size for x in
                                      jax.tree.leaves(params))
    w = model.params["patch_proj"]
    assert w.shape == (cfg.vit_dim, cfg.d_model) and w.dtype == model.dtype
    np.testing.assert_array_equal(
        w.float().numpy(),
        np.asarray(params["patch_proj"].astype(jnp.float32)))


def test_forward_matches_jax(pair):
    """Logits over the patch prefix and the text, and a float32 0 aux."""
    jlogits, jaux = pair["jmodel"].forward(pair["params"],
                                           _jax(pair["batch"]), Ctx())
    logits, aux = pair["model"].forward(_torch(pair["batch"]),
                                        with_aux=True)
    cfg = pair["cfg"]
    assert logits.shape == (B, cfg.n_patches + S_TXT, cfg.vocab_padded)
    _close(logits, jlogits, pair["dtype"])
    assert aux.dtype == torch.float32 and float(aux) == float(jaux) == 0.0


def test_the_prefix_is_the_projected_patches(pair):
    """Only the patches reach the prefix's positions: other patches move
    every logit from position 0, other text leaves the prefix's logits
    as they are (causal attention)."""
    model, batch = pair["model"], pair["batch"]
    n = pair["cfg"].n_patches
    base = model.forward(_torch(batch))
    other_text = dict(batch, tokens=(batch["tokens"] + 1) % 100)
    torch.testing.assert_close(model.forward(_torch(other_text))[:, :n],
                               base[:, :n], atol=0, rtol=0)
    other_patches = dict(batch, patches=batch["patches"] * 2.0)
    assert (model.forward(_torch(other_patches))[:, 0] != base[:, 0]).any()


def test_prefill_and_decode_match_jax(pair):
    """prefill(pad_to=) logits and the k/v cache over the whole
    sequence, then text decode steps from position n_patches + S_txt,
    against the JAX LM."""
    jmodel, params, model = pair["jmodel"], pair["params"], pair["model"]
    cfg, dtype = pair["cfg"], pair["dtype"]
    S = cfg.n_patches + S_TXT
    pad = S + STEPS
    jl, jc = jmodel.prefill(params, _jax(pair["batch"]), Ctx(), pad_to=pad)
    logits, cache = make_prefill_step(model, pad_to=pad)(
        _torch(pair["batch"]))
    _close(logits, jl, dtype)
    assert cache["k"].shape == jc["k"].shape == (
        cfg.n_layers, B, cfg.n_kv, pad, cfg.head_dim)
    for name in ("k", "v"):
        _close(cache[name], jc[name], dtype)
    rng = np.random.default_rng(2)
    decode = make_decode_step(model)
    for step in range(STEPS):
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        pos = np.full((B,), S + step, np.int32)
        jl, jc = jmodel.decode_step(params, jc, _jax({"token": tok,
                                                      "pos": pos}), Ctx())
        nxt, logits, cache = decode(cache, _torch({"token": tok,
                                                   "pos": pos}))
        _close(logits, jl, dtype)
        for name in ("k", "v"):
            _close(cache[name], jc[name], dtype)
        np.testing.assert_array_equal(nxt.numpy(),
                                      logits.argmax(-1).numpy())


def test_prefill_plus_decode_is_forward(pair):
    """The reference's test_decode_parity on the port: forward at the
    last text position == prefill of the patches and all but the last
    token, then one decode step at position n_patches + S_txt - 1."""
    model, batch, dtype = pair["model"], pair["batch"], pair["dtype"]
    n = pair["cfg"].n_patches
    full = model.forward(_torch(batch))[:, -1]
    _, cache = model.prefill(_torch(dict(batch,
                                         tokens=batch["tokens"][:, :-1])),
                             pad_to=n + S_TXT + 4)
    logits, _ = model.decode_step(
        cache, {"token": torch.as_tensor(batch["tokens"][:, -1:]),
                "pos": torch.full((B,), n + S_TXT - 1, dtype=torch.int32)})
    _close(logits, full.float().numpy(), dtype)


def test_cpu_path_launches_no_kernel(pair):
    before = (fa_ops.LAUNCHES, dec_ops.LAUNCHES)
    model = pair["model"]
    S = pair["cfg"].n_patches + S_TXT
    _, cache = model.prefill(_torch(pair["batch"]), pad_to=S + 1)
    model.decode_step(cache, {"token": torch.zeros((B, 1), dtype=torch.int32),
                              "pos": torch.full((B,), S, dtype=torch.int32)})
    assert (fa_ops.LAUNCHES, dec_ops.LAUNCHES) == before


def test_init_draws_the_jax_layout():
    cfg = dataclasses.replace(get_arch(NAME, smoke=True),
                              param_dtype="bfloat16")
    jparams = jax_build_model(jax_get_arch(NAME, smoke=True)).init(
        jax.random.PRNGKey(0))
    model = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))

    def tshapes(x):
        if isinstance(x, dict):
            return {k: tshapes(v) for k, v in x.items()}
        return tuple(x.shape)
    assert tshapes(model.params) == jax.tree.map(lambda x: tuple(x.shape),
                                                 jparams)
    w = model.params["patch_proj"]
    assert w.dtype == torch.bfloat16
    assert w.float().abs().max() <= 2 * cfg.vit_dim ** -0.5 + 1e-6
    rng = np.random.default_rng(0)
    logits = model.forward({
        "tokens": torch.zeros((1, 3), dtype=torch.int32),
        "patches": torch.as_tensor(rng.standard_normal(
            (1, cfg.n_patches, cfg.vit_dim)).astype(np.float32))})
    assert logits.shape == (1, cfg.n_patches + 3, cfg.vocab_padded)
    assert torch.isfinite(logits.float()).all()


def test_init_cache_is_the_dense_layout():
    cfg = get_arch(NAME, smoke=True)
    cache = LM(cfg, device="cpu").init_cache(3, 40, torch.bfloat16)
    jcache = jax_build_model(jax_get_arch(NAME, smoke=True)).init_cache(
        3, 40)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()} == \
        {k: (cfg.n_layers, 3, cfg.n_kv, 40, cfg.head_dim) for k in "kv"}


def test_lm_params_from_numpy_wants_the_projector(pair):
    tree = jax.tree.map(np.asarray, pair["params"])
    del tree["patch_proj"]
    with pytest.raises(ValueError, match="patch_proj"):
        lm_params_from_numpy(pair["cfg"], tree)
    dense = get_arch("internlm2-1.8b", smoke=True)
    tree = jax.tree.map(np.asarray, pair["params"])
    with pytest.raises(ValueError, match="patch_proj"):
        lm_params_from_numpy(dataclasses.replace(
            pair["cfg"], family=dense.family), tree)


def test_batcher_streams_match_jax():
    """internvl2-smoke in float32 through both batchers: six text-only
    requests over two slots, equal token streams."""
    jmodel = jax_build_model(jax_get_arch(NAME, smoke=True))
    params = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_arch(NAME, smoke=True)
    model = LM(cfg, device="cpu").load_numpy(jax.tree.map(np.asarray, params))

    def reqs(synth):
        return synth([cfg.name], n=6, horizon_us=100.0,
                     qos_budget_us={cfg.name: 1e9}, vocab=cfg.vocab,
                     prompt_len=5, max_new=6, seed=3)

    def serve(batcher, rs):
        pending, done = list(rs), []
        while pending or batcher.active():
            while pending and batcher.has_free_slot():
                batcher.add(pending.pop(0))
            done += batcher.step()
        return done

    jdone = serve(JaxBatcher(jmodel, params, n_slots=2, smax=64),
                  reqs(jax_synth_requests))
    done = serve(ContinuousBatcher(model, n_slots=2, smax=64),
                 reqs(synth_requests))
    assert len(done) == len(jdone) == 6
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for r, jr in zip(done, jdone):
        assert r.tokens_out == jr.tokens_out, r.rid
