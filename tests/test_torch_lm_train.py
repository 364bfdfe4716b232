"""The loss and gradients of LM training in the port
(``repro_torch.models.steps``) against the JAX package's
``repro.models.steps`` on the smoke configs, with the JAX parameters
carried over by ``lm_params_from_numpy`` and NumPy-drawn batches; the
autograd route of the two kernels on the training path
(``flash_attention``, ``ssd_intra``) on the CPU; remat.  The train step
itself is ``tests/test_torch_lm_train_step.py``.

Tolerances:
- the kernels' backward (``attention_chunked_vjp``, ``ssd_intra_vjp``)
  against autograd through the plain versions, float32: 1e-6 (the same
  products, per block);
- ``make_loss_fn``: ``ce``, ``aux``, ``zloss`` and the loss within
  2e-5 (float32 sums in another order over a 512-wide vocab), every
  leaf's gradient against ``jax.grad`` within atol 1e-5, rtol 1e-4;
- remat on against off in the port: bit for bit (the same arithmetic,
  recomputed).
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
from repro.models.steps import make_loss_fn as jax_make_loss_fn
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.kernels.ssd_chunk import ref as ssd_ref
from repro_torch.models import LM, make_loss_fn
from repro_torch.models.steps import value_and_grad
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)
FAMILY_ARCHS = ["internlm2-1.8b", "olmoe-1b-7b", "mamba2-2.7b",
                "jamba-v0.1-52b", "whisper-tiny", "internvl2-76b"]
B, S = 2, 32               # S a multiple of the SSM smoke configs' chunk


# ------------------------------------------------------- kernel autograd
def _attn_inputs(B_, Hq, Hkv, Sq, Sk, D, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32))
    return f(B_, Hq, Sq, D), f(B_, Hkv, Sk, D), f(B_, Hkv, Sk, D), \
        f(B_, Hq, Sq, D)


@pytest.mark.parametrize("B_,Hq,Hkv,Sq,Sk,D,causal,window", [
    (2, 4, 4, 40, 40, 16, True, 0),          # causal MHA
    (1, 4, 2, 37, 37, 16, True, 8),          # window, GQA group 2
    (2, 6, 3, 24, 24, 8, True, 0),           # GQA group 2
    (2, 4, 2, 9, 30, 16, False, 0),          # cross: Sq != Sk
    (1, 2, 1, 600, 600, 8, True, 0)])        # two query blocks
def test_flash_attention_gradient_is_the_plain_gradient(B_, Hq, Hkv, Sq, Sk,
                                                        D, causal, window):
    q, k, v, do = _attn_inputs(B_, Hq, Hkv, Sq, Sk, D)
    before = fa_ops.LAUNCHES
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa_ops.flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(out, leaves, do)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = fa_ref.attention_chunked(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(ref, leaves, do)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)
    assert fa_ops.LAUNCHES == before        # the CPU runs no kernel


def test_flash_attention_gradient_in_bf16_comes_back_in_bf16():
    """bf16 inputs: the float32 gradient of ``attention_chunked`` at the
    same (bf16-valued) inputs, rounded once to bf16; dk and dv are
    summed over the query blocks and the GQA group in float32 first:
    within one bf16 ulp of it (float32 sums in another order may round
    to the neighbour)."""
    q, k, v, do = _attn_inputs(1, 4, 2, 600, 600, 16, seed=1)
    leaves = [t.to(torch.bfloat16).requires_grad_() for t in (q, k, v)]
    do = do.to(torch.bfloat16)
    got = torch.autograd.grad(fa_ops.flash_attention(*leaves), leaves, do)
    ref_leaves = [t.detach().float().requires_grad_() for t in leaves]
    want = torch.autograd.grad(fa_ref.attention_chunked(*ref_leaves),
                               ref_leaves, do.float())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g, w.to(torch.bfloat16), atol=0,
                                   rtol=2.0 ** -7)     # one bf16 ulp


@pytest.mark.parametrize("BC,C,N,H,P", [(3, 16, 8, 5, 16), (20, 32, 16, 3, 8)])
def test_ssd_intra_gradient_is_the_plain_gradient(BC, C, N, H, P):
    rng = np.random.default_rng(2)
    f = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32))
    la = -np.abs(rng.standard_normal((BC, H, C))).astype(np.float32) * 0.3
    args = [f(BC, C, N), f(BC, C, N), f(BC, H, C, P),
            torch.as_tensor(np.cumsum(la, -1))]
    dy = f(BC, H, C, P)
    before = ssd_ops.LAUNCHES
    leaves = [a.clone().requires_grad_() for a in args]
    got = torch.autograd.grad(ssd_ops.ssd_intra(*leaves), leaves, dy)
    leaves = [a.clone().requires_grad_() for a in args]
    want = torch.autograd.grad(ssd_ref.ssd_intra_ref(*leaves), leaves, dy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)
    assert ssd_ops.LAUNCHES == before


# ---------------------------------------------------------- LM harness
def _pair(name, **replace):
    jcfg = dataclasses.replace(jax_get_arch(name, smoke=True), **replace)
    cfg = dataclasses.replace(get_arch(name, smoke=True), **replace)
    jmodel = jax_build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = LM(cfg, device="cpu").load_numpy(jax.tree.map(np.asarray,
                                                          params))
    return jmodel, params, model, cfg


def _batch(cfg, B_=B, S_=S, seed=1):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B_, S_)).astype(np.int32)}
    if cfg.family == "encdec":
        b["frames"] = (rng.standard_normal((B_, cfg.n_frames, cfg.d_model))
                       * 0.1).astype(np.float32)
    if cfg.family == "vlm":
        b["patches"] = rng.standard_normal(
            (B_, cfg.n_patches, cfg.vit_dim)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.as_tensor(v) for k, v in b.items()})


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("variant", ["plain", "zloss-remat"])
@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_loss_and_gradients_match_jax(name, variant):
    extra = dict(zloss=1e-3, remat=True) if variant == "zloss-remat" else {}
    jmodel, params, model, cfg = _pair(name, **extra)
    jb, tb = _batch(cfg)
    jloss_fn = jax_make_loss_fn(jmodel)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jloss_fn(p, jb, Ctx()), has_aux=True)(params)
    loss, met, grads = value_and_grad(make_loss_fn(model), model.params, tb)
    assert set(met) == set(jmet)
    assert ("aux" in met) == cfg.is_moe and ("zloss" in met) == bool(extra)
    np.testing.assert_allclose(float(loss), float(jloss), atol=2e-5,
                               rtol=2e-5)
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), atol=2e-5,
                                   rtol=2e-5)
    g_leaves, j_leaves = tree_leaves(grads), jax.tree.leaves(jgrads)
    assert len(g_leaves) == len(j_leaves)
    for g, w in zip(g_leaves, j_leaves):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("name", ["internlm2-1.8b", "jamba-v0.1-52b",
                                  "whisper-tiny"])
def test_remat_recomputes_each_unit_once(name, monkeypatch):
    """With ``remat`` every attention layer's forward runs twice a step
    (forward, and its recompute in the backward), as the reference's
    ``jax.checkpoint``; the gradients are those without remat, bit for
    bit.  Serving (no autograd) recomputes nothing."""
    calls = []
    plain = fa_ops.attention_chunked
    monkeypatch.setattr(fa_ops, "attention_chunked",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    cfg = get_arch(name, smoke=True)
    n_attn = (cfg.enc_layers + 2 * cfg.n_layers if cfg.family == "encdec"
              else cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
              else cfg.n_layers)
    model = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    _, tb = _batch(cfg)
    grads = {}
    for remat in (False, True):
        m = LM(dataclasses.replace(cfg, remat=remat), device="cpu")
        calls.clear()
        _, _, grads[remat] = value_and_grad(make_loss_fn(m), model.params,
                                            tb)
        assert len(calls) == n_attn * (2 if remat else 1)
        calls.clear()
        with torch.no_grad():
            m.forward(tb, params=model.params)
        assert len(calls) == n_attn
    for a, b in zip(tree_leaves(grads[False]), tree_leaves(grads[True])):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
