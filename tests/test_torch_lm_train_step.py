"""One train step of the port (``repro_torch.models.make_train_step``)
against the JAX package's ``make_train_step`` for every smoke config,
and the reference's own step tests (``tests/test_steps.py``) on the
port: accumulation, the VLM's patch-masked loss, the MoE aux, a falling
loss on the synthetic stream.  The harness (JAX parameters carried over
by ``lm_params_from_numpy``, NumPy-drawn batches) is
``tests/test_torch_lm_train.py``'s.

Tolerances: loss and gnorm within rtol 1e-4 (float32 sums in another
order through two layers and the clip), lr within one float32 ulp, and
every parameter within 2 lr of JAX's: Adam's first step moves an
element by about lr whatever its gradient's size, so a gradient that
differs in its last bits may flip a tiny element's step (the criterion
of ``chip_smoke.py``'s training parities).  Accumulation: the
reference's own bounds (rtol 1e-5 on the loss; parameters atol 3e-5,
rtol 3e-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.steps import make_train_step as jax_make_train_step
from repro_torch.configs import ARCHS, get_arch
from repro_torch.data import TokenPipeline
from repro_torch.models import LM, make_loss_fn, make_train_step
from repro_torch.tree import tree_leaves, tree_map
from test_torch_lm_train import _batch, _np, _pair

torch.set_num_threads(1)


@pytest.mark.parametrize("name", list(ARCHS))
def test_train_step_matches_jax(name):
    """One step of every config's own optimizer, schedule and
    accumulation: llama3-405b-smoke's Adafactor with grad_accum 2,
    minicpm's WSD with tied embeddings, the rest AdamW + cosine."""
    jmodel, params, model, cfg = _pair(name)
    jb, tb = _batch(cfg, B_=4)
    jstep, jopt = jax_make_train_step(jmodel, total_steps=50, peak_lr=1e-2)
    step, opt = make_train_step(model, total_steps=50, peak_lr=1e-2)
    assert opt.name == jopt.name == cfg.optimizer
    jp, _, jm = jax.jit(jstep)(params, jopt.init(params), jb, jnp.asarray(3))
    before = tree_map(torch.clone, model.params)
    tp, ts, m = step(model.params, opt.init(model.params), tb, 3)
    assert set(m) == set(jm)
    for k in ("loss", "gnorm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                               rtol=2.0 ** -23)
    lr = float(m["lr"])
    for g, w in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert np.abs(_np(g) - _np(w)).max() <= 2 * lr
    moved = sum(float((a - b).abs().sum()) for a, b in zip(
        tree_leaves(tp), tree_leaves(before)))
    assert moved > 0


def test_grad_accum_matches_single_shot():
    """accum=2 equals accum=1 on the same global batch (float32), as
    the reference's test of its own step."""
    cfg = get_arch("deepseek-7b", smoke=True)
    model = LM(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    _, tb = _batch(cfg, B_=4, S_=16, seed=2)
    outs = {}
    for accum in (1, 2):
        m2 = LM(dataclasses.replace(cfg, grad_accum=accum), device="cpu")
        m2.params = model.params
        step, opt = make_train_step(m2)
        params = tree_map(torch.clone, model.params)   # updated in place
        p, _, m = step(params, opt.init(params), tb, 0)
        outs[accum] = (p, float(m["loss"]), float(m["ce"]))
    assert outs[1][1] == pytest.approx(outs[2][1], rel=1e-5)
    assert outs[1][2] == pytest.approx(outs[2][2], rel=1e-5)
    for a, b in zip(tree_leaves(outs[1][0]), tree_leaves(outs[2][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-5,
                                   rtol=3e-4)


def test_vlm_loss_masks_patch_positions():
    cfg = get_arch("internvl2-76b", smoke=True)
    model = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    _, tb = _batch(cfg, S_=12)
    loss_fn = make_loss_fn(model)
    loss, _ = loss_fn(model.params, tb)
    assert torch.isfinite(loss)
    # the patches feed attention, so they move the (text-only) loss
    loss2, _ = loss_fn(model.params, dict(tb, patches=tb["patches"] * 0))
    assert abs(float(loss) - float(loss2)) > 1e-6


def test_moe_aux_loss_reported_and_weighted():
    cfg = get_arch("olmoe-1b-7b", smoke=True)
    model = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    _, tb = _batch(cfg, S_=16)
    loss, metrics = make_loss_fn(model)(model.params, tb)
    assert float(metrics["aux"]) > 0
    assert float(loss) == pytest.approx(
        float(metrics["ce"]) + cfg.aux_loss_w * float(metrics["aux"]),
        rel=1e-6)


def test_loss_decreases_on_synthetic_stream():
    cfg = get_arch("internlm2-1.8b", smoke=True)
    model = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    step, opt = make_train_step(model, total_steps=60, peak_lr=3e-3)
    params, state = model.params, opt.init(model.params)
    pipe = TokenPipeline(batch=8, seq=32, vocab=cfg.vocab, seed=0)
    losses = []
    for i in range(40):
        batch = {k: torch.as_tensor(v) for k, v in pipe.get(i).items()}
        params, state, m = step(params, state, batch, i)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3
