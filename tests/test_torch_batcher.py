"""The port's ``ContinuousBatcher`` against the JAX package's on the
internlm2 and mamba2 smoke models in float32, with the JAX parameters
carried over.

Both packages draw the requests with the same NumPy ``synth_requests``
code and seed.  Expected: the same ``tokens_out`` for every request,
including requests that land in a slot another request has freed.  The
greedy ids are compared exactly: in float32 the two packages' logits
differ by ~2e-6 (``tests/test_torch_lm.py``), and the smallest top-2
gap met on these streams is far larger (checked below).

Mamba-2 streams depend on the slots' history in both packages: a
slot's SSM and conv state are not reset for a new request, and while
``add`` feeds a prompt every other slot re-runs its last token, which
advances its state once more.  The port keeps that behaviour, so the
streams are still equal token for token.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.models.model import build_model as jax_build_model
from repro.serving import ContinuousBatcher as JaxBatcher
from repro.serving import synth_requests as jax_synth_requests
from repro_torch.configs import get_arch
from repro_torch.models import LM
from repro_torch.serving import ContinuousBatcher, Request, synth_requests

torch.set_num_threads(1)
NAME = "internlm2-1.8b"


MAMBA = "mamba2-2.7b"


def _build(name):
    jmodel = jax_build_model(jax_get_arch(name, smoke=True))
    params = jmodel.init(jax.random.PRNGKey(0))
    model = LM(get_arch(name, smoke=True), device="cpu").load_numpy(
        jax.tree.map(np.asarray, params))
    return jmodel, params, model


@pytest.fixture(scope="module")
def models():
    return _build(NAME)


@pytest.fixture(scope="module")
def mamba_models():
    return _build(MAMBA)


def _serve(batcher, reqs, max_steps=400):
    pending, done = list(reqs), []
    for _ in range(max_steps):
        while pending and batcher.has_free_slot():
            batcher.add(pending.pop(0))
        done += batcher.step()
        if not pending and batcher.active() == 0:
            break
    return done


def _reqs(synth, vocab, seed, max_new, name=NAME):
    return synth([name], n=6, horizon_us=100.0, qos_budget_us={name: 1e9},
                 vocab=vocab, prompt_len=5, max_new=max_new, seed=seed)


@pytest.mark.parametrize("n_slots,smax,max_new", [(2, 64, 6), (3, 24, 12)])
def test_tokens_out_match_jax(models, n_slots, smax, max_new):
    """Six requests through 2 or 3 slots: slots are reused; with smax 24
    requests also end at the cache's end (pos >= smax - 1)."""
    jmodel, params, model = models
    vocab = model.cfg.vocab
    jreqs = _reqs(jax_synth_requests, vocab, 3, max_new)
    reqs = _reqs(synth_requests, vocab, 3, max_new)
    assert [r.prompt.tolist() for r in reqs] == \
        [r.prompt.tolist() for r in jreqs]
    jdone = _serve(JaxBatcher(jmodel, params, n_slots=n_slots, smax=smax),
                   jreqs)
    batcher = ContinuousBatcher(model, n_slots=n_slots, smax=smax)
    done = _serve(batcher, reqs)
    assert len(done) == len(jdone) == 6
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for r, jr in zip(done, jdone):
        assert r.tokens_out == jr.tokens_out, r.rid
    assert batcher.active() == 0 and batcher.has_free_slot()


def test_greedy_margins_exceed_the_float32_gap(models):
    """The top-2 gap of every greedy pick on the stream above is far
    above the ~2e-6 float32 difference between the packages."""
    _, _, model = models
    reqs = _reqs(synth_requests, model.cfg.vocab, 3, 6)
    batcher = ContinuousBatcher(model, n_slots=2, smax=64)
    gaps, in_step = [], [False]
    inner_step, outer_step = batcher._step, batcher.step

    def spy():                 # the logits whose argmax a request keeps
        tok, logits = inner_step()
        if in_step[0]:
            rows = [i for i, s in enumerate(batcher.slots) if s.req]
            top2 = torch.topk(logits[rows].float(), 2, dim=-1).values
            gaps.extend((top2[:, 0] - top2[:, 1]).tolist())
        return tok, logits

    def step():
        in_step[0] = True
        try:
            return outer_step()
        finally:
            in_step[0] = False
    batcher._step, batcher.step = spy, step
    assert len(_serve(batcher, reqs)) == 6
    assert min(gaps) > 1e-4


def test_slot_reuse_is_isolated(models):
    """A request decoded alone equals the same request decoded after
    another request has used and freed its slot."""
    _, _, model = models

    def run(batcher):
        r = Request(rid=0, tenant="x", arrival_us=0, deadline_us=1e9,
                    prompt=np.arange(4, dtype=np.int32), max_new=4)
        batcher.add(r)
        while batcher.active():
            batcher.step()
        return r.tokens_out

    solo = run(ContinuousBatcher(model, n_slots=2, smax=64))
    churn = ContinuousBatcher(model, n_slots=2, smax=64)
    warm = Request(rid=9, tenant="x", arrival_us=0, deadline_us=1e9,
                   prompt=np.ones(3, np.int32), max_new=2)
    churn.add(warm)
    while churn.active():
        churn.step()
    assert run(churn) == solo


@pytest.mark.parametrize("n_slots,smax,max_new", [(2, 64, 6), (3, 24, 12)])
def test_mamba2_tokens_out_match_jax(mamba_models, n_slots, smax, max_new):
    """The same six requests on the mamba2 smoke model: equal streams,
    slot reuse (and its carried-over state) included, with every greedy
    pick's top-2 gap far above the float32 difference."""
    jmodel, params, model = mamba_models
    vocab = model.cfg.vocab
    jreqs = _reqs(jax_synth_requests, vocab, 3, max_new, MAMBA)
    reqs = _reqs(synth_requests, vocab, 3, max_new, MAMBA)
    jdone = _serve(JaxBatcher(jmodel, params, n_slots=n_slots, smax=smax),
                   jreqs)
    batcher = ContinuousBatcher(model, n_slots=n_slots, smax=smax)
    gaps, inner = [], batcher._step

    def spy():
        tok, logits = inner()
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        gaps.extend((top2[:, 0] - top2[:, 1]).tolist())
        return tok, logits
    batcher._step = spy
    done = _serve(batcher, reqs)
    assert len(done) == len(jdone) == 6
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for r, jr in zip(done, jdone):
        assert r.tokens_out == jr.tokens_out, r.rid
    assert min(gaps) > 1e-4


def test_mamba2_slot_state_carries_over(mamba_models):
    """The reference behaviour the port keeps: a request decoded in a
    slot another request has used starts from that request's state, so
    its stream can differ from the same request decoded alone; with a
    cache reset to zeros in between it is the solo stream again."""
    _, _, model = mamba_models

    def run(batcher):
        r = Request(rid=0, tenant="x", arrival_us=0, deadline_us=1e9,
                    prompt=np.arange(4, dtype=np.int32), max_new=6)
        batcher.add(r)
        while batcher.active():
            batcher.step()
        return r.tokens_out, batcher.cache["ssm"].clone()

    solo, solo_state = run(ContinuousBatcher(model, n_slots=1, smax=64))
    churn = ContinuousBatcher(model, n_slots=1, smax=64)
    warm = Request(rid=9, tenant="x", arrival_us=0, deadline_us=1e9,
                   prompt=np.full(3, 7, np.int32), max_new=4)
    churn.add(warm)
    while churn.active():
        churn.step()
    _, carried = run(churn)
    assert not torch.equal(carried, solo_state)
    for v in churn.cache.values():
        v.zero_()
    again, state = run(churn)
    assert again == solo
    torch.testing.assert_close(state, solo_state, atol=0, rtol=0)
