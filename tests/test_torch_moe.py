"""The port's MoE FFN (``repro_torch.models.moe``) and MoE family (``LM``
on olmoe-smoke: 8 experts, top-2; mixtral-smoke: 4 experts, top-2, a
32-token sliding window) against the JAX package's, with the JAX
parameters carried over by ``lm_params_from_numpy`` (the router stays
float32 in a bf16 model).  Inputs are drawn with NumPy from a seed.

Tolerances:
- ``moe_fwd`` on the same inputs: float32 atol = rtol = 2e-5, aux 1e-6
  (the same arithmetic in another summation order); bfloat16 atol =
  rtol = 1.6e-2 (two bf16 ulps below 1: each expert product is rounded
  to bf16 once from float32 sums in another order).  The combine adds
  a token's k outputs one by one in ascending expert order, the order
  of the reference's scatter-add, so it costs nothing beyond that.
- The dispatch, the slot of every assignment and so the set of dropped
  assignments, is compared exactly.
- The models: float32 as the dense slice (2e-5); bfloat16 as the dense
  slice (atol 0.1, rtol 0.02, mean 0.01) on every (row, position) whose
  routing cannot have flipped.  In bf16 the two packages' hidden states
  differ by bf16 ulps, so their float32 router logits differ by up to
  ~1e-2, and a token whose k-th and (k+1)-th logits are closer than
  that may pick another expert in one package.  Both packages' routes
  are recorded (the JAX one through a debug callback): a (row,
  position) is exempt when a route flipped there or at an earlier
  position of its row, in this call or an earlier one feeding the
  cache, and every flip must be a near-tie, the port's k-th and
  (k+1)-th logits within ``ROUTE_MARGIN`` = 0.05.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.models import moe as jax_moe
from repro.models.layers import Ctx
from repro.models.model import build_model as jax_build_model
from repro.serving import ContinuousBatcher as JaxBatcher
from repro.serving import synth_requests as jax_synth_requests
from repro_torch.configs import get_arch
from repro_torch.kernels.decode_gqa import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import LM, lm_params_from_numpy, make_decode_step
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.serving import ContinuousBatcher, synth_requests

torch.set_num_threads(1)
NAMES = ["olmoe-1b-7b", "mixtral-8x7b"]
B, S, PAD, STEPS = 2, 12, 16, 3
ROUTE_MARGIN = 0.05
FWD_TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
           "bfloat16": dict(atol=1.6e-2, rtol=1.6e-2)}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _moe_params(d, f, E, dtype, rng):
    router = (rng.standard_normal((d, E)) * d ** -0.5).astype(np.float32)
    w = {k: (rng.standard_normal(s) * s[1] ** -0.5).astype(np.float32)
         for k, s in (("w_gate", (E, d, f)), ("w_up", (E, d, f)),
                      ("w_down", (E, f, d)))}
    jp = {"router": jnp.asarray(router)}
    jp.update({k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in w.items()})
    tp = {"router": torch.as_tensor(router)}
    tp.update({k: torch.as_tensor(v).to(getattr(torch, dtype))
               for k, v in w.items()})
    return jp, tp


# ---------------------------------------------------------------------------
# the FFN
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bx,Sx,d,f,E,k,cf", [
    (2, 16, 32, 24, 8, 2, 1.25), (3, 5, 16, 8, 4, 2, 1.25),
    (4, 1, 32, 16, 64, 8, 1.25),          # a decode step: C = 8, all run
    (2, 40, 16, 16, 8, 2, 0.5)])          # tight capacity: many drops
def test_moe_fwd_matches_jax(Bx, Sx, d, f, E, k, cf, dtype):
    rng = np.random.default_rng(0)
    jp, tp = _moe_params(d, f, E, dtype, rng)
    x = rng.standard_normal((Bx, Sx, d)).astype(np.float32)
    jout, jaux = jax_moe.moe_fwd(jp, jnp.asarray(x, getattr(jnp, dtype)),
                                 Ctx(), top_k=k, capacity_factor=cf)
    out, aux = MOE.moe_fwd(tp, torch.as_tensor(x).to(getattr(torch, dtype)),
                           top_k=k, capacity_factor=cf)
    assert out.dtype == getattr(torch, dtype) and out.shape == x.shape
    np.testing.assert_allclose(out.float().numpy(), _np(jout),
                               **FWD_TOL[dtype])
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=1e-6)


def test_moe_fwd_without_aux_spends_nothing_on_it(monkeypatch):
    """Decode and prefill ask for no aux: the same output, None for the
    aux, and the load-balancing loss never computed."""
    rng = np.random.default_rng(0)
    _, tp = _moe_params(16, 8, 4, "float32", rng)
    x = torch.as_tensor(rng.standard_normal((2, 5, 16)).astype(np.float32))
    want, _ = MOE.moe_fwd(tp, x, top_k=2)
    monkeypatch.setattr(MOE, "load_balance", None)
    got, aux = MOE.moe_fwd(tp, x, top_k=2, with_aux=False)
    assert aux is None
    assert torch.equal(got, want)


def _jax_slots(x, eidx, E, C):
    """The reference dispatch's slot of every assignment, token-major."""
    slots, (slot, order, _) = jax.vmap(
        lambda xg, eg: jax_moe._group_dispatch(xg, eg, None, E, C))(
            jnp.asarray(x), jnp.asarray(eidx))
    out = np.empty(np.shape(slot), np.int64)
    np.put_along_axis(out, np.asarray(order), np.asarray(slot), axis=1)
    return out, _np(slots)


@pytest.mark.parametrize("cf,drops", [(1.25, True), (None, False)])
def test_dispatch_drops_the_assignments_jax_drops(cf, drops):
    """A router skewed so that every token's first choice is expert 0:
    at cf = 1.25 expert 0 overflows, and which of its assignments are
    kept depends on the stable sort; the slot of every assignment (the
    sentinel E*C for a dropped one) equals the reference's.  At cf = E
    (capacity for every assignment) nothing is dropped."""
    G, Sx, d, E, k = 3, 64, 16, 8, 2
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((G, Sx, d)) + 1.0).astype(np.float32)
    router = (rng.standard_normal((d, E)) * 0.1).astype(np.float32)
    router[:, 0] += 0.5
    logits = x @ router
    eidx = np.array(jax.lax.top_k(jnp.asarray(logits), k)[1])
    assert np.array_equal(eidx, torch.topk(torch.as_tensor(logits), k,
                                           dim=-1).indices.numpy())
    assert (eidx[..., 0] == 0).all()
    C = MOE.capacity(Sx, k, E, E if cf is None else cf)
    want, jslots = _jax_slots(x, eidx, E, C)
    slots, slot = MOE._group_dispatch(torch.as_tensor(x),
                                      torch.as_tensor(eidx), E, C)
    np.testing.assert_array_equal(slot.numpy(), want)
    np.testing.assert_array_equal(slots.numpy(), jslots)
    dropped = slot.numpy() == E * C
    assert dropped.any() == drops
    if drops:
        assert dropped.sum() == G * (Sx - C)      # expert 0's overflow


def test_capacity_is_the_reference_arithmetic():
    assert MOE.capacity(2048, 8, 64, 1.25) == 328
    assert MOE.capacity(1, 8, 64, 1.25) == 8
    assert MOE.capacity(16, 2, 8, 1.25) == 8
    assert MOE.capacity(64, 2, 8, 1.25) == 24


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=[(n, d) for n in NAMES
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
                dtype=dtype, cfg=cfg)


@contextlib.contextmanager
def routes(monkeypatch):
    """Record both packages' routing, one entry per MoE call (layer):
    the JAX package's top-k expert ids (through a debug callback, as its
    layers run under ``lax.scan``) and the port's, with the port's gap
    between each token's k-th and (k+1)-th router logits."""
    rec = {"jax": [], "port": [], "margin": []}
    jinner, route = jax_moe.moe_fwd, MOE.route

    def jspy(p, x, ctx, *, top_k, capacity_factor=1.25):
        logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32),
                            p["router"])
        jax.debug.callback(lambda i: rec["jax"].append(np.asarray(i)),
                           jax.lax.top_k(logits, top_k)[1], ordered=True)
        return jinner(p, x, ctx, top_k=top_k,
                      capacity_factor=capacity_factor)

    def tspy(p, x, top_k):
        top = torch.topk(x.float() @ p["router"], top_k + 1, dim=-1)
        rec["port"].append(top.indices[..., :top_k].numpy())
        rec["margin"].append((top.values[..., top_k - 1]
                              - top.values[..., top_k]).numpy())
        return route(p, x, top_k)
    with monkeypatch.context() as m:
        m.setattr(jax_moe, "moe_fwd", jspy)
        m.setattr(MOE, "route", tspy)
        yield rec
    jax.effects_barrier()


def _flips(rec):
    """(B, S) bool: the two packages chose different expert sets for
    this token at some layer.  Every flip must be a near-tie of the
    port's router (margin under ``ROUTE_MARGIN``)."""
    assert len(rec["jax"]) == len(rec["port"])
    flips = []
    for j, t, margin in zip(rec["jax"], rec["port"], rec["margin"]):
        f = (np.sort(j, -1) != np.sort(t, -1)).any(-1)
        assert (margin[f] < ROUTE_MARGIN).all(), margin[f]
        flips.append(f)
    return np.stack(flips).any(0)


def _close(got, want, dtype, exempt=None, slack=None):
    """``exempt``: bool over the leading dims of the logits that may
    differ because a route flipped at or before them.  ``slack``: a
    difference the reference makes itself on these elements (shaped as
    ``want``), added to each bf16 bound and its mean to the mean's."""
    got = got.float().numpy()
    want = _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        assert exempt is None or not np.asarray(exempt).any()
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
        return
    keep = np.ones(got.shape[:-1], bool) if exempt is None \
        else ~np.broadcast_to(np.asarray(exempt), got.shape[:-1])
    assert keep.any(), "every logit is exempt"
    slack = np.zeros_like(want) if slack is None else np.asarray(slack)
    diff, slack = np.abs(got - want)[keep], slack[keep]
    over = diff - (0.1 + 0.02 * np.abs(want[keep]) + slack)
    assert (over <= 0).all(), f"{(over > 0).sum()} beyond, by {over.max()}"
    assert diff.mean() < 0.01 + slack.mean()


def test_params_carry_over_with_a_float32_router(pair):
    model, params = pair["model"], pair["params"]
    ffn, jffn = model.params["stack"]["ffn"], params["stack"]["ffn"]
    assert ffn["router"].dtype == torch.float32
    np.testing.assert_array_equal(ffn["router"].numpy(),
                                  np.asarray(jffn["router"]))
    for k in ("w_gate", "w_up", "w_down"):
        assert ffn[k].dtype == model.dtype
        np.testing.assert_array_equal(ffn[k].float().numpy(), _np(jffn[k]))
    assert model.param_count() == sum(x.size for x in jax.tree.leaves(params))


def test_forward_matches_jax(pair, monkeypatch):
    with routes(monkeypatch) as rec:
        jlogits, jaux = pair["jmodel"].forward(
            pair["params"], {"tokens": jnp.asarray(pair["toks"])}, Ctx())
        logits, aux = pair["model"].forward(
            {"tokens": torch.as_tensor(pair["toks"])}, with_aux=True)
    assert len(rec["port"]) == pair["cfg"].n_layers
    flips = _flips(rec)
    # a flipped token changes its own output and, through attention,
    # every later position of its row
    _close(logits, jlogits, pair["dtype"], np.maximum.accumulate(flips, 1))
    if not flips.any():
        tol = 1e-6 if pair["dtype"] == "float32" else 1e-3
        np.testing.assert_allclose(float(aux), float(jaux), atol=tol,
                                   rtol=tol)


def test_prefill_and_decode_match_jax(pair, monkeypatch):
    jmodel, params, model = pair["jmodel"], pair["params"], pair["model"]
    toks, dtype, cfg = pair["toks"], pair["dtype"], pair["cfg"]
    with routes(monkeypatch) as rec:
        jl, jc = jmodel.prefill(params, {"tokens": jnp.asarray(toks)},
                                Ctx(), pad_to=PAD)
        logits, cache = model.prefill({"tokens": torch.as_tensor(toks)},
                                      pad_to=PAD)
    tainted = _flips(rec).any(1)             # per row, carried by the cache
    _close(logits, jl, dtype, tainted)
    smax = min(PAD, cfg.window) if cfg.window else PAD
    assert cache["k"].shape == jc["k"].shape == (
        cfg.n_layers, B, cfg.n_kv, smax, cfg.head_dim)
    rng = np.random.default_rng(2)
    decode = make_decode_step(model)
    for step in range(STEPS):
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        pos = np.array([S + step, S - 2 + step], np.int32)
        with routes(monkeypatch) as rec:
            jl, jc = jmodel.decode_step(
                params, jc, {"token": jnp.asarray(tok),
                             "pos": jnp.asarray(pos)}, Ctx())
            nxt, logits, cache = decode(cache, {"token": torch.as_tensor(tok),
                                                "pos": torch.as_tensor(pos)})
        tainted |= _flips(rec)[:, 0]
        _close(logits, jl, dtype, tainted)
        for name in ("k", "v"):
            _close(cache[name], jc[name], dtype,
                   tainted[None, :, None, None])
        np.testing.assert_array_equal(nxt.numpy(),
                                      logits.argmax(-1).numpy())


def test_prefill_plus_decode_is_forward(pair):
    """forward at position S-1 == prefill of S-1 tokens + one decode
    step (the port against itself), with capacity for every assignment:
    with drops the identity does not hold, in the reference either, as
    the capacity and the competition for it depend on S."""
    cfg = dataclasses.replace(pair["cfg"],
                              capacity_factor=float(pair["cfg"].n_experts))
    model, toks = LM(cfg, device="cpu"), pair["toks"]
    model.params = pair["model"].params
    full = model.forward({"tokens": torch.as_tensor(toks)})[:, -1]
    _, cache = model.prefill({"tokens": torch.as_tensor(toks[:, :-1])},
                             pad_to=S)
    logits, _ = model.decode_step(
        cache, {"token": torch.as_tensor(toks[:, -1:]),
                "pos": torch.full((B,), S - 1, dtype=torch.int32)})
    _close(logits, full.float().numpy(), pair["dtype"])


def test_cpu_path_launches_no_kernel(pair):
    before = (fa_ops.LAUNCHES, dec_ops.LAUNCHES)
    model = pair["model"]
    _, cache = model.prefill({"tokens": torch.as_tensor(pair["toks"])},
                             pad_to=PAD)
    model.decode_step(cache, {"token": torch.zeros((B, 1), dtype=torch.int32),
                              "pos": torch.full((B,), S, dtype=torch.int32)})
    assert (fa_ops.LAUNCHES, dec_ops.LAUNCHES) == before


@pytest.mark.parametrize("name", NAMES)
def test_init_draws_the_jax_layout(name):
    cfg = dataclasses.replace(get_arch(name, smoke=True),
                              param_dtype="bfloat16")
    jparams = jax_build_model(jax_get_arch(name, smoke=True)).init(
        jax.random.PRNGKey(0))
    model = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))

    def tshapes(x):
        if isinstance(x, dict):
            return {k: tshapes(v) for k, v in x.items()}
        return tuple(x.shape)
    assert tshapes(model.params) == jax.tree.map(lambda x: tuple(x.shape),
                                                 jparams)
    ffn = model.params["stack"]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["w_up"].dtype == torch.bfloat16
    assert torch.isfinite(model.forward(
        {"tokens": torch.zeros((1, 5), dtype=torch.int32)}).float()).all()


def test_lm_params_from_numpy_checks_moe_keys(pair):
    tree = jax.tree.map(np.asarray, pair["params"])
    del tree["stack"]["ffn"]["router"]
    with pytest.raises(ValueError, match="ffn params"):
        lm_params_from_numpy(pair["cfg"], tree)


def test_dense_forward_has_a_zero_aux():
    cfg = get_arch("internlm2-1.8b", smoke=True)
    model = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    logits, aux = model.forward(
        {"tokens": torch.zeros((1, 3), dtype=torch.int32)}, with_aux=True)
    assert logits.shape == (1, 3, cfg.vocab_padded)
    assert aux.dtype == torch.float32 and float(aux) == 0.0
    assert T._kinds(cfg) == ("attn", "mlp")
    assert T._kinds(get_arch("olmoe-1b-7b")) == ("attn", "moe")


def test_batcher_streams_match_jax():
    """olmoe-smoke in float32 through both batchers: six requests over
    two slots, equal token streams."""
    name = "olmoe-1b-7b"
    jmodel = jax_build_model(jax_get_arch(name, smoke=True))
    params = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_arch(name, smoke=True)
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


def test_mixtral_past_its_window_matches_jax():
    """mixtral-smoke (a 32-token window) in float32 with capacity for
    every assignment (cf 4 = E): a prompt of S = 40, which the
    windowed prefill cuts, padded to 48 slots, then 20 decode steps
    whose slots ``pos % window`` wrap over the cache the prefill wrote
    (the reference's windowed decode after a longer prefill, ROADMAP
    C "Facts"); logits and k/v caches against JAX's at every step."""
    name, S_, pad, steps = "mixtral-8x7b", 40, 48, 20
    cf = dict(capacity_factor=4.0)
    jmodel = jax_build_model(dataclasses.replace(
        jax_get_arch(name, smoke=True), **cf))
    params = jmodel.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_arch(name, smoke=True), **cf)
    assert cfg.window == 32 < S_ and cfg.n_experts == 4
    model = LM(cfg, device="cpu").load_numpy(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (B, S_)).astype(np.int32)
    jl, jc = jmodel.prefill(params, {"tokens": jnp.asarray(toks)}, Ctx(),
                            pad_to=pad)
    logits, cache = model.prefill({"tokens": torch.as_tensor(toks)},
                                  pad_to=pad)
    _close(logits, jl, "float32")
    assert cache["k"].shape == jc["k"].shape == (
        cfg.n_layers, B, cfg.n_kv, pad, cfg.head_dim)
    decode = make_decode_step(model)
    # traced once, not once a step
    jdecode = jax.jit(lambda c, b: jmodel.decode_step(params, c, b, Ctx()))
    for step in range(steps):
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        pos = np.full((B,), S_ + step, np.int32)
        jl, jc = jdecode(jc, {"token": jnp.asarray(tok),
                              "pos": jnp.asarray(pos)})
        _, logits, cache = decode(cache, {"token": torch.as_tensor(tok),
                                          "pos": torch.as_tensor(pos)})
        _close(logits, jl, "float32")
        for key in ("k", "v"):
            _close(cache[key], jc[key], "float32")
