"""The port's hybrid family (Jamba-class super-blocks, ``LM`` on
jamba-smoke) against the JAX package's, with the JAX parameters carried
over by ``lm_params_from_numpy``.  Inputs are drawn with NumPy from a
seed.

Layouts: jamba-smoke itself (4 layers, ``attn_every`` 2, attention at
index 1: two super-blocks of (ssm, mlp) and (attn, moe)) and a local
``dataclasses.replace`` with ``n_layers`` 8, ``attn_every`` 8 and
``attn_index`` 4, jamba-v0.1-52b's own layout (one super-block of
(ssm, mlp), (ssm, moe), (ssm, mlp), (ssm, moe), (attn, mlp), (ssm, moe),
(ssm, mlp), (ssm, moe)), so that every sublayer kind appears.  Both
run at d_model 64, 8 SSM heads of 16, state 16, 4 experts top-2.

Tolerances, as ``tests/test_torch_moe.py`` (whose route recorder this
file uses): float32 atol = rtol = 2e-5 (the same arithmetic in another
summation order); bfloat16 ``LM_TOL`` (atol 0.1, rtol 0.02, mean 0.01)
on every (row, position) upstream of a route flip.  A flipped token
changes its own output and, through attention, the SSM state and the
capacity order, every later position of its row; every flip must be a
near-tie of the port's router.  ``LM_TOL`` holds a few bf16 ulps over
the two layers of the dense smoke models, and jamba-smoke's four.  The
full layout runs eight sublayers at d_model 64, where bf16 itself is
far from float32: on this input the reference's bf16 logits differ
from its float32 logits (the same weights) by a mean of 0.037 and up
to 0.57.  The two packages round at different places (XLA on the CPU
keeps fused elementwise chains in float32, PyTorch rounds after every
operation: on one sublayer's same input, 50-72% of a Mamba-2
sublayer's outputs differ, by a mean of ~5e-3), so their bf16 results
differ by more than ``LM_TOL`` there (means of 0.021-0.033).  So in the
full layout each bf16 element is held to ``LM_TOL`` plus the
reference's own bf16 error at that element, |JAX bf16 - JAX float32|
with the bf16 weights cast up, and the mean to 0.01 plus that error's
mean.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_moe as TM
from repro.configs.registry import get_arch as jax_get_arch
from repro.models import transformer as jax_T
from repro.models.layers import Ctx
from repro.models.model import build_model as jax_build_model
from repro.serving import ContinuousBatcher as JaxBatcher
from repro.serving import synth_requests as jax_synth_requests
from repro_torch.configs import get_arch
from repro_torch.kernels.decode_gqa import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.models import LM, lm_params_from_numpy, make_decode_step
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.models.model import _pad_cache_seq
from repro_torch.serving import ContinuousBatcher, synth_requests

torch.set_num_threads(1)
NAME = "jamba-v0.1-52b"
# jamba-v0.1-52b's super-block at smoke width
FULL_LAYOUT = dict(n_layers=8, attn_every=8, attn_index=4)
LAYOUTS = {"smoke": {}, "full_layout": FULL_LAYOUT}
B, S, PAD, STEPS = 2, 12, 16, 2


def _cfgs(layout, dtype="float32", **extra):
    kw = dict(LAYOUTS[layout], param_dtype=dtype, **extra)
    return (dataclasses.replace(jax_get_arch(NAME, smoke=True), **kw),
            dataclasses.replace(get_arch(NAME, smoke=True), **kw))


def _own_error(want, ref):
    """The reference's own bf16 error |want - ref| against its float32
    run ``ref`` (None where the bounds need none)."""
    return None if ref is None else np.abs(TM._np(want) - TM._np(ref))


def _tshapes(x):
    if isinstance(x, dict):
        return {k: _tshapes(v) for k, v in x.items()}
    return tuple(x.shape)


@pytest.fixture(scope="module", params=[(lay, d) for lay in LAYOUTS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    layout, dtype = request.param
    jcfg, cfg = _cfgs(layout, dtype)
    jmodel = jax_build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = LM(cfg, device="cpu").load_numpy(
        jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    ref = None                  # the reference in float32, same weights
    if layout == "full_layout" and dtype == "bfloat16":
        ref = (jax_build_model(_cfgs(layout)[0]),
               jax.tree.map(lambda x: x.astype(jnp.float32), params))
    return dict(jmodel=jmodel, params=params, model=model, toks=toks,
                dtype=dtype, cfg=cfg, ref=ref)


def _ref(pair, method, *args, **kw):
    """The reference's float32 run of ``method`` (None where the bf16
    bounds need none)."""
    if pair["ref"] is None:
        return None
    jmodel, params = pair["ref"]
    return getattr(jmodel, method)(params, *args, **kw)


def _leaves(cache, prefix=""):
    """(path, tensor) of every cache leaf, in a fixed order."""
    for k in sorted(cache):
        v = cache[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _close_cache(cache, jcache, dtype, tainted=None, jref=None):
    """Every leaf of the port's cache against the JAX one's; the
    super-block dimension leads, the batch row is the second."""
    jleaves = dict(_leaves(jax.tree.map(np.asarray, jcache)))
    refs = {} if jref is None else dict(_leaves(jax.tree.map(np.asarray,
                                                             jref)))
    leaves = dict(_leaves(cache))
    assert set(leaves) == set(jleaves)
    for path, x in leaves.items():
        assert x.shape == jleaves[path].shape, path
        exempt = None if tainted is None else \
            tainted.reshape((1, -1) + (1,) * (x.ndim - 3))
        TM._close(x, jleaves[path], dtype, exempt,
                  _own_error(jleaves[path], refs.get(path)))


def test_sb_layout_is_the_reference_layout():
    for layout in LAYOUTS:
        jcfg, cfg = _cfgs(layout)
        assert T.sb_layout(cfg) == jax_T._sb_layout(jcfg)
    full = get_arch(NAME)
    assert T.sb_layout(full) == [
        ("ssm", "mlp"), ("ssm", "moe"), ("ssm", "mlp"), ("ssm", "moe"),
        ("attn", "mlp"), ("ssm", "moe"), ("ssm", "mlp"), ("ssm", "moe")]
    assert T.sb_layout(get_arch(NAME, smoke=True)) == [("ssm", "mlp"),
                                                       ("attn", "moe")]


def test_params_carry_over(pair):
    """Every leaf equal to the JAX one; A_log, D, dt_bias and the router
    stay float32 bit for bit in the bf16 variant."""
    model, params = pair["model"], pair["params"]
    assert model.param_count() == sum(x.size for x in
                                      jax.tree.leaves(params))
    assert _tshapes(model.params) == jax.tree.map(lambda x: tuple(x.shape),
                                                  params)
    for (path, x), (_, jx) in zip(_leaves(model.params),
                                  _leaves(jax.tree.map(np.asarray, params))):
        key = path.rsplit("/", 1)[-1]
        if key in SSM.FLOAT32_KEYS + MOE.FLOAT32_KEYS:
            assert x.dtype == torch.float32, path
            np.testing.assert_array_equal(x.numpy(), jx)
        else:
            assert x.dtype == model.dtype, path
            np.testing.assert_array_equal(x.float().numpy(),
                                          jx.astype(np.float32))


def test_forward_matches_jax(pair, monkeypatch):
    """Logits, and the aux: every MoE sublayer's loss summed over the
    super-blocks and divided by n_layers, as the reference's."""
    with TM.routes(monkeypatch) as rec:
        jlogits, jaux = pair["jmodel"].forward(
            pair["params"], {"tokens": jnp.asarray(pair["toks"])}, Ctx())
        logits, aux = pair["model"].forward(
            {"tokens": torch.as_tensor(pair["toks"])}, with_aux=True)
    cfg = pair["cfg"]
    n_moe = sum(f == "moe" for _, f in T.sb_layout(cfg))
    assert len(rec["port"]) == n_moe * cfg.n_layers // cfg.attn_every
    flips = TM._flips(rec)
    jref = _ref(pair, "forward", {"tokens": jnp.asarray(pair["toks"])},
                Ctx())
    TM._close(logits, jlogits, pair["dtype"], np.maximum.accumulate(flips, 1),
              _own_error(jlogits, None if jref is None else jref[0]))
    assert aux.dtype == torch.float32
    if not flips.any():
        tol = 1e-6 if pair["dtype"] == "float32" else 1e-3
        np.testing.assert_allclose(float(aux), float(jaux), atol=tol,
                                   rtol=tol)


def test_forward_without_aux_computes_none(pair, monkeypatch):
    want = pair["model"].forward({"tokens": torch.as_tensor(pair["toks"])})
    monkeypatch.setattr(MOE, "load_balance", None)
    got = pair["model"].forward({"tokens": torch.as_tensor(pair["toks"])})
    assert torch.equal(got, want)


def test_prefill_and_decode_match_jax(pair, monkeypatch):
    """prefill(pad_to=) logits and every cache leaf (k/v of the attention
    sublayers, ssm/conv of the Mamba-2 ones), then decode steps' logits
    and caches, against the JAX LM."""
    jmodel, params, model = pair["jmodel"], pair["params"], pair["model"]
    toks, dtype, cfg = pair["toks"], pair["dtype"], pair["cfg"]
    with TM.routes(monkeypatch) as rec:
        jl, jc = jmodel.prefill(params, {"tokens": jnp.asarray(toks)},
                                Ctx(), pad_to=PAD)
        logits, cache = model.prefill({"tokens": torch.as_tensor(toks)},
                                      pad_to=PAD)
    tainted = TM._flips(rec).any(1)          # per row, carried by the cache
    jref = _ref(pair, "prefill", {"tokens": jnp.asarray(toks)}, Ctx(),
                pad_to=PAD) or (None, None)
    TM._close(logits, jl, dtype, tainted, _own_error(jl, jref[0]))
    _close_cache(cache, jc, dtype, tainted, jref[1])
    rng = np.random.default_rng(2)
    decode = make_decode_step(model)
    for step in range(STEPS):
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        # row 1 rewrites attention slots it has already filled
        pos = np.array([S + step, S - 2 + step], np.int32)
        jbatch = {"token": jnp.asarray(tok), "pos": jnp.asarray(pos)}
        with TM.routes(monkeypatch) as rec:
            jl, jc = jmodel.decode_step(params, jc, jbatch, Ctx())
            nxt, logits, cache = decode(cache, {"token": torch.as_tensor(tok),
                                                "pos": torch.as_tensor(pos)})
        tainted |= TM._flips(rec)[:, 0]
        if jref[1] is not None:
            jref = _ref(pair, "decode_step", jref[1], jbatch, Ctx())
        TM._close(logits, jl, dtype, tainted, _own_error(jl, jref[0]))
        _close_cache(cache, jc, dtype, tainted, jref[1])
        np.testing.assert_array_equal(nxt.numpy(),
                                      logits.argmax(-1).numpy())


def test_prefill_plus_decode_is_forward(pair):
    """The reference's test_decode_parity on the port: forward at
    position S-1 == prefill of S-1 tokens + one decode step, with
    capacity for every assignment (with drops the identity does not
    hold, in the reference either).  In the full layout's bf16 the two
    orders round differently in the reference too: the bound grows by
    the reference's own difference between them."""
    cf = dict(capacity_factor=float(pair["cfg"].n_experts))
    model = LM(dataclasses.replace(pair["cfg"], **cf), device="cpu")
    model.params = pair["model"].params
    toks = torch.as_tensor(pair["toks"])
    last = {"token": toks[:, -1:],
            "pos": torch.full((B,), S - 1, dtype=torch.int32)}
    full = model.forward({"tokens": toks})[:, -1]
    _, cache = model.prefill({"tokens": toks[:, :-1]}, pad_to=S + 4)
    logits, _ = model.decode_step(cache, last)
    slack = None
    if pair["ref"] is not None:
        jmodel = jax_build_model(dataclasses.replace(pair["jmodel"].cfg,
                                                     **cf))
        params, jt = pair["params"], jnp.asarray(pair["toks"])
        jfull, _ = jmodel.forward(params, {"tokens": jt}, Ctx())
        _, jc = jmodel.prefill(params, {"tokens": jt[:, :-1]}, Ctx(),
                               pad_to=S + 4)
        jl, _ = jmodel.decode_step(params, jc, {
            "token": jt[:, -1:], "pos": jnp.full((B,), S - 1, jnp.int32)},
            Ctx())
        slack = np.abs(TM._np(jfull[:, -1]) - TM._np(jl))
    TM._close(logits, full.float().numpy(), pair["dtype"], slack=slack)


def test_decode_writes_the_cache_in_place(pair):
    """A decode step writes into the stacked cache tensors themselves:
    each sublayer's slice of a super-block is a view, not a copy."""
    model, cfg = pair["model"], pair["cfg"]
    cache = model.init_cache(B, PAD, model.dtype)
    layout = T.sb_layout(cfg)
    attn = f"l{cfg.attn_index}"
    ssm = f"l{[m for m, _ in layout].index('ssm')}"
    tensors = dict(_leaves(cache))
    ptrs = {k: v.data_ptr() for k, v in tensors.items()}
    before = {k: v.clone() for k, v in tensors.items()}
    tok = torch.as_tensor(pair["toks"][:, :1])
    _, out = model.decode_step(cache, {"token": tok,
                                       "pos": torch.tensor([3, 5],
                                                           dtype=torch.int32)})
    assert out is cache
    for path, x in _leaves(out):
        assert x is tensors[path] and x.data_ptr() == ptrs[path], path
    for path in (f"{attn}/k", f"{attn}/v", f"{ssm}/ssm", f"{ssm}/conv"):
        changed = tensors[path] != before[path]
        # every super-block of every row moved
        assert changed.flatten(2).any(-1).all(), path
    # the attention write landed in slots 3 and 5 of rows 0 and 1 only
    k = tensors[f"{attn}/k"]
    moved = (k != 0).any(-1).any(2)                  # (nsb, B, PAD)
    want = torch.zeros_like(moved)
    want[:, 0, 3] = want[:, 1, 5] = True
    assert torch.equal(moved, want)


def test_pad_cache_seq_pads_only_attention_kv(pair):
    """pad_to grows the attention sublayers' k/v to PAD slots; the ssm
    and conv states come through as they are."""
    model = pair["model"]
    toks = torch.as_tensor(pair["toks"])
    _, plain = model.prefill({"tokens": toks})
    _, padded = model.prefill({"tokens": toks}, pad_to=PAD)
    assert _pad_cache_seq(plain, PAD).keys() == padded.keys()
    for path, x in _leaves(padded):
        p = dict(_leaves(plain))[path]
        if path.endswith(("/k", "/v")):
            assert x.shape[3] == PAD and p.shape[3] == S
            torch.testing.assert_close(x[..., :S, :], p, atol=0, rtol=0)
            assert not x[..., S:, :].any()
        else:
            assert x.shape == p.shape, path
            torch.testing.assert_close(x, p, atol=0, rtol=0)


def test_cpu_path_launches_no_kernel(pair):
    before = (fa_ops.LAUNCHES, dec_ops.LAUNCHES, ssd_ops.LAUNCHES)
    model = pair["model"]
    _, cache = model.prefill({"tokens": torch.as_tensor(pair["toks"])},
                             pad_to=PAD)
    model.decode_step(cache, {"token": torch.zeros((B, 1), dtype=torch.int32),
                              "pos": torch.full((B,), S, dtype=torch.int32)})
    assert (fa_ops.LAUNCHES, dec_ops.LAUNCHES, ssd_ops.LAUNCHES) == before


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_init_draws_the_jax_layout(layout):
    """``init`` draws the reference's tree (the super-block dimension
    leading every leaf), bf16 weights with the float32 leaves, and
    runs."""
    jcfg, cfg = _cfgs(layout, "bfloat16")
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    model = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert _tshapes(model.params) == jax.tree.map(lambda x: tuple(x.shape),
                                                  jparams)
    for path, x in _leaves(model.params):
        key = path.rsplit("/", 1)[-1]
        assert x.dtype == (torch.float32 if key in SSM.FLOAT32_KEYS
                           + MOE.FLOAT32_KEYS else torch.bfloat16), path
    a_log = model.params["stack"]["l0"]["mixer"]["A_log"]
    np.testing.assert_allclose(a_log[0].numpy(),
                               np.log(np.linspace(1.0, 16.0, 8)), rtol=1e-6)
    assert torch.isfinite(model.forward(
        {"tokens": torch.zeros((1, 5), dtype=torch.int32)}).float()).all()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_init_cache_is_the_reference_layout(layout):
    """``{"l{i}": k/v or ssm/conv}`` with the super-blocks leading, the
    ssm state in float32 and the rest in the cache's dtype, as JAX's."""
    jcfg, cfg = _cfgs(layout)
    cache = LM(cfg, device="cpu").init_cache(3, 40, torch.bfloat16)
    jcache = jax_build_model(jcfg).init_cache(3, 40)
    assert _tshapes(cache) == jax.tree.map(lambda x: tuple(x.shape), jcache)
    nsb = cfg.n_layers // cfg.attn_every
    for path, x in _leaves(cache):
        assert x.shape[0] == nsb and not x.any()
        assert x.dtype == (torch.float32 if path.endswith("/ssm")
                           else torch.bfloat16), path
    attn = cache[f"l{cfg.attn_index}"]
    assert attn["k"].shape == (nsb, 3, cfg.n_kv, 40, cfg.head_dim)


def test_lm_params_from_numpy_checks_hybrid_keys():
    jcfg, cfg = _cfgs("full_layout")
    params = jax.tree.map(np.asarray, jax_build_model(jcfg).init(
        jax.random.PRNGKey(0)))

    def tree():
        return jax.tree.map(lambda x: x, params)
    t = tree()
    del t["stack"]["l3"]["ffn"]["router"]
    with pytest.raises(ValueError, match="l3 ffn params"):
        lm_params_from_numpy(cfg, t)
    t = tree()                  # an MLP where the layout has a MoE FFN
    t["stack"]["l1"]["ffn"] = t["stack"]["l0"]["ffn"]
    with pytest.raises(ValueError, match="l1 ffn params"):
        lm_params_from_numpy(cfg, t)
    t = tree()                  # attention where the layout has Mamba-2
    t["stack"]["l5"]["mixer"] = t["stack"]["l4"]["mixer"]
    with pytest.raises(ValueError, match="l5 mixer params"):
        lm_params_from_numpy(cfg, t)
    t = tree()
    del t["stack"]["l7"]
    with pytest.raises(ValueError, match="super-block params"):
        lm_params_from_numpy(cfg, t)
    t = tree()                  # a homogeneous stack is no hybrid
    t["stack"] = t["stack"]["l0"]
    with pytest.raises(ValueError, match="super-block params"):
        lm_params_from_numpy(cfg, t)


def test_init_refuses_a_ragged_super_block():
    cfg = dataclasses.replace(get_arch(NAME, smoke=True), n_layers=5)
    with pytest.raises(ValueError, match="multiple of attn_every"):
        LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_batcher_streams_match_jax(layout):
    """Six requests over two slots in float32 through both batchers:
    equal token streams.  The Mamba-2 sublayers' state carries across
    requests in a slot (it is not reset), in both packages."""
    jcfg, cfg = _cfgs(layout)
    jmodel = jax_build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = LM(cfg, device="cpu").load_numpy(jax.tree.map(np.asarray,
                                                          params))

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
