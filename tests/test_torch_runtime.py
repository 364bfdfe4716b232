"""The LM-training substrate of the port against the JAX package's:
the token pipeline (``repro_torch.data``, bit-equal), failure injection
and restart supervision (``runtime.fault``; the reference's
``tests/test_runtime.py`` cases, ported), gradient compression
(``runtime.compression``), the straggler helpers (``runtime.straggler``:
the degradation draws bit-equal on the same NumPy generator, the time
budget's cut) and bfloat16 leaves in checkpoints.

Tolerances: the pipeline, ``failure_schedule``, int8 codes and top-k
masks are compared bit for bit (the same NumPy draws; ``torch.round``
and ``jnp.round`` both round half to even); dequantized values,
residuals and scales within 1e-6 relative (one float32 division by the
same scale); bfloat16 checkpoint leaves byte for byte.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as JRT
from repro.ckpt import CheckpointManager as JCheckpointManager
from repro.ckpt import restore_checkpoint as jax_restore
from repro.data import TokenPipeline as JTokenPipeline
from repro.data import synthetic_batch as jax_synthetic_batch
from repro.runtime.compression import compression_ratio as jax_ratio
from repro.runtime import straggler as JST
from repro.runtime.fault import failure_schedule as jax_failure_schedule
from repro_torch import runtime as RT
from repro_torch.ckpt import CheckpointManager, restore_checkpoint
from repro_torch.data import TokenPipeline, synthetic_batch
from repro_torch.sim import churn

torch.set_num_threads(1)


# -------------------------------------------------------------- pipeline
@pytest.mark.parametrize("seed,step,batch,seq,vocab", [
    (0, 0, 4, 32, 512), (3, 17, 8, 64, 92544), (1, 5, 2, 2048, 50432)])
def test_synthetic_batch_bit_equal(seed, step, batch, seq, vocab):
    got = synthetic_batch(seed, step, batch, seq, vocab)
    want = jax_synthetic_batch(seed, step, batch, seq, vocab)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("host_id,num_hosts", [(0, 1), (1, 4), (3, 4)])
def test_pipeline_host_slices_bit_equal(host_id, num_hosts):
    kw = dict(batch=8, seq=16, vocab=512, seed=2, host_id=host_id,
              num_hosts=num_hosts)
    got, want = TokenPipeline(**kw), JTokenPipeline(**kw)
    assert got.host_batch == want.host_batch
    for step in (0, 1, 9):
        np.testing.assert_array_equal(got.get(step)["tokens"],
                                      want.get(step)["tokens"])
    it = iter(got)
    np.testing.assert_array_equal(next(it)["tokens"],
                                  want.get(0)["tokens"])


def test_pipeline_memmap_mode_bit_equal(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 70000, 5000).astype(
        np.int32).tofile(path)
    kw = dict(batch=4, seq=24, vocab=30000, seed=5, path=str(path),
              num_hosts=2, host_id=1)
    got, want = TokenPipeline(**kw), JTokenPipeline(**kw)
    for step in (0, 3):
        g = got.get(step)["tokens"]
        np.testing.assert_array_equal(g, want.get(step)["tokens"])
        assert g.shape == (2, 24) and g.max() < 30000


def test_pipeline_rejects_a_batch_the_hosts_do_not_divide():
    with pytest.raises(ValueError, match="num_hosts"):
        TokenPipeline(batch=6, seq=4, vocab=16, num_hosts=4)


# ----------------------------------------------------------------- fault
def test_failure_schedule_is_the_reference_draw_and_churn_uses_it():
    assert churn.failure_schedule is RT.failure_schedule
    for seed, n in ((0, 10), (4, 2), (7, 0)):
        got = RT.failure_schedule(np.random.default_rng(seed), periods=20,
                                  num_sas=4, n=n)
        want = jax_failure_schedule(np.random.default_rng(seed), periods=20,
                                    num_sas=4, n=n)
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)


def test_run_with_restarts_replays_from_checkpoint():
    saved = {}
    injector = RT.FailureInjector(at_steps=(7,))
    log = []

    def step_fn(state, step):
        injector.maybe_fail(step)
        log.append(step)
        return state + 1

    state, restarts = RT.run_with_restarts(
        init_fn=lambda: (0, 0),
        restore_fn=lambda: saved.get("s"),
        step_fn=step_fn,
        save_fn=lambda s, step: saved.__setitem__("s", (s, step)),
        total_steps=12, ckpt_every=5)
    assert restarts == 1
    assert state == 12                      # exactly-once wrt final count
    assert log.count(5) == 2                # steps 5,6 replayed once
    assert log.count(7) == 1                # failing step runs once (post)


def test_injector_does_not_refire_on_replay():
    inj = RT.FailureInjector(at_steps=(3,))
    with pytest.raises(RT.SimulatedFailure):
        inj.maybe_fail(3)
    inj.maybe_fail(3)                       # replay passes


def test_run_with_restarts_counts_multiple_failures():
    saved = {}
    injector = RT.FailureInjector(at_steps=(4, 9))
    events = []

    def step_fn(state, step):
        injector.maybe_fail(step)
        return state + 1

    state, restarts = RT.run_with_restarts(
        init_fn=lambda: (0, 0),
        restore_fn=lambda: saved.get("s"),
        step_fn=step_fn,
        save_fn=lambda s, step: saved.__setitem__("s", (s, step)),
        total_steps=12, ckpt_every=3, on_event=events.append)
    assert restarts == 2
    assert state == 12
    assert events == ["failure: injected failure at step 4 (restart 1)",
                      "restored at step 3",
                      "failure: injected failure at step 9 (restart 2)",
                      "restored at step 9"]


def test_run_with_restarts_gives_up():
    def step(s, i):
        if i == 1:
            raise RT.SimulatedFailure("always")
        return s

    with pytest.raises(RT.SimulatedFailure):
        RT.run_with_restarts(init_fn=lambda: (0, 0), restore_fn=lambda: None,
                             step_fn=step, save_fn=lambda *_: None,
                             total_steps=3, ckpt_every=1, max_restarts=2)


def test_injector_probabilistic_draws_match_the_reference():
    got, want = RT.FailureInjector(prob=0.3, seed=4), \
        JRT.FailureInjector(prob=0.3, seed=4)
    for step in range(40):
        fails = []
        for inj in (got, want):
            try:
                inj.maybe_fail(step)
                fails.append(False)
            except RuntimeError:
                fails.append(True)
        assert fails[0] == fails[1], step


# ----------------------------------------------------------- compression
def _grads(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((8, 33)) * 3).astype(np.float32),
            "b": {"x": rng.standard_normal((50,)).astype(np.float32),
                  "y": np.array([0.5, -0.5, 1.5, 2.5, -127.0], np.float32)}}


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.as_tensor(v)
            for k, v in tree.items()}


def test_quantize_int8_matches_jax():
    for x in jax.tree.leaves(_grads(1)):
        q, s = RT.quantize_int8(torch.as_tensor(x))
        jq, js = JRT.quantize_int8(jnp.asarray(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_allclose(float(s), float(js), rtol=1e-6)
        np.testing.assert_allclose(RT.dequantize_int8(q, s).numpy(),
                                   np.asarray(JRT.dequantize_int8(jq, js)),
                                   rtol=1e-6)


@pytest.mark.parametrize("k_frac", [0.01, 0.25, 0.5, 1.0])
def test_topk_sparsify_matches_jax(k_frac):
    for x in jax.tree.leaves(_grads(2)):
        got = RT.topk_sparsify(torch.as_tensor(x), k_frac).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(JRT.topk_sparsify(jnp.asarray(x), k_frac)))


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compress_and_decompress_match_jax(scheme):
    g, r = _grads(3), jax.tree.map(lambda x: x * 0.01, _grads(4))
    payload, res = RT.compress_grads(_t(g), _t(r), scheme=scheme,
                                     k_frac=0.1)
    jpayload, jres = JRT.compress_grads(
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, r),
        scheme=scheme, k_frac=0.1)
    for a, b in zip(jax.tree.leaves(res), jax.tree.leaves(
            jax.tree.map(np.asarray, jres))):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6)
    deq = RT.decompress_grads(payload, scheme=scheme)
    jdeq = JRT.decompress_grads(jpayload, scheme=scheme)
    for a, b in zip(jax.tree.leaves(deq), jax.tree.leaves(
            jax.tree.map(np.asarray, jdeq))):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6)
    # error feedback: payload + new residual == gradient + old residual
    for d, n, gg, rr in zip(jax.tree.leaves(deq), jax.tree.leaves(res),
                            jax.tree.leaves(g), jax.tree.leaves(r)):
        np.testing.assert_allclose((d + n).numpy(), gg + rr, atol=1e-5)
    init = RT.CompressionState.init(_t(g))
    assert all(float(x.abs().sum()) == 0 and x.dtype == torch.float32
               for x in jax.tree.leaves(init))


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compression_ratio_matches_jax(scheme):
    g = _grads(5)
    assert RT.compression_ratio(_t(g), scheme=scheme, k_frac=0.1) == \
        pytest.approx(jax_ratio(jax.tree.map(jnp.asarray, g), scheme=scheme,
                                k_frac=0.1), rel=1e-12)
    assert RT.compression_ratio({"w": torch.zeros(1024)}) > 3.5


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compressed_sgd_converges(scheme):
    """Error feedback preserves convergence on a quadratic (the
    reference's case)."""
    params = torch.tensor([4.0, -3.0, 2.0, -1.0])
    res = {"p": torch.zeros_like(params)}
    for _ in range(300):
        payload, res = RT.compress_grads({"p": 2 * params}, res,
                                         scheme=scheme, k_frac=0.25)
        params = params - 0.05 * RT.decompress_grads(payload,
                                                     scheme=scheme)["p"]
    assert float(torch.sum(params ** 2)) < 1e-2


# ------------------------------------------------ bfloat16 in checkpoints
def _bf16(seed=0, shape=(3, 5)):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to(torch.bfloat16)


def test_bf16_round_trips_bit_exactly(tmp_path):
    w = _bf16()
    tree = {"params": {"w": w, "f": torch.arange(4.0)}, "step": 3}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, tree)
    like = {"params": {"w": torch.empty(w.shape, dtype=torch.bfloat16,
                                        device="meta"),
                       "f": torch.zeros(4)}, "step": 0}
    got, step, _ = mgr.restore(like)
    assert step == 7 and got["step"] == 3
    assert got["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["w"].view(torch.int16),
                       w.view(torch.int16))
    np.testing.assert_array_equal(got["params"]["f"], np.arange(4.0))
    raw, _, _ = restore_checkpoint(str(tmp_path))      # no like: |V2
    assert raw["params"]["w"].dtype == np.dtype("V2")
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"params": {"w": _bf16(shape=(5, 3)),
                                "f": torch.zeros(4)}, "step": 0})


def test_bf16_leaf_is_byte_equal_to_the_jax_checkpoint(tmp_path):
    w = _bf16(1, (4, 6))
    jw = jnp.asarray(w.float().numpy(), jnp.bfloat16)   # the same values
    CheckpointManager(str(tmp_path / "port")).save(1, {"p": {"w": w}})
    JCheckpointManager(str(tmp_path / "jax")).save(1, {"p": {"w": jw}})
    a = np.load(tmp_path / "port" / "ckpt_0000000001.npz")["['p']['w']"]
    b = np.load(tmp_path / "jax" / "ckpt_0000000001.npz")["['p']['w']"]
    assert a.dtype == b.dtype == np.dtype("V2")
    assert a.tobytes() == b.tobytes()
    # and the JAX package reads the port's bf16 leaf back
    got, _, _ = jax_restore(str(tmp_path / "port"), {"p": {"w": jw}})
    assert np.asarray(got["p"]["w"]).tobytes() == np.asarray(jw).tobytes()


def test_jax_bf16_leaf_restores_in_the_port(tmp_path):
    jw = jnp.asarray(np.random.default_rng(2).standard_normal((2, 9)),
                     jnp.bfloat16)
    JCheckpointManager(str(tmp_path)).save(4, {"w": jw, "n": jnp.ones(3)})
    got, _, _ = CheckpointManager(str(tmp_path)).restore(
        {"w": torch.zeros((2, 9), dtype=torch.bfloat16),
         "n": torch.zeros(3)})
    assert got["w"].dtype == torch.bfloat16
    assert got["w"].view(torch.int16).numpy().tobytes() == \
        np.asarray(jw).tobytes()


# ------------------------------------------------------------ straggler
@pytest.mark.parametrize("name", ["slowdown_schedule", "throttle_schedule"])
@pytest.mark.parametrize("seed,periods,num_sas,n,window,magnitude", [
    (0, 60, 6, 1, (0.25, 0.75), 4.0), (3, 12, 8, 3, (0.1, 0.9), 2.5),
    (5, 30, 4, 9, (0.5, 0.5), 8.0), (7, 10, 6, 0, (0.25, 0.75), 4.0)])
def test_degradation_draws_equal_the_reference(name, seed, periods, num_sas,
                                               n, window, magnitude):
    """The same NumPy generator, the same (period, sa, mag) bit for bit,
    ``n`` clamped to the fleet, distinct SAs; and the generator left in
    the same state (the churn draws that follow agree too)."""
    kw = dict(periods=periods, num_sas=num_sas, n=n, window=window,
              magnitude=magnitude)
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    got = getattr(RT, name)(rng, **kw)
    want = getattr(JST, name)(jrng, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert len(set(got[1].tolist())) == len(got[1]) == min(n, num_sas)
    assert rng.random() == jrng.random()


def test_churn_degradations_come_from_the_straggler_module():
    assert churn.slowdown_schedule is RT.slowdown_schedule
    assert churn.throttle_schedule is RT.throttle_schedule


@pytest.mark.parametrize("seconds,min_items,want", [(1e9, 1, 5), (0.0, 1, 1),
                                                    (0.0, 3, 3)])
def test_time_budget_cuts_like_the_reference(seconds, min_items, want):
    """An ample budget runs every producer; a spent one stops after
    ``min_items``, as the reference's does."""
    calls = []
    mk = lambda i: (lambda: calls.append(i) or i)
    got = RT.TimeBudget(seconds).collect([mk(i) for i in range(5)],
                                         min_items=min_items)
    ref = JST.TimeBudget(seconds).collect([mk(i) for i in range(5)],
                                          min_items=min_items)
    assert got == ref == list(range(want))
    budget = RT.TimeBudget(1e9)
    budget.reset()
    assert not budget.exhausted
