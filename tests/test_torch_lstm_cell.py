"""The port's fused LSTM cell (plain version, autograd Function) and the
policy's step recurrence against the JAX package.

Inputs are drawn with NumPy from fixed seeds and go into both packages.
Tolerances: the plain cell against the Pallas kernel (interpret mode)
and against ``repro.core.policy.lstm_cell_ref``: 1e-5 in float32 and
3e-2 in bfloat16, the JAX kernel tests' own (tests/test_kernels.py:
float32 sums in another order; bf16 rounding at other places).  The
recurrence over a ragged mask, forward and gradient: 1e-5 (float32, nine
steps).  ``gradcheck`` in float64 at its default tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as JP
from repro.kernels.lstm_cell import ops as jops
from repro_torch.core import policy as P
from repro_torch.kernels.lstm_cell import lstm_cell_ref, ops

torch.set_num_threads(1)
SHAPES = [(4, 16, 64), (97, 16, 256), (32, 20, 128), (1, 7, 32), (129, 16, 64)]


def _draw(B, F, H, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, F)).astype(np.float32)
    h = rng.standard_normal((B, H)).astype(np.float32)
    c = rng.standard_normal((B, H)).astype(np.float32)
    wx = (rng.standard_normal((F, 4 * H)) * 0.1).astype(np.float32)
    wh = (rng.standard_normal((H, 4 * H)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((4 * H,)) * 0.1).astype(np.float32)
    return x, h, c, wx, wh, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,F,H", SHAPES)
def test_plain_cell_matches_jax_kernel_and_policy_cell(B, F, H, dtype):
    arrs = _draw(B, F, H)
    targs = [torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrs]
    jargs = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    got = [np.asarray(t.float()) for t in lstm_cell_ref(*targs)]
    tol = 1e-5 if dtype == "float32" else 3e-2
    for want in (jops.lstm_cell(*jargs, interpret=True),
                 JP.lstm_cell_ref(*jargs)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                       atol=tol, rtol=tol)
    # the Function's forward on CPU tensors is the plain version
    before = ops.LAUNCHES
    for g, f in zip(got, ops.lstm_cell(*targs)):
        np.testing.assert_array_equal(g, np.asarray(f.float()))
    assert ops.LAUNCHES == before


def test_function_gradcheck_float64():
    args = [torch.as_tensor(a, dtype=torch.float64).requires_grad_()
            for a in _draw(3, 5, 4, seed=1)]
    assert torch.autograd.gradcheck(ops.lstm_cell, args)


def test_function_backward_matches_autograd_of_plain():
    """float32, both outputs used: the hand-written backward against
    autograd through ``lstm_cell_ref`` (1e-5)."""
    arrs = _draw(6, 9, 16, seed=2)
    rng = np.random.default_rng(3)
    wh2, wc2 = (torch.as_tensor(rng.standard_normal((6, 16)),
                                dtype=torch.float32) for _ in range(2))
    grads = []
    for fn in (ops.lstm_cell, lstm_cell_ref):
        args = [torch.as_tensor(a).requires_grad_() for a in arrs]
        h2, c2 = fn(*args)
        ((h2 * wh2).sum() + (c2 * wc2).sum()).backward()
        grads.append([a.grad for a in args])
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def _scan_inputs(T=9, B=5, F=7, H=16, seed=4):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((T, B, F)).astype(np.float32)
    lens = np.array([T, 1, 4, 0, 6])[:B]          # ragged, one empty row
    mask = np.arange(T)[:, None] < lens[None, :]
    mask[2, 0] = False                            # a hole inside a row
    p = {"wx": (rng.standard_normal((F, 4 * H)) * 0.2).astype(np.float32),
         "wh": (rng.standard_normal((H, 4 * H)) * 0.2).astype(np.float32),
         "b": (rng.standard_normal((4 * H,)) * 0.1).astype(np.float32)}
    w_out = rng.standard_normal((T, B, H)).astype(np.float32)
    return xs, mask, p, w_out


def test_lstm_scan_matches_jax_scan_forward_and_grad():
    xs, mask, p, w_out = _scan_inputs()
    H = p["wh"].shape[0]

    def jloss(p_, xs_):
        hs = jax.vmap(lambda x, m: JP._lstm_scan(p_, x, m, H),
                      in_axes=(1, 1), out_axes=1)(xs_, jnp.asarray(mask))
        return jnp.sum(hs * w_out), hs

    (_, jhs), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                              has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(xs))
    tp = {k: torch.as_tensor(v).requires_grad_() for k, v in p.items()}
    txs = torch.as_tensor(xs).requires_grad_()
    before = ops.LAUNCHES
    hs = P._lstm_scan(tp, txs, torch.as_tensor(mask), H)
    (hs * torch.as_tensor(w_out)).sum().backward()
    assert ops.LAUNCHES == before          # CPU: the plain version
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(hs.detach().numpy(), np.asarray(jhs), **tol)
    np.testing.assert_allclose(txs.grad.numpy(), np.asarray(jgx), **tol)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgp[k]),
                                   **tol)


def test_step_route_matches_sequence_route():
    """Both routes of ``_lstm_scan`` compute one function (the sequence
    kernel's plain version on the CPU): equal to 1e-6."""
    xs, mask, p, _ = _scan_inputs(seed=5)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    args = (torch.as_tensor(xs), torch.as_tensor(mask))
    with torch.no_grad():
        step = P._lstm_scan(tp, *args, 16, use_pallas=False)
        seq = P._lstm_scan(tp, *args, 16, use_pallas=True)
    torch.testing.assert_close(step, seq, atol=1e-6, rtol=1e-6)


def test_bf16_compute_dtype_is_not_ported():
    """``compute_dtype="bfloat16"`` on the step route: the actor and the
    critic against the JAX package's ``actor_apply`` / ``critic_apply``
    in bf16 on the same weights and ragged masks, within 3e-2 (the bf16
    tolerance of the cell tests above: bf16 rounding at other places).
    An unknown dtype raises."""
    F, G, H, T, B = 16, 7, 32, 9, 5
    jcfg = JP.PolicyConfig(feat_dim=F, act_dim=G, hidden=H,
                           compute_dtype="bfloat16")
    cfg = P.PolicyConfig(feat_dim=F, act_dim=G, hidden=H,
                         compute_dtype="bfloat16")
    ja, jc = (init(jax.random.PRNGKey(k), jcfg) for k, init in
              ((3, JP.init_actor), (4, JP.init_critic)))
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((B, T, F)).astype(np.float32)
    acts = rng.uniform(-1, 1, (B, T - 1, G)).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array([T, 1, 4, 0, 6])[:, None]
    want_a = jax.vmap(JP.actor_apply, in_axes=(None, None, 0, 0))(
        ja, jcfg, jnp.asarray(feats), jnp.asarray(mask))
    want_q = jax.vmap(JP.critic_apply, in_axes=(None, None, 0, 0, 0))(
        jc, jcfg, jnp.asarray(feats), jnp.asarray(acts), jnp.asarray(mask))
    tree = lambda p: {k: {n: torch.tensor(np.array(a))
                          for n, a in v.items()} for k, v in p.items()}
    args = [torch.as_tensor(a) for a in (feats, acts, mask)]
    before = ops.LAUNCHES
    with torch.no_grad():
        got_a = P.actor_apply(tree(ja), cfg, args[0], args[2])
        got_q = P.critic_apply(tree(jc), cfg, *args)
    assert ops.LAUNCHES == before
    assert got_a.dtype == got_q.dtype == torch.float32
    for got, want in ((got_a, want_a), (got_q, want_q)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   atol=3e-2, rtol=3e-2)
    with pytest.raises(ValueError, match="compute_dtype"):
        P.PolicyConfig(feat_dim=16, act_dim=7, compute_dtype="float16")


def test_actor_macs_per_timestep_matches_jax():
    for h in (8, 64, 256):
        assert P.actor_macs_per_timestep(P.PolicyConfig(16, 7, h)) == \
            JP.actor_macs_per_timestep(JP.PolicyConfig(16, 7, h))
