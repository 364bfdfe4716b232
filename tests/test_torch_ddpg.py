"""The port's actor, critic, replay ring, Adam and DDPG update against the
JAX package on the same NumPy-drawn inputs and carried weights.

Tolerances:
- actor and critic forward: 1e-5 (float32, nine LSTM steps, sums in
  another order);
- ``_adam_step`` given identical gradients: the moments within 1e-6
  relative plus 1e-6 of the leaf's largest magnitude (the same float32
  operations; the global norm sums in another order, and
  ``0.9 m + 0.1 g`` cancels in some elements), the parameters within
  1e-5 relative (``1 - 0.999 ** t`` cancels: one float32 ulp of
  ``0.999 ** 6``, which the two packages may round apart, is 1e-5 of
  the difference);
- one ``ddpg_update``: gradients, losses, ``q_mean`` and ``target_mean``
  within rtol 1e-4 (atol 1e-6); the updated parameters within
  2 * lr + 1e-5 * |p|.  Adam's first step is ~lr * sign(g), so an
  element whose gradient is ~0 may move by +lr in one package and -lr
  in the other when the two sum in other orders; targets move by tau
  times that.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ddpg as JD
from repro.core import policy as JP
from repro.core import replay as JR
from repro_torch.core import ddpg as D
from repro_torch.core import policy as P
from repro_torch.core import replay as R

torch.set_num_threads(1)
F, G, H, T, B = 16, 7, 16, 9, 8
JCFG = JD.DDPGConfig(policy=JP.PolicyConfig(feat_dim=F, act_dim=G, hidden=H))
CFG = D.DDPGConfig(policy=P.PolicyConfig(feat_dim=F, act_dim=G, hidden=H))
FWD = dict(atol=1e-5, rtol=1e-5)
UPD = dict(atol=1e-6, rtol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return D.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _batch(seed=0, act_mask=False):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, T + 1, size=B)
    lens[0], lens[1] = 1, T                    # primer only; full queue
    mask = np.arange(T)[None, :] < lens[:, None]
    lens2 = rng.integers(1, T + 1, size=B)
    mask2 = np.arange(T)[None, :] < lens2[:, None]
    f = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)
    b = dict(s=f(B, T, F), mask=mask,
             a=rng.uniform(-1, 1, (B, T - 1, G)).astype(np.float32),
             r=f(B), s2=f(B, T, F), mask2=mask2)
    if act_mask:
        am = (rng.uniform(size=(B, G)) < 0.7).astype(np.float32)
        am[:, 0] = 1.0
        b["act_mask"] = am
    return b


@pytest.fixture(scope="module")
def jstate():
    state = JD.init_ddpg(jax.random.PRNGKey(2), JCFG)
    # non-zero Adam moments and step: the update's bias correction and
    # moment arithmetic are exercised past the first step
    rng = np.random.default_rng(11)
    noisy = lambda t, s: jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape) * s, x.dtype), t)
    return dataclasses.replace(
        state, actor_opt={"m": noisy(state.actor, 1e-3),
                          "v": jax.tree.map(jnp.abs,
                                            noisy(state.actor, 1e-4))},
        critic_opt={"m": noisy(state.critic, 1e-3),
                    "v": jax.tree.map(jnp.abs, noisy(state.critic, 1e-4))},
        step=jnp.int32(3))


def test_actor_and_critic_match_jax(jstate):
    b = _batch()
    jb = jax.tree.map(jnp.asarray, b)
    ja = jax.vmap(JP.actor_apply, in_axes=(None, None, 0, 0))(
        jstate.actor, JCFG.policy, jb["s"], jb["mask"])
    jq = jax.vmap(JP.critic_apply, in_axes=(None, None, 0, 0, 0))(
        jstate.critic, JCFG.policy, jb["s"], jb["a"], jb["mask"])
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    with torch.no_grad():
        a = P.actor_apply(_t(_np(jstate.actor)), CFG.policy, tb["s"],
                          tb["mask"])
        q = P.critic_apply(_t(_np(jstate.critic)), CFG.policy, tb["s"],
                           tb["a"], tb["mask"])
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), **FWD)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), **FWD)
    # the modules compute the same functions
    critic = P.Critic(CFG.policy, device="cpu").load_numpy(
        _np(jstate.critic))
    actor = P.actor_params_from_numpy(_np(jstate.actor), device="cpu")
    with torch.no_grad():
        np.testing.assert_allclose(critic(tb["s"], tb["a"], tb["mask"]),
                                   np.asarray(jq), **FWD)
        np.testing.assert_allclose(actor(tb["s"], tb["mask"]),
                                   np.asarray(ja), **FWD)


def test_critic_params_from_numpy_checks_every_shape_first(jstate):
    tree = _np(jstate.critic)
    got = P.critic_params_from_numpy(tree, CFG.policy, device="cpu")
    np.testing.assert_array_equal(got["lstm"]["wx"], tree["lstm"]["wx"])
    bad = jax.tree.map(np.copy, tree)
    bad["fc2"]["w"] = np.zeros((H // 2, 2), np.float32)
    with pytest.raises(ValueError, match=r"\['fc2'\]\['w'\]"):
        P.critic_params_from_numpy(bad, CFG.policy, device="cpu")


def _ring_batch(r_values):
    n = len(r_values)
    return dict(s=np.zeros((n, 3, 2), np.float32),
                mask=np.ones((n, 3), bool),
                a=np.zeros((n, 2, 1), np.float32),
                r=np.asarray(r_values, np.float32),
                s2=np.full((n, 3, 2), 1.0, np.float32),
                mask2=np.ones((n, 3), bool))


def test_replay_ring_wraps_like_jax_and_numpy():
    """Capacity 5, writes of 3, 4 and 2: the ring, ``ptr`` and ``size``
    agree with the JAX ring and the NumPy ``ReplayBuffer``; sampling with
    passed-in indices gathers the same rows."""
    jbuf = JR.replay_init(5, 3, 2, 1)
    buf = R.replay_init(5, 3, 2, 1, device="cpu")
    nbuf = R.ReplayBuffer(5, 3, 2, 1)
    start = 0
    for n in (3, 4, 2):
        b = _ring_batch(np.arange(start, start + n))
        start += n
        jbuf = JR.replay_add(jbuf, jax.tree.map(jnp.asarray, b))
        assert R.replay_add(buf, {k: torch.as_tensor(v)
                                  for k, v in b.items()}) is buf
        nbuf.add_batch(*(b[k] for k in R._FIELDS))
        assert buf["ptr"] == int(jbuf["ptr"]) == nbuf.ptr
        assert buf["size"] == int(jbuf["size"]) == nbuf.size
        for k in R.replay_fields(buf):
            np.testing.assert_array_equal(buf[k].numpy(),
                                          np.asarray(jbuf[k]))
            np.testing.assert_array_equal(buf[k].numpy(), getattr(nbuf, k))
    np.testing.assert_array_equal(buf["r"].numpy(), [5, 6, 7, 8, 4])
    idx = np.array([4, 0, 0, 3])
    got = R.replay_sample(buf, idx=torch.as_tensor(idx))
    for k in R.replay_fields(buf):
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(jbuf[k])[idx])
    with pytest.raises(ValueError, match="capacity"):
        R.replay_add(buf, {k: torch.as_tensor(v)
                           for k, v in _ring_batch(np.arange(6)).items()})


def test_replay_sample_draws_from_the_generator():
    buf = R.replay_init(8, 3, 2, 1, device="cpu")
    R.replay_add(buf, {k: torch.as_tensor(v)
                       for k, v in _ring_batch(np.arange(3)).items()})
    draw = lambda: R.replay_sample(buf, 64, torch.Generator().manual_seed(4))
    a, b = draw(), draw()
    np.testing.assert_array_equal(a["r"], b["r"])
    assert set(a["r"].tolist()) == {0.0, 1.0, 2.0}      # only written rows
    rep = R.DeviceReplay(8, 3, 2, 1, device="cpu")
    rep.add_batch({k: torch.as_tensor(v).reshape((1, 3) + v.shape[1:])
                   for k, v in _ring_batch(np.arange(3)).items()})
    assert len(rep) == 3
    np.testing.assert_array_equal(
        rep.sample(64, torch.Generator().manual_seed(4))["r"], a["r"])


@pytest.mark.parametrize("clip,step", [(10.0, 0), (0.05, 5)])
def test_adam_step_matches_jax(jstate, clip, step):
    """Identical gradients in; ``clip`` 0.05 makes the global-norm clip
    act, 10 leaves it idle."""
    rng = np.random.default_rng(step)
    params = _np(jstate.critic)
    grads = jax.tree.map(
        lambda p: (rng.standard_normal(p.shape) * 0.1).astype(np.float32),
        params)
    opt = _np(jstate.critic_opt)
    jnew, jopt = JD._adam_step(*jax.tree.map(jnp.asarray, (params, grads,
                                                           opt)),
                               1e-3, jnp.int32(step), clip)
    new, nopt = D._adam_step(_t(params), _t(grads), _t(opt), 1e-3, step,
                             clip)
    for got, want, rtol in ((new, jnew, 1e-5), (nopt["m"], jopt["m"], 1e-6),
                            (nopt["v"], jopt["v"], 1e-6)):
        for g, w in zip(D.tree_leaves(got), jax.tree.leaves(want)):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=rtol,
                                       atol=1e-6 * np.abs(w).max())


def test_critic_and_actor_gradients_match_jax(jstate):
    b = _batch(seed=1)
    jb = jax.tree.map(jnp.asarray, b)
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    pc, jpc = CFG.policy, JCFG.policy
    y = np.random.default_rng(5).standard_normal(B).astype(np.float32)
    jc = jax.vmap(JP.critic_apply, in_axes=(None, None, 0, 0, 0))
    ja = jax.vmap(JP.actor_apply, in_axes=(None, None, 0, 0))
    jcg = jax.grad(lambda cp: jnp.mean(
        (jc(cp, jpc, jb["s"], jb["a"], jb["mask"]) - y) ** 2))(jstate.critic)
    jag = jax.grad(lambda ap: -jnp.mean(jc(
        jstate.critic, jpc, jb["s"], ja(ap, jpc, jb["s"], jb["mask"]),
        jb["mask"])))(jstate.actor)
    critic = _t(_np(jstate.critic))
    _, _, cg = D._grads(lambda cp: (torch.mean((P.critic_apply(
        cp, pc, tb["s"], tb["a"], tb["mask"]) - torch.as_tensor(y)) ** 2),
        None), critic)
    _, _, ag = D._grads(lambda ap: (-torch.mean(P.critic_apply(
        critic, pc, tb["s"], P.actor_apply(ap, pc, tb["s"], tb["mask"]),
        tb["mask"])), None), _t(_np(jstate.actor)))
    for got, want in ((cg, jcg), (ag, jag)):
        scale = max(float(np.abs(np.asarray(w)).max())
                    for w in jax.tree.leaves(want))
        for g, w in zip(D.tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-6 * scale)


def _assert_close_state(state, jnew):
    lr = {"actor": CFG.actor_lr, "critic": CFG.critic_lr,
          "target_actor": CFG.tau * CFG.actor_lr,
          "target_critic": CFG.tau * CFG.critic_lr}
    for name, step in lr.items():
        for g, w in zip(D.tree_leaves(getattr(state, name)),
                        jax.tree.leaves(getattr(jnew, name))):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=2 * step + 1e-5 * np.abs(w).max())
    assert state.step == int(jnew.step)


@pytest.mark.parametrize("act_mask", [False, True])
def test_ddpg_update_matches_jax(jstate, act_mask):
    b = _batch(seed=2, act_mask=act_mask)
    jnew, jinfo = JD.ddpg_update_jit(jstate, JCFG,
                                     jax.tree.map(jnp.asarray, b))
    state = D.ddpg_state_from_numpy(_np(jstate), CFG, device="cpu")
    new, info = D.ddpg_update(state, CFG,
                              {k: torch.as_tensor(v) for k, v in b.items()})
    for k in ("critic_loss", "actor_loss", "q_mean", "target_mean"):
        np.testing.assert_allclose(float(info[k]), float(jinfo[k]), **UPD)
    _assert_close_state(new, jnew)
    # the input state is left as it was
    np.testing.assert_array_equal(state.actor["lstm"]["wx"],
                                  np.asarray(jstate.actor["lstm"]["wx"]))


def test_ddpg_update_rounds_match_jax_on_passed_indices(jstate):
    """Three updates, each on the rows the JAX scan samples from its own
    key (``replay_sample`` with ``split(key, 3)``)."""
    rng = np.random.default_rng(3)
    cap, n = 16, 12
    rows = {k: np.concatenate([v] * 2)[:n]
            for k, v in _batch(seed=4).items()}
    jbuf = JR.replay_add(JR.replay_init(cap, T, F, G),
                         jax.tree.map(jnp.asarray, rows))
    buf = R.replay_add(R.replay_init(cap, T, F, G, device="cpu"),
                       {k: torch.as_tensor(v) for k, v in rows.items()})
    key = jax.random.PRNGKey(int(rng.integers(1 << 30)))
    jnew, jinfos = JD.ddpg_update_rounds(jstate, JCFG, jbuf, key, 3, 4)
    idx = np.stack([np.asarray(jax.random.randint(k, (4,), 0, n))
                    for k in jax.random.split(key, 3)])
    state = D.ddpg_state_from_numpy(_np(jstate), CFG, device="cpu")
    new, infos = D.ddpg_update_rounds(state, CFG, buf, torch.as_tensor(idx))
    for k in ("critic_loss", "actor_loss", "q_mean", "target_mean"):
        np.testing.assert_allclose(infos[k].numpy(), np.asarray(jinfos[k]),
                                   atol=1e-5, rtol=1e-3)
    assert new.step == int(jnew.step) == 6


def test_ddpg_state_from_numpy_checks_every_shape_first(jstate):
    tree = _np(jstate)
    bad = dataclasses.replace(tree, critic_opt={
        "m": tree.critic_opt["m"],
        "v": {**tree.critic_opt["v"], "fc1": {"w": np.zeros((3, 3)),
                                              "b": np.zeros((H // 2,))}}})
    with pytest.raises(ValueError, match=r"\[<flat index 5>\]\['v'\]"
                                         r"\['fc1'\]\['w'\]"):
        D.ddpg_state_from_numpy(bad, CFG, device="cpu")


def test_act_adds_clipped_noise_from_the_generator(jstate):
    b = _batch(seed=6)
    actor = _t(_np(jstate.actor))
    s, m = torch.as_tensor(b["s"]), torch.as_tensor(b["mask"])
    a0, prio0, sa0 = D.act(actor, CFG.policy, s, m)
    a1, _, _ = D.act(actor, CFG.policy, s, m, torch.Generator().manual_seed(0),
                     sigma=0.5)
    a2, _, _ = D.act(actor, CFG.policy, s, m, torch.Generator().manual_seed(0),
                     sigma=0.5)
    torch.testing.assert_close(a1, a2)
    assert float(a1.abs().max()) <= 1.0 and not torch.equal(a0, a1)
    torch.testing.assert_close(prio0, a0[..., 0])
    torch.testing.assert_close(sa0, torch.argmax(a0[..., 1:], dim=-1))
