"""One scheduling period of the port's batched environment against the
JAX package's ``SchedulingEnv``, stream by stream.

Three NumPy-drawn traces are advanced a few periods by the JAX env (so
residual layers and busy SAs exist), stacked along the port's stream
axis, and one period is compared piece by piece: slots, features and
mask, actions, engine start/finish, committed mask and the next state,
then the whole ``period`` (transition included).

Tolerances: slot contents and integer/boolean state are exact.
Features agree to 1e-6 (the same float32 formula, rounded the same
way except for divisions XLA may reorder).  Actions of the carried
actor agree to 2e-5 (another matmul order).  Engine times and energies
agree to rtol 1e-5 / atol 1e-3 us: the same event sequence with sums
taken in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jax_BL
from repro.core import policy as P
from repro.sim.env import EnvConfig as JEnvConfig
from repro.sim.env import SchedulingEnv as JEnv
from repro.workloads import build_registry as jax_build_registry
from repro_torch.core import baselines as BL
from repro_torch.core.policy import actor_params_from_numpy
from repro_torch.core.serve import specialist_act
from repro_torch.sim.env import EnvConfig, SchedulingEnv
from repro_torch.workloads import build_registry

torch.set_num_threads(1)
KW = dict(periods=10, max_rq=32, max_jobs=12)
FLOAT = dict(rtol=1e-5, atol=1e-3)
SEEDS = (0, 1, 2)
WARMUP = 3


@pytest.fixture(scope="module")
def envs():
    jenv = JEnv(jax_build_registry("light"), JEnvConfig(**KW))
    env = SchedulingEnv(build_registry("light"), EnvConfig(**KW),
                        device="cpu")
    pcfg = P.PolicyConfig(feat_dim=jenv.feat_dim, act_dim=jenv.act_dim,
                          hidden=32)
    params = P.init_actor(jax.random.PRNGKey(1), pcfg)
    actor = actor_params_from_numpy(jax.tree.map(np.asarray, params),
                                    device="cpu")
    return jenv, env, pcfg, params, actor


def _jax_act(kind, jenv, pcfg, params):
    if kind == "fcfs":
        return lambda feats, mask, slots, st: jax_BL.fcfs_h(slots, st, jenv)

    def act(feats, mask, slots, st):
        a = P.actor_apply(params, pcfg, feats, mask)
        return a, a[:, 0], jnp.argmax(a[:, 1:], axis=-1).astype(jnp.int32)
    return act


def _port_act(kind, env, actor):
    if kind == "fcfs":
        return lambda feats, mask, slots, st: BL.fcfs_h(slots, st, env)
    return specialist_act(actor)


def _warm(jenv, act):
    """Per-stream JAX (trace, state) after WARMUP fcfs periods."""
    out = []
    fcfs = _jax_act("fcfs", jenv, None, None)
    for seed in SEEDS:
        trace, state = jenv.new_episode(np.random.default_rng(seed))
        for _ in range(WARMUP):
            state, _, _ = jenv.period(state, trace, fcfs)
        out.append((trace, state))
    return out


def _stack(dicts, keys=None):
    keys = keys or dicts[0].keys()
    return {k: torch.as_tensor(np.stack([np.asarray(d[k]) for d in dicts]))
            for k in keys}


def _port_inputs(pairs):
    trace = _stack([tr for tr, _ in pairs])
    state = _stack([st for _, st in pairs])
    for d in (trace, state):
        for k, v in d.items():
            if v.dtype == torch.int32:
                d[k] = v.to(torch.int64)
    return trace, state


def _close(got, want, name, **tol):
    got = got.numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    if want.dtype.kind in "biu" or not tol:
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, err_msg=name, **tol)


@pytest.mark.parametrize("kind", ["relmas", "fcfs"])
def test_period_pieces_match_jax(envs, kind):
    jenv, env, pcfg, params, actor = envs
    pairs = _warm(jenv, kind)
    trace, state = _port_inputs(pairs)
    st = env.mark_drops(state, trace, state["t"])
    slots = env.build_slots(st, trace, cutoff=st["t"])
    feats, mask = env.encode(slots, st)
    a, prio, sa_c = _port_act(kind, env, actor)(feats, mask, slots, st)
    start, fin, cost, bw, en, sa = env.simulate(st, slots, prio, sa_c)
    new = env.commit(st, trace, slots, start, fin, en, sa)
    jact = _jax_act(kind, jenv, pcfg, params)
    for s, (jtr, jst) in enumerate(pairs):
        jst = jenv.mark_drops(jst, jtr, jst["t"])
        jslots = jenv.build_slots(jst, jtr, cutoff=jst["t"])
        for k, v in jslots.items():
            _close(slots[k][s], v, f"slots[{k}]")
        jfeats, jmask = jenv.encode(jslots, jst)
        _close(feats[s], jfeats, "feats", rtol=1e-6, atol=1e-6)
        _close(mask[s], jmask, "mask")
        ja, jprio, jsa = jact(jfeats, jmask, jslots, jst)
        _close(a[s], ja, "actions", rtol=2e-5, atol=2e-5)
        _close(sa_c[s], np.asarray(jsa).astype(np.int64), "sa")
        js, jf, _, _, jen, jsa2 = jenv.simulate(jst, jslots, jprio, jsa)
        _close(start[s], js, "start", **FLOAT)
        _close(fin[s], jf, "finish", **FLOAT)
        committed = slots["valid"][s] & (start[s] < env.cfg.t_s_us - 1e-6)
        _close(committed,
               np.asarray(jslots["valid"]) & (np.asarray(js) < 500.0 - 1e-6),
               "committed")
        jnew = jenv.commit(jst, jtr, jslots, js, jf, jen, jsa2)
        for k, v in jnew.items():
            tol = FLOAT if np.asarray(v).dtype.kind == "f" else {}
            _close(new[k][s], v, f"state[{k}]", **tol)


@pytest.mark.parametrize("kind", ["relmas", "fcfs"])
def test_full_period_matches_jax(envs, kind):
    jenv, env, pcfg, params, actor = envs
    pairs = _warm(jenv, kind)
    trace, state = _port_inputs(pairs)
    new, trans, info = env.period(state, trace, _port_act(kind, env, actor))
    new_c, trans_c, info_c = env.period(state, trace,
                                        _port_act(kind, env, actor),
                                        commit_only=True)
    assert trans_c is None
    for k in new:
        _close(new_c[k], new[k].numpy(), f"commit_only state[{k}]")
    _close(info_c["committed"], info["committed"].numpy(), "committed")
    jact = _jax_act(kind, jenv, pcfg, params)
    for s, (jtr, jst) in enumerate(pairs):
        jnew, jtrans, jinfo = jenv.period(jst, jtr, jact)
        for k, v in jnew.items():
            tol = FLOAT if np.asarray(v).dtype.kind == "f" else {}
            _close(new[k][s], v, f"state[{k}]", **tol)
        _close(info["committed"][s], jinfo["committed"], "committed")
        _close(trans["s"][s], jtrans["s"], "s", rtol=1e-6, atol=1e-6)
        _close(trans["s2"][s], jtrans["s2"], "s2", rtol=1e-6, atol=1e-6)
        _close(trans["mask"][s], jtrans["mask"], "mask")
        _close(trans["mask2"][s], jtrans["mask2"], "mask2")
        _close(trans["r"][s], jtrans["r"], "reward", rtol=1e-5, atol=1e-5)


def test_metrics_match_jax(envs):
    jenv, env, *_ = envs
    pairs = _warm(jenv, "fcfs")
    trace, state = _port_inputs(pairs)
    m = env.metrics(state, trace)
    for s, (jtr, jst) in enumerate(pairs):
        for k, v in jenv.metrics(jst, jtr).items():
            _close(m[k][s], np.asarray(v).astype(m[k].numpy().dtype), k)
