"""The port's legacy per-period runners, the segment engine and the
quickstart against the JAX package (and against the port's batched
runners).

The harness is tests/test_torch_train.py's: the ``light`` registry,
``periods=6, max_rq=16, max_jobs=8``, hidden 8, the JAX weights carried
into the port, and randomness as data (NumPy traces from the seeds; the
per-period normal draws the JAX ``run_episode`` takes from its key chain;
the replay indices and round draws JAX takes from its keys).
Tolerances:
- episodes, policy and heuristics: ``counted``, ``hits``, ``arrived``
  and the masks equal; features, actions, rewards and energy within
  1e-5 (float32 sums in another order); ``evaluate``'s means within
  rtol 1e-5;
- the two policy routes (``use_pallas``) of the port: within 1e-5 (the
  same float32 recurrence, one in a loop of cells);
- MAGMA and the baselines through the per-period runner against the
  batched runner, and the segment engine against ``simulate``: equal
  (the same operations on the same draws; max and min are exact);
- ``simulate_segments`` against ``simulate_jax_segments``:
  tests/test_torch_engine.py's rtol 1e-5 / atol 1e-3 us;
- ``ddpg_update_scan``: tests/test_torch_ddpg.py's update tolerances,
  infos within atol 1e-5 / rtol 1e-3 after several updates and
  parameters within 2 * lr per update + 1e-5 * |p|;
- ``train_rounds_scan``: tests/test_torch_train.py's round tolerances;
  against the port's ``train_rounds_host`` on the same draws, equal.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_engine as TE
import test_torch_train as TT
from repro.core import baselines as JBL
from repro.core import ddpg as JD
from repro.core import replay as JR
from repro.core import rollout as JRO
from repro.core import train as JTR
from repro.sim.engine import commit_period_np as jax_commit_period_np
from repro.sim.engine import simulate_jax_segments
from repro_torch.core import baselines as BL
from repro_torch.core import ddpg as D
from repro_torch.core import rollout as RO
from repro_torch.core import train as TR
from repro_torch.core.replay import replay_add, replay_init, sample_indices
from repro_torch.sim import commit_period_np, engine, simulate_segments
from test_torch_train import envs  # noqa: F401 (fixture)

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
SEEDS = (3, 4)
TOL = TT.TOL
KW = TT.KW


def _actor(jstate):
    return TT._t(TT._np(jstate.actor))


def _jax_noise(jenv, seed):
    """The per-period draws of the JAX ``run_episode`` from
    ``PRNGKey(seed)``: ``key, sub = split(key)``, then
    ``normal(sub, (max_rq, G))`` each period."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(KW["periods"]):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(
            sub, (KW["max_rq"], jenv.act_dim))))
    return np.stack(out)


def _assert_episode(m, trans, jm, jtrans):
    assert m.keys() == jm.keys()
    for k in ("counted", "hits", "arrived"):
        assert m[k] == jm[k], k
    for k in ("sla_rate", "energy_uj"):
        assert m[k] == pytest.approx(jm[k], rel=1e-5), k
    assert len(trans) == len(jtrans) == KW["periods"]
    for got, want in zip(trans, jtrans):
        assert got.keys() == want.keys()
        for k in ("mask", "mask2"):
            np.testing.assert_array_equal(got[k], want[k])
        for k in ("s", "a", "r", "s2"):
            assert got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k], want[k], **TOL)


@pytest.fixture(scope="module")
def jperiod(envs):  # noqa: F811
    jenv, _, jdcfg = envs[:3]
    return JRO.make_policy_period(jenv, jdcfg.policy)


# ---------------------------------------------------------------------------
# the policy period and run_episode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sigma", [0.0, 0.3])
@pytest.mark.parametrize("seed", SEEDS)
def test_policy_run_episode_matches_jax(envs, jperiod, seed,  # noqa: F811
                                        sigma):
    """sigma 0: no noise and no clip in either package; sigma 0.3: the
    JAX episode's per-period draws passed in as ``noise``."""
    jenv, env, jdcfg, dcfg, jstate = envs
    jm, jtrans = JRO.run_episode(jenv, jperiod, np.random.default_rng(seed),
                                 params=jstate.actor,
                                 key=jax.random.PRNGKey(seed), sigma=sigma,
                                 collect=True)
    m, trans = RO.run_episode(
        env, RO.make_policy_period(env, dcfg.policy),
        np.random.default_rng(seed), params=_actor(jstate), sigma=sigma,
        collect=True, noise=_jax_noise(jenv, seed) if sigma else None)
    assert all(isinstance(v, float) for v in m.values())
    assert all(isinstance(v, np.ndarray) for t in trans for v in t.values())
    _assert_episode(m, trans, jm, jtrans)
    if sigma:
        assert max(np.abs(t["a"]).max() for t in trans) <= 1.0


def test_policy_period_draws_from_the_generator(envs):  # noqa: F811
    """At sigma > 0 without ``noise`` the draws come from ``gen``: the
    same seed gives the same episode, and the noise moved the actions."""
    env, dcfg, jstate = envs[1], envs[3], envs[4]
    period = RO.make_policy_period(env, dcfg.policy)
    run = lambda sigma: RO.run_episode(
        env, period, np.random.default_rng(3), params=_actor(jstate),
        gen=torch.Generator().manual_seed(1), sigma=sigma, collect=True)
    (m1, t1), (m2, t2), (_, t0) = run(0.3), run(0.3), run(0.0)
    assert m1 == m2
    for a, b, c in zip(t1, t2, t0):
        np.testing.assert_array_equal(a["a"], b["a"])
    assert not all(np.array_equal(a["a"], c["a"]) for a, c in zip(t1, t0))


def test_sequence_route_matches_the_step_route(envs):  # noqa: F811
    env, dcfg, jstate = envs[1], envs[3], envs[4]
    runs = []
    for use_pallas in (False, True):
        pcfg = dataclasses.replace(dcfg.policy, use_pallas=use_pallas)
        runs.append(RO.run_episode(
            env, RO.make_policy_period(env, pcfg), np.random.default_rng(4),
            params=_actor(jstate), collect=True))
    (m, trans), (ms, trans_s) = runs
    _assert_episode(ms, trans_s, m, trans)


# ---------------------------------------------------------------------------
# evaluate: the policy and each heuristic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["relmas", "fcfs", "prema", "herald"])
def test_evaluate_matches_jax_and_the_batched_runners(envs,  # noqa: F811
                                                      name):
    jenv, env, jdcfg, dcfg, jstate = envs
    actor = _actor(jstate)
    if name == "relmas":
        jm = JRO.evaluate(jenv, JRO.make_policy_period(jenv, jdcfg.policy),
                          SEEDS, params=jstate.actor,
                          key=jax.random.PRNGKey(0))
        m = RO.evaluate(env, RO.make_policy_period(env, dcfg.policy), SEEDS,
                        params=actor)
        mb = RO.evaluate_batch(env, dcfg.policy, actor, SEEDS)
    else:
        jm = JRO.evaluate(jenv, JRO.make_baseline_period(
            jenv, JBL.BASELINES[name]), SEEDS)
        m = RO.evaluate(env, RO.make_baseline_period(env, BL.BASELINES[name]),
                        SEEDS)
        mb = RO.evaluate_batch_baseline(env, BL.BASELINES[name], SEEDS)
    assert m.keys() == jm.keys() == mb.keys()
    for k in jm:
        assert m[k] == pytest.approx(jm[k], rel=1e-5), k
        assert m[k] == pytest.approx(mb[k], rel=1e-5), k
    for k in ("counted", "hits", "arrived"):
        assert m[k] == jm[k] == mb[k], k


def test_magma_through_the_period_runner_matches_the_batch(envs):  # noqa: F811
    """MAGMA at population 4, 2 generations: the per-period runner and
    the batched runner at batch 1 draw the same generations from
    generators of one seed."""
    env = envs[1]
    magma = BL.make_magma_baseline(BL.MagmaConfig(population=4,
                                                  generations=2))
    m, _ = RO.run_episode(env, RO.make_baseline_period(env, magma),
                          np.random.default_rng(5),
                          gen=torch.Generator().manual_seed(11))
    traces, states = RO.stack_episodes(env, [5])
    mb = RO.make_baseline_episode_batch(env, magma)(
        states, traces, torch.Generator().manual_seed(11))
    assert m == {k: float(v[0]) for k, v in mb.items()}


# ---------------------------------------------------------------------------
# the segment engine, commit_period_np
# ---------------------------------------------------------------------------
ENGINE_ARGS = ("valid", "assign", "prio", "cost", "bw", "dep", "ready",
               "sa_free")


@pytest.mark.parametrize("S,n,M", [(4, 2, 1), (6, 12, 4), (3, 32, 6),
                                   (2, 96, 6)])
def test_simulate_segments_matches_jax_and_simulate(S, n, M):
    sc = TE._draw(n * 7 + M, S, n, M)
    args = [torch.as_tensor(sc[k]) for k in ENGINE_ARGS]
    start, finish = (x.numpy() for x in simulate_segments(
        *args, float(sc["B"]), num_sas=M))
    s1, f1 = (x.numpy() for x in engine.simulate(*args, float(sc["B"]),
                                                  num_sas=M))
    np.testing.assert_array_equal(start, s1)
    np.testing.assert_array_equal(finish, f1)
    for s in range(S):
        sj, fj = simulate_jax_segments(
            *(jnp.asarray(sc[k][s]) for k in ENGINE_ARGS),
            jnp.float32(sc["B"]), num_sas=M)
        sj, fj = np.asarray(sj), np.asarray(fj)
        np.testing.assert_array_equal(start[s] < TE.INF / 2, sj < TE.INF / 2)
        np.testing.assert_array_equal(finish[s] < TE.INF / 2,
                                      fj < TE.INF / 2)
        np.testing.assert_allclose(start[s], sj, rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(finish[s], fj, rtol=1e-5, atol=1e-3)


def test_simulate_segments_refuses_the_early_exit():
    sc = TE._draw(1, 2, 8, 3)
    args = [torch.as_tensor(sc[k]) for k in ENGINE_ARGS]
    with pytest.raises(ValueError, match="stop_start_after"):
        simulate_segments(*args, float(sc["B"]), num_sas=3,
                          stop_start_after=250.0)
    with pytest.raises(ValueError, match="stop_start_after"):
        simulate_jax_segments(*(jnp.asarray(sc[k][0]) for k in ENGINE_ARGS),
                              jnp.float32(sc["B"]), num_sas=3,
                              stop_start_after=250.0)


def test_episode_with_the_segment_engine_swapped_in(envs,  # noqa: F811
                                                    monkeypatch):
    """The reference benchmark's module-level swap: ``SchedulingEnv``
    reads ``engine.simulate`` at call time."""
    env, dcfg, jstate = envs[1], envs[3], envs[4]
    calls = []

    def segments(*a, **k):
        calls.append(1)
        return simulate_segments(*a, **k)

    def run():
        return RO.run_episode(env, RO.make_policy_period(env, dcfg.policy),
                              np.random.default_rng(3),
                              params=_actor(jstate), collect=True)
    m, trans = run()
    monkeypatch.setattr(engine, "simulate", segments)
    ms, trans_s = run()
    assert len(calls) == KW["periods"]
    assert ms == m
    for a, b in zip(trans_s, trans):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_commit_period_np_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n, M, t_s = 24, 4, 500.0
    valid = rng.uniform(size=n) < 0.8
    assign = rng.integers(0, M, n)
    start = rng.uniform(0, 1000, n)
    finish = start + rng.uniform(1, 400, n)
    got = commit_period_np(start, finish, valid, assign, t_s, M)
    want = jax_commit_period_np(start, finish, valid, assign, t_s, M)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].any() and got[1].any()


# ---------------------------------------------------------------------------
# ddpg_update_scan, train_rounds_scan
# ---------------------------------------------------------------------------
def _ring_rows(env, dcfg, jstate, n):
    """``n`` transitions of port episodes as NumPy rows."""
    _, trans = RO.run_episode(env, RO.make_policy_period(env, dcfg.policy),
                              np.random.default_rng(8),
                              params=_actor(jstate), collect=True)
    rows = {k: np.stack([t[k] for t in trans]) for k in trans[0]}
    return {k: np.concatenate([v] * (n // len(v) + 1))[:n]
            for k, v in rows.items()}


def _assert_params(new, jnew, dcfg, U):
    for name, lr in (("actor", dcfg.actor_lr), ("critic", dcfg.critic_lr),
                     ("target_actor", dcfg.tau * dcfg.actor_lr),
                     ("target_critic", dcfg.tau * dcfg.critic_lr)):
        for g, w in zip(D.tree_leaves(getattr(new, name)),
                        jax.tree.leaves(getattr(jnew, name))):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=2 * lr * U + 1e-5
                                       * np.abs(w).max())


def test_ddpg_update_scan_matches_jax(envs):  # noqa: F811
    """Three updates of 4 rows on the indices JAX samples from its key;
    the buffer comes back as the same object, unchanged."""
    jenv, env, jdcfg, dcfg, jstate = envs
    cap, n, U, bs = 16, 12, 3, 4
    rows = _ring_rows(env, dcfg, jstate, n)
    jbuf = JR.replay_add(JR.replay_init(cap, env.seq_len, env.feat_dim,
                                        env.act_dim),
                         jax.tree.map(jnp.asarray, rows))
    key = jax.random.PRNGKey(21)
    idx = np.stack([np.asarray(jax.random.randint(k, (bs,), 0, n))
                    for k in jax.random.split(key, U)])
    jnew, _, jinfos = JD.ddpg_update_scan(jax.tree.map(jnp.copy, jstate),
                                          jdcfg, jbuf, key, num_updates=U,
                                          batch_size=bs)
    buf = replay_add(replay_init(cap, env.seq_len, env.feat_dim,
                                 env.act_dim, "cpu"),
                     {k: torch.as_tensor(v) for k, v in rows.items()})
    before = {k: v.clone() if torch.is_tensor(v) else v
              for k, v in buf.items()}
    state = D.ddpg_state_from_numpy(TT._np(jstate), dcfg, device="cpu")
    new, out, infos = D.ddpg_update_scan(state, dcfg, buf, None, U, bs,
                                         idx=torch.as_tensor(idx))
    assert out is buf and out.keys() == before.keys()
    for k, v in before.items():
        assert (torch.equal(out[k], v) if torch.is_tensor(v)
                else out[k] == v), k
    for k in TR.INFO_KEYS:
        assert infos[k].shape == (U,)
        np.testing.assert_allclose(infos[k].numpy(), np.asarray(jinfos[k]),
                                   atol=1e-5, rtol=1e-3)
    _assert_params(new, jnew, dcfg, U)
    assert new.step == int(jnew.step) == U


def test_ddpg_update_scan_samples_from_the_generator(envs):  # noqa: F811
    """Without ``idx`` the indices are ``sample_indices`` draws, one an
    update, from ``gen``: the same updates as on those indices."""
    env, dcfg, jstate = envs[1], envs[3], envs[4]
    rows = _ring_rows(env, dcfg, jstate, 10)
    buf = replay_add(replay_init(16, env.seq_len, env.feat_dim,
                                 env.act_dim, "cpu"),
                     {k: torch.as_tensor(v) for k, v in rows.items()})
    state = D.ddpg_state_from_numpy(TT._np(jstate), dcfg, device="cpu")
    gen = torch.Generator().manual_seed(4)
    idx = torch.stack([sample_indices(buf, 4, gen) for _ in range(2)])
    assert int(idx.max()) < 10
    a, _, ia = D.ddpg_update_scan(state, dcfg, buf,
                                  torch.Generator().manual_seed(4), 2, 4)
    b, _, ib = D.ddpg_update_scan(state, dcfg, buf, None, 2, 4, idx=idx)
    assert a.step == b.step == 2
    for k in TR.INFO_KEYS:
        torch.testing.assert_close(ia[k], ib[k], rtol=0, atol=0)
    for x, y in zip(D.tree_leaves(a.actor), D.tree_leaves(b.actor)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_train_rounds_scan_matches_jax_and_the_host_loop(envs):  # noqa: F811
    """Two rounds, a warm-up and an update round, on the draws the JAX
    rounds take from their keys."""
    jenv, env, jdcfg, dcfg, jstate = envs
    kw = TT.ROUND_KW
    cap, sigma = 64, np.float32(0.3)
    n = kw["batch_episodes"] * KW["periods"]
    keys = jax.random.split(jax.random.PRNGKey(13), 2)
    do_update = [False, True]
    jnew, jbuf, jsigma, jm = JTR.train_rounds_scan(
        jenv, jdcfg, jax.tree.map(jnp.copy, jstate),
        JR.replay_init(cap, jenv.seq_len, jenv.feat_dim, jenv.act_dim),
        keys, jnp.float32(sigma), jnp.asarray(do_update), **kw)
    draws = [TT._jax_round_draws(jenv, keys[i], kw["batch_episodes"],
                                 kw["num_updates"], kw["batch_size"],
                                 min(n * (i + 1), cap)) for i in range(2)]
    draws_fn = lambda env, seed, **_: draws[seed]
    out = {}
    for name, fn in (("scan", TR.train_rounds_scan),
                     ("host", TR.train_rounds_host)):
        state = D.ddpg_state_from_numpy(TT._np(jstate), dcfg, device="cpu")
        buf = replay_init(cap, env.seq_len, env.feat_dim, env.act_dim, "cpu")
        out[name] = fn(env, dcfg, state, buf, [0, 1], float(sigma),
                       do_update, draws_fn=draws_fn, **kw)
    new, buf, sig, m = out["scan"]
    assert sig == float(jsigma)
    assert buf["size"] == int(jbuf["size"]) == 2 * n
    TT._assert_trans({k: buf[k] for k in ("s", "mask", "a", "r", "s2",
                                          "mask2")}, jbuf)
    assert list(m["did_update"]) == do_update
    np.testing.assert_array_equal(m["sla"], np.asarray(jm["sla"]))
    for k in ("reward", "energy_uj", "sigma"):
        np.testing.assert_allclose(m[k], np.asarray(jm[k]), rtol=1e-5)
    for k in TR.INFO_KEYS:
        np.testing.assert_allclose(m[k], np.asarray(jm[k]), rtol=1e-4,
                                   atol=1e-6)
    _assert_params(new, jnew, dcfg, kw["num_updates"])
    assert new.step == int(jnew.step) == kw["num_updates"]
    hnew, hbuf, hsig, hm = out["host"]
    assert hsig == sig and hm.keys() == m.keys()
    for k in m:
        np.testing.assert_array_equal(hm[k], m[k])
    for x, y in zip(D.tree_leaves(hnew.actor) + D.tree_leaves(hnew.critic),
                    D.tree_leaves(new.actor) + D.tree_leaves(new.critic)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the quickstart's counterpart
# ---------------------------------------------------------------------------
def test_torch_quickstart_runs_on_the_cpu_without_jax():
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "sys.argv = ['torch_quickstart.py', '--device', 'cpu']\n"
            "runpy.run_path(sys.argv[0], run_name='__main__')\n"
            "assert 'jax' not in [k for k, v in sys.modules.items() if v]\n")
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=ROOT / "examples", timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
             "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    sla = [line for line in lines if "SLA satisfaction" in line]
    assert [line.split(":")[0].strip() for line in sla] == [
        "fcfs", "prema", "herald", "relmas"]
    assert all(0.0 <= float(line.split()[3]) <= 1.0 for line in sla)
    upd = [line for line in lines if line.startswith("after 10 updates:")]
    assert len(upd) == 1 and "critic_loss=" in upd[0] and "q_mean=" in upd[0]
    assert "lstm_cell launches: 0" in lines       # the CPU: plain versions
