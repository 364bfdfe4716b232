"""The port's training path (arrivals on the device, whole episodes,
collection, evaluation, the round, the driver and checkpoints) against
the JAX package.

Randomness crosses as data: NumPy traces, or the draws the JAX round
takes from its key (traces, the noise block, the replay indices), go
into both packages.  Tolerances:
- arrival twins against the NumPy generators: distributional, the
  reference's own (tests/test_train_fused.py): live jobs and budgets
  within 10%, mean inter-arrival within 10% (25% for the alpha = 1.2
  Pareto, whose variance is infinite);
- episodes and evaluation: ``counted`` and ``hits`` equal, masks equal,
  features, actions, rewards and energy within 1e-5 (float32 sums in
  another order);
- one round: the same, plus the last update's losses, ``q_mean`` and
  ``target_mean`` within rtol 1e-4, and parameters within
  2 * lr * num_updates + 1e-5 * |p| (each Adam step may flip the sign of
  a ~0 gradient element; see tests/test_torch_ddpg.py).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JCheckpointManager
from repro.ckpt import restore_checkpoint as jax_restore
from repro.ckpt import save_checkpoint as jax_save
from repro.core import baselines as JBL
from repro.core import ddpg as JD
from repro.core import policy as JP
from repro.core import replay as JR
from repro.core import rollout as JRO
from repro.core.train import make_train_round
from repro.sim.arrivals import ArrivalConfig as JArrivalConfig
from repro.sim.arrivals import generate_traces_jax
from repro.sim.env import EnvConfig as JEnvConfig
from repro.sim.env import SchedulingEnv as JEnv
from repro.workloads import build_registry as jax_build_registry
from repro_torch.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.core import baselines as BL
from repro_torch.core import ddpg as D
from repro_torch.core import policy as P
from repro_torch.core import rollout as RO
from repro_torch.core import train as TR
from repro_torch.core.replay import replay_init
from repro_torch.launch import rl_train
from repro_torch.sim.arrivals import (SCENARIOS, ArrivalConfig,
                                      generate_trace_torch, generate_traces,
                                      generate_traces_torch, scenario_preset)
from repro_torch.sim.env import EnvConfig, SchedulingEnv
from repro_torch.telemetry import validate_record
from repro_torch.workloads import build_registry

torch.set_num_threads(1)
KW = dict(periods=6, max_rq=16, max_jobs=8)
HIDDEN = 8
ROUND_KW = dict(batch_episodes=2, num_updates=3, batch_size=8,
                sigma_min=0.05, sigma_decay=0.97)
TOL = dict(atol=1e-5, rtol=1e-5)
SMOKE = ["--workload", "light", "--episodes", "4", "--batch-episodes", "2",
         "--periods", "6", "--max-rq", "16", "--max-jobs", "8",
         "--hidden", "8", "--updates-per-episode", "2", "--batch-size", "8",
         "--replay-capacity", "64", "--warmup-episodes", "2",
         "--eval-every", "100", "--eval-seeds", "2", "--ckpt-every", "2",
         "--device", "cpu"]


def _arrivals(cfg):
    return dict(max_jobs=cfg.max_jobs, horizon_us=cfg.horizon_us,
                slack_us=2 * cfg.t_s_us)


@pytest.fixture(scope="module")
def envs():
    jcfg, cfg = JEnvConfig(**KW), EnvConfig(**KW)
    jenv = JEnv(jax_build_registry("light"), jcfg,
                JArrivalConfig(**_arrivals(jcfg)))
    env = SchedulingEnv(build_registry("light"), cfg,
                        ArrivalConfig(**_arrivals(cfg)), device="cpu")
    jdcfg = JD.DDPGConfig(policy=JP.PolicyConfig(
        feat_dim=jenv.feat_dim, act_dim=jenv.act_dim, hidden=HIDDEN))
    dcfg = D.DDPGConfig(policy=P.PolicyConfig(
        feat_dim=env.feat_dim, act_dim=env.act_dim, hidden=HIDDEN))
    jstate = JD.init_ddpg(jax.random.PRNGKey(0), jdcfg)
    return jenv, env, jdcfg, dcfg, jstate


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return D.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


# ---------------------------------------------------------------------------
# arrivals drawn on the device against the NumPy oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_generate_traces_torch_matches_numpy_distribution(envs, scenario):
    env = envs[1]
    cfg = scenario_preset(scenario, max_jobs=64, horizon_us=30_000.0,
                          slack_us=1000.0)
    tt = generate_traces_torch(env.min_lat, cfg,
                               torch.Generator().manual_seed(0), 256)
    nt = generate_traces(env.min_lat, cfg, np.random.default_rng(0), 256)

    def stats(tr):
        a = np.asarray(tr["arrival"], np.float64)
        live = a < 1e29
        inter = np.concatenate([np.diff(a[i][live[i]])
                                for i in range(a.shape[0])])
        return (live.sum(1).mean(), inter.mean(),
                np.asarray(tr["q"], np.float64)[live].mean())

    live_t, ia_t, q_t = stats(tt)
    live_n, ia_n, q_n = stats(nt)
    tol = 0.25 if scenario == "heavy_tail" else 0.1
    assert live_t == pytest.approx(live_n, rel=0.1)
    assert ia_t == pytest.approx(ia_n, rel=tol)
    assert q_t == pytest.approx(q_n, rel=0.1)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_generate_traces_torch_valid_and_deterministic(envs, scenario):
    env = envs[1]
    cfg = scenario_preset(scenario, max_jobs=16, horizon_us=1800.0,
                          slack_us=1000.0)
    draw = lambda: generate_traces_torch(env.min_lat, cfg,
                                         torch.Generator().manual_seed(3), 4)
    tr = draw()
    a = tr["arrival"].numpy()
    live = a < 1e29
    assert live.sum() > 0 and tr["model"].dtype == torch.int64
    for i in range(4):
        ai = a[i][live[i]]
        assert ai[0] == 0.0 and (np.diff(ai) >= 0).all()
    assert (tr["q"].numpy()[live] > 0).all()
    assert (tr["deadline"].numpy()[live] >= a[live]).all()
    np.testing.assert_array_equal(draw()["arrival"].numpy(), a)
    assert not np.array_equal(a[0], a[1])
    one = generate_trace_torch(env.min_lat, cfg,
                               torch.Generator().manual_seed(3))
    assert one["arrival"].shape == (16,) and one["model"].shape == (16,)


def test_new_episodes_torch_state_matches_trace(envs):
    env = envs[1]
    traces, states = env.new_episodes_torch(torch.Generator().manual_seed(1),
                                            3)
    assert traces["arrival"].shape == (3, KW["max_jobs"])
    assert traces["njl"].shape == states["nls"].shape == (3, KW["max_jobs"])
    torch.testing.assert_close(states["jready"], traces["arrival"])
    t2, s2 = env.new_episodes(np.random.default_rng(0), 3)
    np.testing.assert_array_equal(
        t2["arrival"].numpy(),
        generate_traces(env.min_lat, env.arrivals, np.random.default_rng(0),
                        3)["arrival"])


# ---------------------------------------------------------------------------
# whole episodes, collection, evaluation
# ---------------------------------------------------------------------------
def _numpy_traces(env, seed, batch):
    return generate_traces(env.min_lat, env.arrivals,
                           np.random.default_rng(seed), batch)


def _assert_trans(trans, jtrans):
    for k in ("mask", "mask2"):
        np.testing.assert_array_equal(trans[k].numpy(), np.asarray(jtrans[k]))
    for k in ("s", "a", "r", "s2"):
        np.testing.assert_allclose(trans[k].numpy(), np.asarray(jtrans[k]),
                                   **TOL)


def _assert_metrics(mets, jmets):
    for k in ("hits", "counted", "arrived"):
        np.testing.assert_array_equal(mets[k].numpy(), np.asarray(jmets[k]))
    np.testing.assert_allclose(mets["energy_uj"].numpy(),
                               np.asarray(jmets["energy_uj"]), rtol=1e-5)


def test_collect_episodes_matches_jax(envs):
    """Three episodes on NumPy traces, with the noise block the JAX
    collector draws from its key passed in."""
    jenv, env, jdcfg, dcfg, jstate = envs
    tr = _numpy_traces(env, 5, 3)
    jtraces = jenv._finish_trace(tr)
    jstates = jax.vmap(jenv.init_state)(jtraces)
    key, sigma = jax.random.PRNGKey(9), 0.3
    _, jtrans, jinfos, jmets = jax.jit(
        lambda p, s, t, k: JRO.collect_episodes(
            jenv, jdcfg.policy, p, s, t, k, sigma))(
        jstate.actor, jstates, jtraces, key)
    z = jax.random.normal(key, (3, KW["periods"], KW["max_rq"],
                                jenv.act_dim))
    traces = env.to_trace(tr)
    _, trans, infos, mets = RO.collect_episodes(
        env, dcfg.policy, _t(_np(jstate.actor)), env.init_state(traces),
        traces, None, sigma, noise=torch.tensor(np.asarray(z)))
    assert trans["s"].shape == (3, KW["periods"], env.seq_len, env.feat_dim)
    _assert_trans(trans, jtrans)
    _assert_metrics(mets, jmets)
    np.testing.assert_array_equal(infos["committed"].numpy(),
                                  np.asarray(jinfos["committed"]))
    np.testing.assert_allclose(infos["reward"].numpy(),
                               np.asarray(jinfos["reward"]), **TOL)


def test_episode_with_a_baseline_matches_jax(envs):
    jenv, env = envs[:2]
    tr = _numpy_traces(env, 6, 2)
    jtraces = jenv._finish_trace(tr)

    def jone(state, trace):
        return jenv.episode(state, trace,
                            lambda f, m, sl, st, k, a: JBL.herald(sl, st,
                                                                  jenv))
    _, jtrans, _, jmets = jax.jit(jax.vmap(jone))(
        jax.vmap(jenv.init_state)(jtraces), jtraces)
    traces = env.to_trace(tr)
    _, trans, _, mets = env.episode(
        env.init_state(traces), traces,
        lambda f, m, sl, st, a: BL.herald(sl, st, env))
    _assert_trans(trans, jtrans)
    _assert_metrics(mets, jmets)


def test_evaluate_batch_matches_jax(envs):
    """Carried weights, NumPy eval traces from the seeds in both."""
    jenv, env, jdcfg, dcfg, jstate = envs
    seeds = range(7000, 7003)
    jm = JRO.evaluate_batch(jenv, jdcfg.policy, jstate.actor, seeds)
    m = RO.evaluate_batch(env, dcfg.policy, _t(_np(jstate.actor)), seeds)
    jb = JRO.evaluate_batch_baseline(jenv, JBL.BASELINES["fcfs"], seeds)
    b = RO.evaluate_batch_baseline(env, BL.BASELINES["fcfs"], seeds)
    for got, want in ((m, jm), (b, jb)):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5), k


# ---------------------------------------------------------------------------
# one training round
# ---------------------------------------------------------------------------
def _jax_round_draws(jenv, key, batch_episodes, num_updates, batch_size,
                     size_after, device=None, min_lat=None):
    """What the JAX round takes from its key (train.py:137); with
    ``device``, what device ``device`` of a sharded round takes from
    ``fold_in(key, device)`` (train.py:370), ``size_after`` then being
    its read ring's size and the counts its shares; ``min_lat`` a
    generalist fleet's table."""
    if device is not None:
        key = jax.random.fold_in(key, device)
    ktrace, kroll, kup = jax.random.split(key, 3)
    tr = generate_traces_jax(jenv.min_lat if min_lat is None else min_lat,
                             jenv.arrivals, ktrace, batch_episodes)
    z = jax.random.normal(kroll, (batch_episodes, KW["periods"],
                                  KW["max_rq"], jenv.act_dim))
    idx = [jax.random.randint(k, (batch_size,), 0, max(size_after, 1))
           for k in jax.random.split(kup, num_updates)]
    return dict(traces=_np(tr), noise=torch.tensor(np.asarray(z)),
                idx=torch.tensor(np.stack([np.asarray(i) for i in idx])))


def test_round_body_matches_jax_round(envs):
    jenv, env, jdcfg, dcfg, jstate = envs
    cap, sigma = 64, np.float32(0.3)
    n = ROUND_KW["batch_episodes"] * KW["periods"]
    key = jax.random.PRNGKey(5)
    jnew, jbuf, jsigma, jm = make_train_round(jenv, jdcfg, **ROUND_KW)(
        jax.tree.map(jnp.copy, jstate),
        JR.replay_init(cap, jenv.seq_len, jenv.feat_dim, jenv.act_dim),
        key, jnp.float32(sigma), jnp.bool_(True))
    draws = _jax_round_draws(jenv, key, ROUND_KW["batch_episodes"],
                             ROUND_KW["num_updates"], ROUND_KW["batch_size"],
                             min(n, cap))
    state = D.ddpg_state_from_numpy(_np(jstate), dcfg, device="cpu")
    buf = replay_init(cap, env.seq_len, env.feat_dim, env.act_dim, "cpu")
    new, buf, sig, m = TR._round_body(env, dcfg, **ROUND_KW)(
        state, buf, draws, float(sigma), True)
    assert sig == float(jsigma)
    assert buf["ptr"] == int(jbuf["ptr"]) and buf["size"] == int(jbuf["size"])
    _assert_trans({k: buf[k] for k in ("s", "mask", "a", "r", "s2",
                                       "mask2")}, jbuf)
    assert m["sla"] == float(jm["sla"]) and m["did_update"]
    for k in ("reward", "energy_uj"):
        assert m[k] == pytest.approx(float(jm[k]), rel=1e-5), k
    for k in TR.INFO_KEYS:
        assert m[k] == pytest.approx(float(jm[k]), rel=1e-4, abs=1e-6), k
    U = ROUND_KW["num_updates"]
    for name, lr in (("actor", dcfg.actor_lr), ("critic", dcfg.critic_lr),
                     ("target_actor", dcfg.tau * dcfg.actor_lr),
                     ("target_critic", dcfg.tau * dcfg.critic_lr)):
        for g, w in zip(D.tree_leaves(getattr(new, name)),
                        jax.tree.leaves(getattr(jnew, name))):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=2 * lr * U + 1e-5 * np.abs(w).max())
    assert new.step == int(jnew.step) == U


def test_round_keys_resume_continuity_and_warmup_round(envs):
    env, dcfg = envs[1], envs[3]
    assert TR.round_keys(1, 2, 3) == TR.round_keys(1, 0, 5)[2:]
    assert len(set(TR.round_keys(1, 0, 5))) == 5
    assert TR.round_keys(1, 0, 2) != TR.round_keys(2, 0, 2)

    def run(seed):
        state = D.init_ddpg(torch.Generator().manual_seed(0), dcfg, "cpu")
        buf = replay_init(64, env.seq_len, env.feat_dim, env.act_dim, "cpu")
        return TR.make_train_round(env, dcfg, **ROUND_KW)(state, buf, seed,
                                                          0.3, False)
    (s1, b1, _, m1), (_, b2, _, m2) = run(7), run(7)
    assert m1 == m2 and not m1["did_update"] and s1.step == 0
    assert all(m1[k] == 0.0 for k in TR.INFO_KEYS)
    torch.testing.assert_close(b1["s"], b2["s"])
    assert b1["size"] == ROUND_KW["batch_episodes"] * KW["periods"]


# ---------------------------------------------------------------------------
# the driver, checkpoints both ways
# ---------------------------------------------------------------------------
def test_driver_crash_resume_continues_the_stream(tmp_path, capsys):
    """README smoke size on the CPU: ``--fail-at 2`` crashes after the
    first round's checkpoint; the rerun resumes and its round draws what
    the uninterrupted run's drew (equal rollout SLA and sigma)."""
    out = str(tmp_path / "run")
    with pytest.raises(RuntimeError, match="injected failure"):
        rl_train.main(SMOKE + ["--outdir", out, "--fail-at", "2"])
    res = rl_train.main(SMOKE + ["--outdir", out,
                                 "--eval-baselines", "fcfs,prema,herald"])
    assert "[resume] restored checkpoint at episode 1" in capsys.readouterr().out
    ref = rl_train.main(SMOKE + ["--outdir", str(tmp_path / "ref")])
    assert [h["episode"] for h in res["history"]] == [3]
    assert [h["episode"] for h in ref["history"]] == [1, 3]
    for k in ("sla", "sigma"):
        assert res["history"][0][k] == ref["history"][1][k]
    assert set(res["baselines"]) == {"fcfs", "prema", "herald"}
    assert res["state"].step == ref["state"].step == 4    # round 0 warms up
    # the best actor, written as the reference writes it
    jactor = JP.init_actor(jax.random.PRNGKey(0), JP.PolicyConfig(
        feat_dim=16, act_dim=7, hidden=8))
    tree, step, meta = jax_restore(str(tmp_path / "run" / "best"), jactor)
    assert step == 3 and meta["policy_kind"] == "specialist"
    np.testing.assert_array_equal(tree["lstm"]["wx"],
                                  res["state"].actor["lstm"]["wx"].numpy())


def test_driver_rejects_what_is_not_ported(tmp_path):
    """Every path of the reference's driver runs: multi-device rounds
    (A11a) on two gloo ranks (tests/test_torch_sharded_driver.py),
    telemetry (A9) with a valid stream and a trace, churn, MAGMA and the
    generalist (tests/test_torch_churn.py, test_torch_magma.py,
    test_torch_generalist.py, test_torch_telemetry_paths.py); bad flag
    values raise."""
    base = SMOKE + ["--outdir", str(tmp_path / "x")]
    res = rl_train.main(SMOKE + ["--outdir", str(tmp_path / "d2"),
                                 "--devices", "2"])
    assert [h["episode"] for h in res["history"]] == [1, 3]
    assert res["state"].step == 4
    stream, trace = tmp_path / "m.jsonl", tmp_path / "p"
    for extra in (["--log-jsonl", str(stream)],
                  ["--profile-dir", str(trace)]):
        rl_train.main(SMOKE + ["--outdir", str(tmp_path / extra[0][2:])]
                      + extra)
    recs = [validate_record(json.loads(line))
            for line in stream.read_text().splitlines()]
    assert [r["kind"] for r in recs if r["kind"] != "span"] == [
        "run_header", "train_round", "train_round", "train_eval",
        "run_end"]
    assert [r["episode"] for r in recs if r["kind"] == "train_round"] \
        == [1, 3]
    assert len(list(trace.glob("*.pt.trace.json"))) == 1
    for extra, msg in ((["--churn", "sometimes"], "--churn"),
                       (["--eval-baselines", "fcfs,random"], "random")):
        with pytest.raises(ValueError, match=msg):
            rl_train.main(base + extra)
    res = rl_train.main(base + ["--churn", "fail", "--eval-baselines",
                                "herald,magma", "--magma-population", "4",
                                "--magma-generations", "2"])
    assert set(res["baselines"]) == {"herald", "magma"}
    assert res["policy_kind"] == "specialist"


def _assert_same_state(state, jstate):
    for name in ("actor", "critic", "target_actor", "target_critic",
                 "actor_opt", "critic_opt"):
        got, want = getattr(state, name), getattr(jstate, name)
        got = D.tree_leaves(got)
        want = jax.tree.leaves(want)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert int(state.step) == int(jstate.step)


def test_jax_learner_checkpoint_restores_in_the_port(envs, tmp_path):
    """A JAX ``rl_train``-style ``ckpt/`` directory (a whole
    ``DDPGState``, keys ``[<flat index i>]...``) read by the port: with
    and without ``like``, and by the port's driver on resume."""
    jenv, env, jdcfg, dcfg, jstate = envs
    jstate = jax.tree.map(lambda x: x + 0.5, jstate)       # not the init
    d = str(tmp_path / "run" / "ckpt")
    JCheckpointManager(d).save(1, jstate, dict(
        episode=1, fleet="paper6", policy_kind="specialist", hidden=HIDDEN,
        feat_dim=16, act_dim=7, churn="none"))
    tree, step, meta = restore_checkpoint(d)
    assert step == 1 and meta["episode"] == 1 and set(tree) == set(range(7))
    _assert_same_state(D.ddpg_state_from_numpy(tree, dcfg, device="cpu"),
                       _np(jstate))
    like = D.init_ddpg(torch.Generator().manual_seed(0), dcfg, "cpu")
    tree, _, _ = restore_checkpoint(d, like)
    assert isinstance(tree, D.DDPGState) and tree.step == int(jstate.step)
    _assert_same_state(tree, _np(jstate))
    res = rl_train.main(SMOKE + ["--outdir", str(tmp_path / "run"),
                                 "--eval-seeds", "1"])
    assert [h["episode"] for h in res["history"]] == [3]
    assert res["state"].step == int(jstate.step) + 4


def test_port_learner_checkpoint_restores_in_jax(envs, tmp_path):
    jenv, env, jdcfg, dcfg, jstate = envs
    state = D.init_ddpg(torch.Generator().manual_seed(3), dcfg, "cpu")
    state.step = 5
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 9, state, dict(episode=9))
    tree, step, meta = jax_restore(d, like=jstate)
    assert step == 9 and meta == {"episode": 9}
    assert isinstance(tree, JD.DDPGState)
    _assert_same_state(state, tree)
    with pytest.raises(KeyError, match="missing"):
        restore_checkpoint(d, like={"other": np.zeros(3)})
    bad = D.init_ddpg(torch.Generator().manual_seed(3), D.DDPGConfig(
        policy=P.PolicyConfig(feat_dim=16, act_dim=7, hidden=4)), "cpu")
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(d, like=bad)
    jax_save(str(tmp_path / "j"), 2, {"a": {"b": jnp.ones(3)}}, {})
    assert restore_checkpoint(str(tmp_path / "j"))[0]["a"]["b"].shape == (3,)
