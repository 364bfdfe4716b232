"""The port's sharded rounds: the in-process oracle against the JAX
package's vmap oracle (``sharded_rounds_reference``, one CPU device) on
the draws JAX's per-device keys give, the specialist and the
generalist, in the gathered-batch and the local-sample topologies
(``update_gather``), then two gloo ranks on the CPU against the port's
oracle, and the divisibility checks.

Randomness crosses as data (tests/test_torch_train.py's
``_jax_round_draws`` at ``fold_in(key, d)``).  Tolerances, those of
tests/test_torch_train.py for a round: ``sla``, ``counted``, ``hits``,
the masks, the ring bookkeeping (``ptr``, ``size``, ``pending_n``) and
the telemetry counts equal; ring values, reward and energy within 1e-5
(float32 sums in another order: features, actions and rewards land 1-2
ulps from JAX's, up to 2.4e-7 here, as in that file's one round); the
last update's losses within rtol 1e-4; parameters within 2 lr per
update.  Ranks against the port's oracle: bit-equal (the same
arithmetic in the same order), replicas bit-equal to each other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ddpg as JD
from repro.core import generalist as JG
from repro.core import replay as JR
from repro.core import train as JT
from repro.sim.arrivals import ArrivalConfig as JArrivalConfig
from repro.sim.env import EnvConfig as JEnvConfig
from repro_torch.core import ddpg as D
from repro_torch.core import generalist as G
from repro_torch.core import train as TR
from repro_torch.core.generalist import train as GT
from repro_torch.core.replay import (replay_fields, replay_init,
                                     replay_pair_init)
from repro_torch.launch import rl_train
from repro_torch.sim.arrivals import ArrivalConfig
from repro_torch.sim.env import EnvConfig
from test_torch_train import KW, _jax_round_draws, _np, envs  # noqa: F401

torch.set_num_threads(1)
ND = 2
SKW = dict(batch_episodes=4, num_updates=3, batch_size=8, sigma_min=0.05,
           sigma_decay=0.97)
CAP, ROUND = 16, (4 // ND) * KW["periods"]    # per device: wraps in round 2
FLAGS = [False, True, True]
FLEETS = ("paper6", "2simba_2eyeriss")
# the rounds on spawned ranks: a test's own limit, the ranks killed past it
RANK_TIMEOUT_S = 120


def _stack(tree):
    return jax.tree.map(lambda x: jnp.stack([x] * ND), tree)


def _jax_sharded(jfn, jstate, jring, keys, shared=False):
    """JAX's oracle over the rounds of ``keys`` from ``jstate`` and a
    fresh pair over ``jring`` on every device."""
    dkeys = JT.shard_round_keys(keys, ND)
    pair = _stack(JR.replay_pair_init(jring, ROUND))
    args = (_stack(jax.tree.map(jnp.copy, jstate)), pair, dkeys) \
        + ((keys,) if shared else ()) \
        + (jnp.stack([jnp.float32(0.4)] * ND), jnp.asarray(FLAGS))
    return jfn(*args), dkeys


def _port_rounds(body, state, pairs, draws_of):
    """The port's sharded body round by round on the draws
    ``draws_of(round, device, read size)`` gives."""
    sigma, out = 0.4, []
    for i, du in enumerate(FLAGS):
        draws = [draws_of(i, d, p["read"]["size"])
                 for d, p in enumerate(pairs)]
        state, pairs, sigma, m = body(state, pairs, draws, sigma, du,
                                      TR.StackedShards(ND))
        out.append(m)
    return state, pairs, sigma, out


def _assert_rings(pairs, jpair):
    for d, p in enumerate(pairs):
        assert p["pending_n"] == int(jpair["pending_n"][d]) == ROUND
        for ring in ("read", "write"):
            got, want = p[ring], jax.tree.map(lambda x: np.asarray(x[d]),
                                              jpair[ring])
            assert got["ptr"] == int(want["ptr"]), (d, ring)
            assert got["size"] == int(want["size"]), (d, ring)
            for k in replay_fields(got):
                if got[k].dtype in (torch.bool, torch.int64):
                    np.testing.assert_array_equal(got[k].numpy(), want[k],
                                                  err_msg=f"{d} {ring} {k}")
                else:
                    np.testing.assert_allclose(got[k].numpy(), want[k],
                                               atol=1e-5, rtol=1e-5,
                                               err_msg=f"{d} {ring} {k}")
        assert p["read"]["size"] == CAP


def _assert_metrics(out, jm, extra=()):
    for i, m in enumerate(out):
        assert m["sla"] == float(jm["sla"][0, i]), i
        assert m["did_update"] == bool(jm["did_update"][0, i])
        assert m["sigma"] == float(jm["sigma"][0, i])
        for k in ("reward", "energy_uj"):
            assert m[k] == pytest.approx(float(jm[k][0, i]), rel=1e-5), k
        for k in TR.INFO_KEYS:
            assert m[k] == pytest.approx(float(jm[k][0, i]), rel=1e-4,
                                         abs=1e-6), (i, k)
        for k in ("tele_sla_hist", "tele_reward_hist", "tele_committed",
                  "tele_replay_fill") + extra:
            np.testing.assert_array_equal(np.asarray(m[k]),
                                          np.asarray(jm[k][0, i]), err_msg=k)


def _assert_params(state, jstate, dcfg, U):
    for name, lr in (("actor", dcfg.actor_lr), ("critic", dcfg.critic_lr),
                     ("target_actor", dcfg.tau * dcfg.actor_lr),
                     ("target_critic", dcfg.tau * dcfg.critic_lr)):
        for g, w in zip(D.tree_leaves(getattr(state, name)),
                        jax.tree.leaves(getattr(jstate, name))):
            w = np.asarray(w)
            for row in w:            # every replica of JAX's state
                np.testing.assert_allclose(
                    g.numpy(), row, rtol=0,
                    atol=2 * lr * U + 1e-5 * np.abs(row).max())
    assert state.step == U


def test_sharded_oracle_matches_jax(envs):
    """D = 2 over 3 rounds (a warm-up, then two of 3 updates), with
    telemetry, on the draws JAX's device keys give."""
    _check_specialist(envs, update_gather=True)


def test_local_sample_oracle_matches_jax(envs):
    """The local-sample topology (``update_gather=False``): each shard
    updates on its own read ring's rows and the gradients and infos are
    averaged, against JAX's ``pmean``'d oracle at D = 2 over 3 rounds,
    under the same criteria."""
    _check_specialist(envs, update_gather=False)


def _check_specialist(envs, update_gather: bool):
    jenv, env, jdcfg, dcfg, jstate = envs
    keys = JT.round_keys(7, 0, len(FLAGS))
    jfn = JT.sharded_rounds_reference(jenv, jdcfg, num_devices=ND,
                                      telemetry=True,
                                      update_gather=update_gather, **SKW)
    (js, jpair, _, jm), _ = _jax_sharded(
        jfn, jstate, JR.replay_init(CAP, jenv.seq_len, jenv.feat_dim,
                                    jenv.act_dim), keys)
    per = dict(batch_episodes=SKW["batch_episodes"] // ND,
               num_updates=SKW["num_updates"],
               batch_size=SKW["batch_size"] // ND)
    draws_of = lambda i, d, size: _jax_round_draws(
        jenv, keys[i], size_after=size, device=d, **per)
    state = D.ddpg_state_from_numpy(_np(jstate), dcfg, device="cpu")
    pairs = TR.replicate(replay_pair_init(replay_init(
        CAP, env.seq_len, env.feat_dim, env.act_dim, "cpu"), ROUND), ND)
    body = TR._sharded_round_body(env, dcfg, num_devices=ND, telemetry=True,
                                  update_gather=update_gather, **SKW)
    state, pairs, sigma, out = _port_rounds(body, state, pairs, draws_of)
    _assert_rings(pairs, jpair)
    _assert_metrics(out, jm)
    _assert_params(state, js, dcfg, 2 * SKW["num_updates"])


@pytest.fixture(scope="module")
def fleets():
    jcfg, cfg = JEnvConfig(**KW), EnvConfig(**KW)
    arr = lambda c: dict(max_jobs=c.max_jobs, horizon_us=c.horizon_us,
                         slack_us=2 * c.t_s_us)
    jenvs = JG.build_padded_envs("light", FLEETS, jcfg,
                                 JArrivalConfig(**arr(jcfg)))
    envs_ = G.build_padded_envs("light", FLEETS, cfg,
                                ArrivalConfig(**arr(cfg)), device="cpu")
    return jenvs, envs_


def test_sharded_generalist_oracle_matches_jax(fleets):
    """Two fleets, D = 2, 3 rounds: each round's fleet from the shared
    round key, every device's draws on that fleet from its own, the
    ``fleet`` ring column, descriptors re-attached after the gather."""
    _check_generalist(fleets, update_gather=True)


def test_local_sample_generalist_oracle_matches_jax(fleets):
    """The generalist's local-sample topology over the two fleets:
    descriptors re-attached to each shard's own rows, gradients
    averaged, against JAX's ``update_gather=False`` oracle."""
    _check_generalist(fleets, update_gather=False)


def _check_generalist(fleets, update_gather: bool):
    jenvs, envs_ = fleets
    spec = JG.GeneralistSpec(m_max=envs_[0].num_sas)
    jdcfg = JD.DDPGConfig(policy=spec.pcfg(hidden=8))
    dcfg = D.DDPGConfig(policy=G.GeneralistSpec(
        m_max=envs_[0].num_sas).pcfg(hidden=8))
    jstate = JD.init_ddpg(jax.random.PRNGKey(2), jdcfg)
    keys = JT.round_keys(11, 0, len(FLAGS))
    jfn = JG.sharded_generalist_rounds_reference(
        jenvs, jdcfg, num_devices=ND, telemetry=True,
        update_gather=update_gather, **SKW)
    (js, jpair, _, jm), _ = _jax_sharded(
        jfn, jstate, JG.generalist_replay_init(CAP, jenvs[0].seq_len, spec),
        keys, shared=True)
    stack = JG.stack_fleet_tables(jenvs)
    fleet = [int(jax.random.randint(k, (), 0, len(FLEETS))) for k in keys]
    per = dict(batch_episodes=SKW["batch_episodes"] // ND,
               num_updates=SKW["num_updates"],
               batch_size=SKW["batch_size"] // ND)

    def draws_of(i, d, size):
        f = fleet[i]
        return dict(fleet=f, **_jax_round_draws(
            jenvs[0], keys[i], size_after=size, device=d,
            min_lat=stack["min_lat"][f], **per))
    state = D.ddpg_state_from_numpy(_np(jstate), dcfg, device="cpu")
    pairs = TR.replicate(replay_pair_init(G.generalist_replay_init(
        CAP, envs_[0].seq_len, G.GeneralistSpec(m_max=envs_[0].num_sas),
        "cpu"), ROUND), ND)
    body = TR._sharded_round_body(envs_, dcfg, num_devices=ND,
                                  telemetry=True, update_gather=update_gather,
                                  **GT._generalist_parts(envs_, dcfg), **SKW)
    state, pairs, sigma, out = _port_rounds(body, state, pairs, draws_of)
    assert [m["fleet"] for m in out] == fleet
    # the port's own draws take the fleet from the shared seed alone
    pd = [GT.sharded_generalist_draws(envs_, s, 5, size_after=0, **per)
          for s in (1, 2)]
    assert pd[0]["fleet"] == pd[1]["fleet"]
    assert not torch.equal(pd[0]["noise"], pd[1]["noise"])
    _assert_rings(pairs, jpair)
    _assert_metrics(out, jm, extra=("fleet",))
    _assert_params(state, js, dcfg, 2 * SKW["num_updates"])


def _rank_job(kind, fleet):
    cfg = rl_train.TrainConfig(
        workload="light", fleet=fleet, hidden=8, batch_size=8,
        batch_episodes=4, replay_capacity=ND * CAP, device="cpu", **KW)
    run = rl_train._build_run(cfg, kind, fleet.split(","), None)
    state = D.init_ddpg(torch.Generator().manual_seed(0), run.dcfg, "cpu")
    kw = dict(SKW, telemetry=True)
    keys = TR.round_keys(3, 0, len(FLAGS))
    return run, state, keys, kw, dict(
        cfg=cfg, kind=kind, state=rl_train._state_to_numpy(state),
        keys=keys, sigma=0.4, flags=FLAGS, kw=kw)


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kind,fleet", [("specialist", "paper6"),
                                        ("generalist", ",".join(FLEETS))])
def test_two_gloo_ranks_match_the_oracle(kind, fleet):
    """``make_sharded_train_rounds`` on a ``DeviceMesh`` of 2 gloo ranks
    on the CPU: the replicas bit-equal to each other and to the
    oracle's learner, each rank's ring pair bit-equal to the oracle's
    shard, the reduced metrics equal; each rank imported only the
    port."""
    run, state, keys, kw, job = _rank_job(kind, fleet)
    ranks = [r[0] for r in rl_train.spawn_ranks(
        rl_train.sharded_rounds_rank, ND, [job], device="cpu",
        timeout=RANK_TIMEOUT_S)]
    pairs = TR.replicate(run.replay_init(CAP), ND)
    pairs = [replay_pair_init(p, ROUND) for p in pairs]
    if kind == "generalist":
        fn = G.sharded_generalist_rounds_reference(
            run.envs, run.dcfg, num_devices=ND, **kw)
        st, pairs, sigma, m = fn(state, pairs, TR.shard_round_keys(keys, ND),
                                 keys, 0.4, FLAGS)
    else:
        st, pairs, sigma, m = TR.sharded_rounds_reference(
            run.env, run.dcfg, num_devices=ND, **kw)(
            state, pairs, TR.shard_round_keys(keys, ND), 0.4, FLAGS)
    want = rl_train._state_to_numpy(st)
    assert _equal(ranks[0]["state"], ranks[1]["state"])
    assert _equal(ranks[0]["state"], want)
    for d, r in enumerate(ranks):
        assert r["loaded"] == [] and r["sigma"] == sigma
        for ring in ("read", "write"):
            assert _equal(r["pair"][ring], {
                k: v.numpy() if torch.is_tensor(v) else v
                for k, v in pairs[d][ring].items()}), (d, ring)
        assert _equal(r["metrics"], m)
    if kind == "generalist":
        assert set(m["fleet"]) <= {0, 1}


BAD = [(dict(batch_episodes=3), "--batch-episodes 3"),
       (dict(batch_episodes=2, batch_size=9), "--batch-size 9"),
       (dict(batch_episodes=2, replay_capacity=121), "--replay-capacity 121"),
       (dict(batch_episodes=2, episodes=5), "multiple of"),
       (dict(batch_episodes=2, churn="fail"), "single-device feature"),
       (dict(batch_episodes=2, device="cuda"),
        r"torch.cuda.device_count\(\) = 0"),
       (dict(devices=0), "--devices must be >= 1")]


@pytest.mark.parametrize("kw,msg", BAD, ids=[m for _, m in BAD])
def test_sharding_checks_raise_before_any_rank(tmp_path, kw, msg):
    """``rl_train.train``'s flag checks (the reference's) raise before anything is
    built or spawned: no outdir is made.  Without a card, ``cuda`` at
    ``--devices 2`` names ``torch.cuda.device_count()``."""
    cfg = rl_train.TrainConfig(**{"devices": 2, "device": "cpu",
                                  "outdir": str(tmp_path / "x"), **kw})
    with pytest.raises(ValueError, match=msg):
        rl_train.train(cfg, log_fn=lambda *a: None)
    assert not (tmp_path / "x").exists()


def test_sharded_body_checks_its_shares(envs):
    env, dcfg = envs[1], envs[3]
    for bad, name in ((dict(SKW, batch_episodes=3), "batch_episodes=3"),
                      (dict(SKW, batch_size=7), "batch_size=7")):
        with pytest.raises(ValueError, match=name):
            TR._sharded_round_body(env, dcfg, num_devices=ND, **bad)
    with pytest.raises(ValueError, match="3 shards for 2 devices"):
        TR.StackedShards(ND).all_gather([torch.zeros(1)] * 3)
    with pytest.raises(ValueError, match="3 shards for 2 devices"):
        TR.StackedShards(ND).mean([torch.zeros(1)] * 3)
    with pytest.raises(ValueError, match="gathered batch"):
        TR.make_sharded_train_rounds(env, dcfg, mesh=None,
                                     update_gather=False, **SKW)
