"""The fleet-conditioned generalist in the port (descriptors, padded
envs, the M-agnostic actor, eval, multi-fleet rounds, checkpoints,
serving, ``rl_train``) against the JAX package.

Randomness crosses as data: NumPy eval traces and churn schedules, or
what the JAX round draws from its key (fleet index, traces, noise,
replay indices, churn schedules).  Tolerances:
- descriptor tables and padded tables: equal; ``churn_descriptors``
  within 1e-7 (``log2`` may differ in its last bit), bit-equal at the
  no-op row;
- at ``M == M_max``: the generalist path bit-equal to the specialist's;
- eval: counted and hits equal per episode;
- one round: tests/test_torch_train.py's round criteria;
- a restored JAX checkpoint: weights equal, served counted / hits equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import read_checkpoint_meta as jax_read_meta
from repro.ckpt import restore_checkpoint as jax_restore
from repro.ckpt import save_checkpoint as jax_save
from repro.core import ddpg as JD
from repro.core import generalist as JG
from repro.core import policy as JP
from repro.core import rollout as JRO
from repro.costmodel import descriptors as JDESC
from repro.costmodel.fleets import fleet_names
from repro.serving.loadgen import LoadGenConfig as JLoadGenConfig
from repro.serving.loadgen import request_streams as jax_request_streams
from repro.serving.service import MultiTenantService as JService
from repro.sim import churn as JC
from repro.sim.arrivals import ArrivalConfig as JArrivalConfig
from repro.sim.arrivals import generate_traces_jax
from repro.sim.env import EnvConfig as JEnvConfig
from repro.workloads import build_registry as jax_build_registry
from repro_torch.core import ddpg as D
from repro_torch.core import generalist as G
from repro_torch.core import policy as P
from repro_torch.core import rollout as RO
from repro_torch.core.train import INFO_KEYS
from repro_torch.costmodel import descriptors as DESC
from repro_torch.costmodel import get_fleet
from repro_torch.launch import rl_train
from repro_torch.serving import MultiTenantService
from repro_torch.serving.loadgen import LoadGenConfig, request_streams
from repro_torch.sim import churn as C
from repro_torch.sim.arrivals import ArrivalConfig
from repro_torch.sim.env import EnvConfig, SchedulingEnv
from repro_torch.workloads import build_registry

torch.set_num_threads(1)
KW = dict(periods=6, max_rq=16, max_jobs=8)
FLEETS = ("paper6", "4simba_4eyeriss", "2simba_2eyeriss")
HIDDEN = 8
TOL = dict(atol=1e-5, rtol=1e-5)
ROUND_KW = dict(batch_episodes=2, num_updates=3, batch_size=8,
                sigma_min=0.05, sigma_decay=0.97)
SMOKE = ["--workload", "light", "--episodes", "4", "--batch-episodes", "2",
         "--periods", "6", "--max-rq", "16", "--max-jobs", "8",
         "--hidden", "8", "--updates-per-episode", "2", "--batch-size", "8",
         "--replay-capacity", "64", "--warmup-episodes", "2",
         "--eval-every", "100", "--eval-seeds", "2", "--device", "cpu"]


def _arr(cfg):
    return dict(max_jobs=cfg.max_jobs, horizon_us=cfg.horizon_us,
                slack_us=2 * cfg.t_s_us)


@pytest.fixture(scope="module")
def fleets():
    jcfg, cfg = JEnvConfig(**KW), EnvConfig(**KW)
    jenvs = JG.build_padded_envs("light", FLEETS, jcfg,
                                 JArrivalConfig(**_arr(jcfg)))
    envs = G.build_padded_envs("light", FLEETS, cfg,
                               ArrivalConfig(**_arr(cfg)), device="cpu")
    return jenvs, envs


@pytest.fixture(scope="module")
def params(fleets):
    spec = JG.GeneralistSpec(m_max=8)
    jpcfg = spec.pcfg(hidden=HIDDEN)
    jp = JP.init_actor(jax.random.PRNGKey(6), jpcfg)
    tp = D.tree_map(lambda a: torch.tensor(np.asarray(a)),
                    jax.tree.map(np.asarray, jp))
    return jpcfg, jp, G.GeneralistSpec(m_max=8).pcfg(hidden=HIDDEN), tp


# ---------------------------------------------------------------------------
# descriptors and padded tables
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m_max", [None, 16])
def test_descriptors_equal_jax(m_max):
    assert DESC.DESC_FIELDS == JDESC.DESC_FIELDS
    for name in fleet_names():
        mas = get_fleet(name)
        for sa in mas.sas:
            np.testing.assert_array_equal(DESC.sa_descriptor(sa, mas),
                                          JDESC.sa_descriptor(sa, mas))
        np.testing.assert_array_equal(DESC.fleet_descriptors(mas, m_max),
                                      JDESC.fleet_descriptors(mas, m_max))
    with pytest.raises(ValueError, match="m_max"):
        DESC.fleet_descriptors(get_fleet("8simba"), 4)


def test_churn_descriptors_equal_jax():
    desc = DESC.fleet_descriptors(get_fleet("4simba_4eyeriss"))
    rng = np.random.default_rng(0)
    for _ in range(8):
        valid = rng.random(8) < 0.7
        lat = np.where(rng.random(8) < 0.5, 1.0,
                       rng.uniform(1, 16, 8)).astype(np.float32)
        bw = np.where(rng.random(8) < 0.5, 1.0,
                      rng.uniform(1, 16, 8)).astype(np.float32)
        want = JDESC.churn_descriptors(desc, jnp.asarray(valid),
                                       jnp.asarray(lat), jnp.asarray(bw))
        got = DESC.churn_descriptors(torch.tensor(desc), torch.tensor(valid),
                                     torch.tensor(lat), torch.tensor(bw))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-7)
    # per-stream rows, and the no-op row is the identity bit for bit
    ones = torch.ones((3, 8))
    same = DESC.churn_descriptors(torch.tensor(desc),
                                  torch.ones((3, 8), dtype=torch.bool), ones,
                                  ones)
    assert same.shape == (3, 8, DESC.DESC_DIM)
    assert torch.equal(same, torch.tensor(desc).expand(3, 8, -1))


def test_padded_env_tables_equal_jax(fleets):
    jenvs, envs = fleets
    for jenv, env in zip(jenvs, envs):
        assert env.num_sas == jenv.num_sas == 8
        assert env.true_num_sas == jenv.true_num_sas
        assert env.feat_dim == jenv.feat_dim and env.act_dim == jenv.act_dim
        for k in ("lat", "bw", "en"):
            np.testing.assert_array_equal(getattr(env, k).numpy(),
                                          np.asarray(getattr(jenv, k)))
        np.testing.assert_array_equal(env.min_lat, np.asarray(jenv.min_lat))
        np.testing.assert_array_equal(env.sa_mask.numpy(),
                                      np.asarray(jenv.sa_mask))
        np.testing.assert_array_equal(env.descriptors.numpy(),
                                      np.asarray(jenv.descriptors))
    got, want = G.stack_fleet_tables(envs), JG.stack_fleet_tables(jenvs)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    spec, jspec = G.GeneralistSpec(m_max=8), JG.GeneralistSpec(m_max=8)
    assert (spec.env_feat_dim, spec.feat_dim, spec.act_dim) == \
        (jspec.env_feat_dim, jspec.feat_dim, jspec.act_dim) == (20, 84, 9)
    with pytest.raises(ValueError, match="m_max"):
        G.PaddedEnv(build_registry("light", mas="8simba"), EnvConfig(**KW),
                    m_max=4, device="cpu")


def test_generalist_at_m_max_is_the_specialist(fleets):
    """At ``M == M_max`` the padded env IS the plain env, and the
    generalist path (descriptors appended, channels masked, masked
    argmax) is bit-equal to the raw actor on the same augmented
    features, through whole episodes."""
    cfg = EnvConfig(**KW)
    reg = build_registry("light", mas="paper6")
    plain = SchedulingEnv(reg, cfg, ArrivalConfig(**_arr(cfg)), device="cpu")
    padded = G.PaddedEnv(reg, cfg, 6, ArrivalConfig(**_arr(cfg)),
                         device="cpu")
    for k in ("lat", "bw", "en"):
        assert torch.equal(getattr(padded, k), getattr(plain, k))
    assert padded.feat_dim == plain.feat_dim and padded.sa_mask.all()
    pcfg = G.GeneralistSpec(m_max=6).pcfg(hidden=HIDDEN)
    p = P.init_actor(torch.Generator().manual_seed(5), pcfg, "cpu")
    desc = padded.descriptors

    def raw(f, m, sl, st, a):
        out = P.actor_apply(p, pcfg, G.append_descriptors(f, desc), m)
        return out, out[..., 0], torch.argmax(out[..., 1:], -1)
    seeds = range(4000, 4003)
    tr, st = RO.stack_episodes(plain, seeds)
    act = G.generalist_act_fn(p, pcfg, desc, padded.sa_mask)
    a = padded.episode(st, tr, lambda f, m, sl, s, x: act(f, m, sl, s, x))
    b = plain.episode(st, tr, raw)
    for x, y in ((a[1], b[1]), (a[3], b[3])):
        for k in y:
            assert torch.equal(x[k], y[k]), k
    got = G.evaluate_generalist_batch(padded, pcfg, p, seeds)
    assert got == RO._means(b[3])


# ---------------------------------------------------------------------------
# eval, the period step and one round against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("churn", [None, "mixed"])
def test_generalist_eval_matches_jax(fleets, params, churn):
    jenvs, envs = fleets
    jpcfg, jp, pcfg, tp = params
    seeds = range(7000, 7003)
    for jenv, env in zip(jenvs[1:], envs[1:]):
        jtr, jst = JRO.stack_episodes(jenv, seeds)
        tr, st = RO.stack_episodes(env, seeds)
        if churn is None:
            jm = JG.make_generalist_evaluate_batch(jenv, jpcfg)(jp, jst, jtr)
            m = G.make_generalist_evaluate_batch(env, pcfg)(tp, st, tr)
        else:
            jm = JG.make_generalist_evaluate_batch(jenv, jpcfg, churn=True)(
                jp, jst, jtr, JRO._eval_churn_schedules(
                    jenv, JC.churn_preset(churn), seeds))
            sched = RO._eval_churn_schedules(env, C.churn_preset(churn),
                                             seeds)
            assert sched["valid"][..., env.true_num_sas:].all()
            m = G.make_generalist_evaluate_batch(env, pcfg)(tp, st, tr,
                                                            sched)
        for k in ("counted", "hits", "arrived"):
            np.testing.assert_array_equal(m[k].numpy(), np.asarray(jm[k]))
        np.testing.assert_allclose(m["energy_uj"].numpy(),
                                   np.asarray(jm["energy_uj"]), rtol=1e-5)
        got = G.evaluate_generalist_batch(
            env, pcfg, tp, seeds,
            churn=None if churn is None else C.churn_preset(churn))
        assert got["counted"] == pytest.approx(float(jnp.mean(jm["counted"])))


def test_generalist_period_never_uses_padding(fleets, params):
    env = fleets[1][2]                                # 4 real SAs of 8
    _, _, pcfg, tp = params
    tr, st = RO.stack_episodes(env, [1, 2, 3])
    period = G.make_generalist_period(env, pcfg)
    gen = torch.Generator().manual_seed(0)
    for _ in range(KW["periods"]):
        st, trans, _ = period(tp, st, tr, gen, sigma=0.5)
        assert (trans["a"][..., 1 + env.true_num_sas:] == 0.0).all()
    assert (st["sa_free"][:, env.true_num_sas:] == 0.0).all()
    assert (st["sa_free"][:, :env.true_num_sas] > 0.0).any()


def jax_generalist_round(jenvs, jpcfg, jstate, key, cap, sigma,
                         telemetry=False):
    """The JAX generalist round under ``mixed`` churn from ``key``, and
    the draws it takes from the key (generalist/train.py:171-183) as the
    port's round body takes them.  Returns (JAX round outputs, draws)."""
    jdcfg = JD.DDPGConfig(policy=jpcfg)
    B = ROUND_KW["batch_episodes"]
    jchurn = JC.churn_preset("mixed")
    spec = JG.GeneralistSpec(m_max=8)
    jout = JG.make_generalist_round(
        jenvs, jdcfg, churn=jchurn, telemetry=telemetry, **ROUND_KW)(
        jax.tree.map(jnp.copy, jstate),
        JG.generalist_replay_init(cap, jenvs[0].seq_len, spec), key,
        jnp.float32(sigma), jnp.bool_(True))
    kfleet, ktrace, kroll, kup, kchurn = jax.random.split(key, 5)
    f = int(jax.random.randint(kfleet, (), 0, 3))
    stack = JG.stack_fleet_tables(jenvs)
    tr = generate_traces_jax(stack["min_lat"][f], jenvs[0].arrivals, ktrace,
                             B)
    z = jax.random.normal(kroll, (B, KW["periods"], KW["max_rq"],
                                  jpcfg.act_dim))
    n = min(B * KW["periods"], cap)
    idx = [jax.random.randint(k, (ROUND_KW["batch_size"],), 0, n)
           for k in jax.random.split(kup, ROUND_KW["num_updates"])]
    sched = JC.churn_schedules_jax(jchurn, KW["periods"], 8,
                                   jax.random.split(kchurn, B),
                                   sa_mask=stack["sa_mask"][f])
    draws = dict(fleet=f, traces=jax.tree.map(np.asarray, tr),
                 noise=torch.tensor(np.asarray(z)),
                 idx=torch.tensor(np.stack([np.asarray(i) for i in idx])),
                 churn={k: torch.tensor(np.asarray(v))
                        for k, v in sched.items()})
    return jout, draws


def fleet_key(f=2):
    """The first of PRNGKey(0..9) whose generalist round samples fleet
    ``f`` (2: the 4-SA fleet, the most padding)."""
    return next(k for k in (jax.random.PRNGKey(i) for i in range(10))
                if int(jax.random.randint(jax.random.split(k, 5)[0], (), 0,
                                          3)) == f)


def test_generalist_round_matches_jax(fleets, params):
    """One churned fleet-sampling round on the draws the JAX round takes
    from its key (generalist/train.py:171-183); the key is the first of
    0..9 whose round samples the 4-SA fleet (the most padding)."""
    jenvs, envs = fleets
    jpcfg, _, pcfg, _ = params
    jdcfg, dcfg = JD.DDPGConfig(policy=jpcfg), D.DDPGConfig(policy=pcfg)
    jstate = JD.init_ddpg(jax.random.PRNGKey(0), jdcfg)
    B, cap, sigma = ROUND_KW["batch_episodes"], 64, np.float32(0.3)
    (jnew, jbuf, jsigma, jm), draws = jax_generalist_round(
        jenvs, jpcfg, jstate, fleet_key(), cap, sigma)
    f = draws["fleet"]
    assert f == int(jm["fleet"]) == 2
    state = D.ddpg_state_from_numpy(jax.tree.map(np.asarray, jstate), dcfg,
                                    device="cpu")
    buf = G.generalist_replay_init(cap, envs[0].seq_len,
                                   G.GeneralistSpec(m_max=8), "cpu")
    new, buf, sig, m = G.train._generalist_round_body(
        envs, dcfg, churn=C.churn_preset("mixed"), **ROUND_KW)(
        state, buf, draws, float(sigma), True)
    assert sig == float(jsigma) and m["fleet"] == f
    assert buf["size"] == int(jbuf["size"])
    np.testing.assert_array_equal(buf["fleet"].numpy(),
                                  np.asarray(jbuf["fleet"]))
    for k in ("mask", "mask2"):
        np.testing.assert_array_equal(buf[k].numpy(), np.asarray(jbuf[k]))
    for k in ("s", "a", "r", "s2"):
        np.testing.assert_allclose(buf[k].numpy(), np.asarray(jbuf[k]), **TOL)
    assert m["sla"] == float(jm["sla"])
    for k in INFO_KEYS:
        assert m[k] == pytest.approx(float(jm[k]), rel=1e-4, abs=1e-6), k
    U = ROUND_KW["num_updates"]
    for name, lr in (("actor", dcfg.actor_lr), ("critic", dcfg.critic_lr),
                     ("target_actor", dcfg.tau * dcfg.actor_lr)):
        for g, w in zip(D.tree_leaves(getattr(new, name)),
                        jax.tree.leaves(getattr(jnew, name))):
            w = np.asarray(w)
            lim = 2 * lr * U + 1e-5 * np.abs(w).max()
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=lim)
    # the port's own draws for the same round shape
    d2 = G.generalist_round_draws(envs, 3, batch_episodes=B, num_updates=1,
                                  batch_size=4, size_after=8,
                                  churn=C.churn_preset("mixed"))
    real = envs[d2["fleet"]].true_num_sas
    assert d2["noise"].shape[-1] == 9
    assert d2["churn"]["valid"][..., real:].all()


def test_expand_batch_matches_jax(fleets):
    jenvs, envs = fleets
    rng = np.random.default_rng(0)
    batch = dict(s=rng.standard_normal((5, 17, 20)).astype(np.float32),
                 s2=rng.standard_normal((5, 17, 20)).astype(np.float32),
                 fleet=np.array([0, 2, 1, 2, 0]))
    want = JG.expand_batch({k: jnp.asarray(v) for k, v in batch.items()},
                           JG.stack_fleet_tables(jenvs)["desc"],
                           JG.stack_fleet_tables(jenvs)["sa_mask"])
    stack = G.stack_fleet_tables(envs)
    got = G.expand_batch({k: torch.tensor(v) for k, v in batch.items()},
                         stack["desc"], stack["sa_mask"])
    for k in ("s", "s2", "act_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# checkpoints, serving, rl_train
# ---------------------------------------------------------------------------
def test_jax_generalist_checkpoint_serves_an_unseen_fleet(tmp_path, params,
                                                          capsys):
    """A JAX generalist checkpoint (m_max 8) restores in the port and
    serves big_little, a fleet it never trained on: the same weights,
    the same counted / hits as the JAX service on the same requests."""
    jpcfg, jp, _, _ = params
    d = str(tmp_path / "best")
    jax_save(d, 3, jp, dict(policy_kind="generalist", m_max=8, desc_dim=8,
                            hidden=HIDDEN, fleet="paper6,8simba"))
    loaded = G.load_generalist_checkpoint(d, min_num_sas=6, device="cpu")
    assert loaded is not None and loaded[3] and loaded[2].m_max == 8
    assert G.load_generalist_checkpoint(d, min_num_sas=9,
                                        device="cpu") is None
    cfg, jcfg = EnvConfig(**KW), JEnvConfig(**KW)
    svc = MultiTenantService(build_registry("light", mas="big_little"),
                             ckpt_dir=d, hidden=HIDDEN, env_cfg=cfg,
                             device="cpu")
    jsvc = JService(jax_build_registry("light", mas="big_little"),
                    ckpt_dir=d, hidden=HIDDEN, env_cfg=jcfg)
    assert svc.policy_kind == jsvc.policy_kind == "generalist"
    assert svc.env.num_sas == 8 and svc.env.true_num_sas == 6
    for name, mod in svc.actor.params().items():
        for k, v in mod.items():
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(jp[name][k]))
    lg = LoadGenConfig(n_requests=10)
    out = svc.serve_stream(request_streams(svc.env, lg, 2, seed=8), tick_k=8)
    jout = jsvc.serve_stream(jax_request_streams(
        jsvc.env, JLoadGenConfig(n_requests=10), 2, seed=8), tick_k=8,
        seed=8)
    for mm, jmm in zip(out["metrics"], jout["metrics"]):
        assert mm["counted"] == jmm["counted"] and mm["hits"] == jmm["hits"]
    assert out["aggregate"]["counted"] > 0
    # a generalist whose weights do not match its meta: untrained, said so
    bad = str(tmp_path / "bad")
    jax_save(bad, 1, jp, dict(policy_kind="generalist", m_max=8,
                              hidden=16))
    params_bad, _, _, ok = G.load_generalist_checkpoint(bad, device="cpu")
    assert not ok and params_bad["lstm"]["wh"].shape == (16, 64)
    assert "failed to restore" in capsys.readouterr().out


def test_generalist_act_matches_the_period_step(fleets, params):
    """The serving tick's generalist act (the ``lstm_seq`` route) against
    ``make_generalist_period`` at sigma 0 (the step route)."""
    from repro_torch.core.policy import Actor
    from repro_torch.core.serve import build_act
    env = fleets[1][2]
    _, _, pcfg, tp = params
    actor = Actor(pcfg, device="cpu")
    for name, mod in actor.params().items():
        for k, prm in mod.items():
            prm.data.copy_(tp[name][k])
    tr, st = RO.stack_episodes(env, [4, 5])
    got = env.period(st, tr, build_act(env, "generalist", actor))
    want = G.make_generalist_period(env, pcfg)(tp, st, tr)
    for k in ("a", "s2"):
        torch.testing.assert_close(got[1][k], want[1][k], **TOL)
    for k in ("nls", "done", "hit", "missed"):
        assert torch.equal(got[0][k], want[0][k])


def test_rl_train_multi_fleet_min_fleet(tmp_path):
    """``rl_train`` over three fleets under churn, ``--best-metric
    min_fleet``: fleets per round, per-fleet eval, the best checkpoint's
    meta and weights readable by the JAX package."""
    out = str(tmp_path / "run")
    res = rl_train.main(SMOKE + [
        "--outdir", out, "--fleet", ",".join(FLEETS),
        "--best-metric", "min_fleet", "--churn", "mixed", "--episodes", "6",
        "--eval-every", "6", "--ckpt-every", "2", "--eval-baselines", "fcfs"])
    assert res["policy_kind"] == "generalist" and res["spec"].m_max == 8
    h = res["history"]
    assert all(r["fleet"] in FLEETS for r in h)
    per = h[-1]["eval_sla_per_fleet"]
    assert set(per) == set(FLEETS)
    assert res["best"]["score"] == min(per.values())
    assert set(res["baselines"]) == {"fcfs"}
    meta = jax_read_meta(str(tmp_path / "run" / "best"))
    assert meta["policy_kind"] == "generalist" and meta["m_max"] == 8
    assert meta["fleets"] == list(FLEETS) and meta["churn"] == "mixed"
    like = JP.init_actor(jax.random.PRNGKey(0),
                         JG.GeneralistSpec(m_max=8).pcfg(hidden=HIDDEN))
    tree, _, _ = jax_restore(str(tmp_path / "run" / "best"), like)
    np.testing.assert_array_equal(tree["lstm"]["wx"],
                                  res["state"].actor["lstm"]["wx"].numpy())
    # a generalist on one fleet, resumed on another: fleet-independent
    res2 = rl_train.main(SMOKE + ["--outdir", out, "--fleet", "8simba",
                                  "--policy-kind", "generalist",
                                  "--episodes", "8"])
    assert [r["episode"] for r in res2["history"]] == [7]
    with pytest.raises(ValueError, match="min_fleet"):
        rl_train.main(SMOKE + ["--outdir", str(tmp_path / "s"),
                               "--best-metric", "min_fleet"])
