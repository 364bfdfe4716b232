"""MAGMA and the deployment scheduler in the port against the JAX package.

JAX draws with threefry and PyTorch with Philox, so the GA's draws go
in as data: each generation's eight arrays, and the initial population,
taken from the JAX key exactly as ``repro.core.baselines`` splits it.
Tolerances:
- fitness: hits equal, the whole value within ``FIT_TOL`` = 2e-6, a few
  float32 ulps at these fitnesses (< 4): the 1e-3 x slack sum is taken
  in another order (seen: 2.4e-7); the engines' times agree within
  1e-3 us (ROADMAP C), which moves a slack term by ~1e-9;
- a generation fed the same fitness and draws: the same population
  (priorities within 1e-6, assignments equal), fitness within FIT_TOL;
- the whole search: elite fitness within FIT_TOL each generation; the
  chosen schedule equal where the elite's margin over the best
  different schedule exceeds FIT_TOL (asserted to hold on these seeds);
- episodes: counted and hits equal;
- the scheduler on carried weights: actions within 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as JBL
from repro.core import policy as JP
from repro.core import rollout as JRO
from repro.core.scheduler import RelmasScheduler as JRelmasScheduler
from repro.sim.arrivals import ArrivalConfig as JArrivalConfig
from repro.sim.env import EnvConfig as JEnvConfig
from repro.sim.env import SchedulingEnv as JEnv
from repro.workloads import build_registry as jax_build_registry
from repro_torch.core import RelmasScheduler
from repro_torch.core import baselines as BL
from repro_torch.core import policy as P
from repro_torch.core import rollout as RO
from repro_torch.sim.arrivals import ArrivalConfig, generate_traces
from repro_torch.sim.env import EnvConfig, SchedulingEnv
from repro_torch.workloads import build_registry

torch.set_num_threads(1)
KW = dict(periods=6, max_rq=24, max_jobs=12)
ARR = dict(load=1.3, qos_factor=2.5)
MCFG = BL.MagmaConfig(population=8, generations=4)
JMCFG = JBL.MagmaConfig(population=8, generations=4)
FIT_TOL = 2e-6
S = 4


@pytest.fixture(scope="module")
def envs():
    jcfg, cfg = JEnvConfig(**KW), EnvConfig(**KW)
    arr = lambda c: dict(max_jobs=c.max_jobs, horizon_us=c.horizon_us,
                         slack_us=2 * c.t_s_us, **ARR)
    jenv = JEnv(jax_build_registry("light"), jcfg,
                JArrivalConfig(**arr(jcfg)))
    env = SchedulingEnv(build_registry("light"), cfg,
                        ArrivalConfig(**arr(cfg)), device="cpu")
    return jenv, env


@pytest.fixture(scope="module")
def period(envs):
    """A mid-episode period of S streams: traces from NumPy, two periods
    of Herald in JAX, then the third period's state and slots in both
    packages."""
    jenv, env = envs
    tr = generate_traces(env.min_lat, env.arrivals, np.random.default_rng(2),
                         S)
    jtr = jenv._finish_trace(tr)
    jst = jax.vmap(jenv.init_state)(jtr)
    step = jax.jit(jax.vmap(lambda st, t: jenv.period(
        st, t, lambda f, m, sl, s: JBL.herald(sl, s, jenv))[0]))
    for _ in range(2):
        jst = step(jst, jtr)
    jst = jax.vmap(lambda st, t: jenv.mark_drops(st, t, st["t"]))(jst, jtr)
    jsl = jax.vmap(lambda st, t: jenv.build_slots(st, t, st["t"]))(jst, jtr)
    st = {k: torch.tensor(np.asarray(v)) for k, v in jst.items()}
    st["nls"] = st["nls"].long()
    trace = env.to_trace(tr)
    sl = env.build_slots(st, trace, st["t"])
    assert int(sl["valid"].sum()) > 10
    np.testing.assert_array_equal(sl["job"].numpy(), np.asarray(jsl["job"]))
    return jst, jsl, st, sl


def _gen_draws(key, env):
    """One generation's draws as ``_magma_generation`` takes them from
    its key (baselines.py:178-199)."""
    P_, R, M = JMCFG.population, env.cfg.max_rq, env.num_sas
    ks = jax.random.split(key, 8)
    return dict(
        sel_a=jax.random.randint(ks[0], (P_, JMCFG.tournament), 0, P_),
        sel_b=jax.random.randint(ks[1], (P_, JMCFG.tournament), 0, P_),
        cx=jax.random.bernoulli(ks[2], 0.5, (P_, R)),
        do_cx=jax.random.bernoulli(ks[3], JMCFG.cx_prob, (P_, 1)),
        mut=jax.random.bernoulli(ks[4], JMCFG.mut_prob, (P_, R)),
        normal=jax.random.normal(ks[5], (P_, R)),
        reset=jax.random.bernoulli(ks[6], JMCFG.mut_prob, (P_, R)),
        reset_sa=jax.random.randint(ks[7], (P_, R), 0, M))


def _search_draws(key, env):
    """The whole search's draws (``_magma_init`` and the scan's key
    splits), one stream."""
    P_, R, M = JMCFG.population, env.cfg.max_rq, env.num_sas
    k1, k2, key = jax.random.split(key, 3)
    init = dict(prio=jax.random.uniform(k1, (P_, R), minval=-1.0,
                                        maxval=1.0),
                sa=jax.random.randint(k2, (P_, R), 0, M))
    gens = []
    for _ in range(JMCFG.generations):
        key, sub = jax.random.split(key)
        gens.append(_gen_draws(sub, env))
    return dict(init=init, gens=gens)


def _stack(draws_list):
    """Per-stream draws -> one draws dict with a leading stream axis."""
    st = lambda ds: {k: torch.tensor(np.stack([np.asarray(d[k])
                                               for d in ds]))
                     for k in ds[0]}
    return dict(init=st([d["init"] for d in draws_list]),
                gens=[st([d["gens"][g] for d in draws_list])
                      for g in range(len(draws_list[0]["gens"]))])


def _jfit(jenv):
    return jax.jit(jax.vmap(lambda st, sl, p, s: JBL._magma_fitness(
        jenv, st, sl, p, s)))


def test_magma_fitness_matches_jax(envs, period):
    jenv, env = envs
    jst, jsl, st, sl = period
    rng = np.random.default_rng(0)
    prio = rng.uniform(-1, 1, (S, 16, KW["max_rq"])).astype(np.float32)
    sa = rng.integers(0, env.num_sas, (S, 16, KW["max_rq"]))
    want = np.asarray(_jfit(jenv)(jst, jsl, prio, sa.astype(np.int32)))
    got = BL._magma_fitness(env, st, sl, torch.tensor(prio),
                            torch.tensor(sa)).numpy()
    assert got.shape == (S, 16)
    np.testing.assert_array_equal(np.floor(got), np.floor(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=FIT_TOL)
    assert len(np.unique(np.floor(want))) > 1       # the hits vary


def test_magma_generation_matches_jax(envs, period):
    """One generation from the same population, fitness and draws."""
    jenv, env = envs
    jst, jsl, st, sl = period
    rng = np.random.default_rng(1)
    P_, R = JMCFG.population, KW["max_rq"]
    prio = rng.uniform(-1, 1, (S, P_, R)).astype(np.float32)
    sa = rng.integers(0, env.num_sas, (S, P_, R)).astype(np.int32)
    fit = _jfit(jenv)(jst, jsl, prio, sa)
    keys = jax.random.split(jax.random.PRNGKey(4), S)
    gen = jax.jit(jax.vmap(lambda k, s_, l_, p, a, f: JBL._magma_generation(
        jenv, JMCFG, k, s_, l_, p, a, f)))
    jp, jsa, jf = gen(keys, jst, jsl, prio, sa, fit)
    draws = _stack([{"init": {}, "gens": [_gen_draws(k, env)]}
                    for k in keys])["gens"][0]
    p2, sa2, f2 = BL._magma_generation(
        env, MCFG, st, sl, torch.tensor(prio), torch.tensor(sa).long(),
        torch.tensor(np.asarray(fit)), draws)
    np.testing.assert_array_equal(sa2.numpy(), np.asarray(jsa))
    np.testing.assert_allclose(p2.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(f2.numpy(), np.asarray(jf), rtol=0,
                               atol=FIT_TOL)


def _margin(fit, prio, sa, best):
    """The elite's fitness over the best individual whose schedule
    differs from it."""
    same = (sa == sa[best]).all(1) & np.isclose(prio, prio[best]).all(1)
    other = fit[~same]
    return np.inf if other.size == 0 else fit[best] - other.max()


def test_magma_search_matches_jax(envs, period):
    jenv, env = envs
    jst, jsl, st, sl = period
    keys = jax.random.split(jax.random.PRNGKey(7), S)
    search = jax.jit(jax.vmap(lambda k, s_, l_: JBL.magma_search_scan(
        jenv, JMCFG, k, s_, l_)))
    jprio, jsa, jelite = search(keys, jst, jsl)
    draws = _stack([_search_draws(k, env) for k in keys])
    prio, sa, elite = BL.magma_search_scan(env, MCFG, draws, st, sl)
    assert elite.shape == (S, MCFG.generations)
    np.testing.assert_allclose(elite.numpy(), np.asarray(jelite), rtol=0,
                               atol=FIT_TOL)
    # the schedule, where the elite's margin over the best different
    # schedule exceeds the tolerance (on these seeds: every stream,
    # test_magma_search_margin_rule_holds_on_these_seeds)
    ff, pp, ss = _final_population(env, draws, st, sl)
    for s in range(S):
        best = int(np.argmax(ff[s]))
        if _margin(ff[s], pp[s], ss[s], best) <= FIT_TOL:
            continue
        np.testing.assert_array_equal(sa[s].numpy(), np.asarray(jsa)[s])
        np.testing.assert_allclose(prio[s].numpy(), np.asarray(jprio)[s],
                                   rtol=0, atol=1e-6)


def _final_population(env, draws, st, sl):
    pp, ss, ff = BL._magma_init(env, st, sl, draws["init"])
    for g in draws["gens"]:
        pp, ss, ff = BL._magma_generation(env, MCFG, st, sl, pp, ss, ff, g)
    return ff.numpy(), pp.numpy(), ss.numpy()


def test_magma_search_margin_rule_holds_on_these_seeds(envs, period):
    """The margin rule the schedule comparison stands on holds on these
    seeds: every stream's elite beats its best different schedule by
    more than FIT_TOL, so test_magma_search_matches_jax compares every
    stream's schedule (a closer race could pick another schedule on a
    last-ulp difference, which is not a fault)."""
    jenv, env = envs
    jst, jsl, st, sl = period
    keys = jax.random.split(jax.random.PRNGKey(7), S)
    draws = _stack([_search_draws(k, env) for k in keys])
    ff, pp, ss = _final_population(env, draws, st, sl)
    for s in range(S):
        best = int(np.argmax(ff[s]))
        assert _margin(ff[s], pp[s], ss[s], best) > FIT_TOL, s


def test_magma_elite_monotone_and_above_herald(envs, period):
    env = envs[1]
    _, _, st, sl = period
    gen = torch.Generator().manual_seed(0)
    cfg = BL.MagmaConfig(population=8, generations=6)
    _, hp, hs = BL.herald(sl, st, env)
    herald_fit = BL._magma_fitness(env, st, sl, hp[:, None], hs[:, None])[:, 0]
    prio, sa, elite = BL.magma_search_scan(env, cfg, gen, st, sl)
    e = elite.numpy()
    assert (np.diff(e, axis=1) >= 0).all()
    assert (e[:, -1] >= herald_fit.numpy()).all()
    chosen = BL._magma_fitness(env, st, sl, prio[:, None], sa[:, None])[:, 0]
    np.testing.assert_array_equal(chosen.numpy(), e[:, -1])


def test_magma_streams_batched_equal_each_alone(envs, period):
    env = envs[1]
    _, _, st, sl = period
    keys = jax.random.split(jax.random.PRNGKey(9), S)
    draws = _stack([_search_draws(k, env) for k in keys])
    prio, sa, elite = BL.magma_search_scan(env, MCFG, draws, st, sl)
    for s in range(S):
        one = lambda x: {k: v[s:s + 1] for k, v in x.items()}
        p1, s1, e1 = BL.magma_search_scan(
            env, MCFG, {"init": one(draws["init"]),
                        "gens": [one(g) for g in draws["gens"]]},
            one(st), one(sl))
        assert torch.equal(p1[0], prio[s]) and torch.equal(s1[0], sa[s])
        assert torch.equal(e1[0], elite[s])


def test_magma_episodes_match_jax(envs):
    """Whole MAGMA episodes, each period's search on the draws JAX takes
    from that period's key (one key per episode, split per period):
    equal counted and hits."""
    jenv, env = envs
    seeds = [5, 6]
    jfn = JBL.make_magma_baseline(JMCFG)
    jtr, jst = JRO.stack_episodes(jenv, seeds)
    jm = JRO.make_baseline_episode_batch(jenv, jfn)(jst, jtr, seeds=seeds)
    per_ep = [jax.random.split(jax.random.PRNGKey(s), KW["periods"])
              for s in seeds]
    draws = [_stack([_search_draws(per_ep[e][p], env)
                     for e in range(len(seeds))])
             for p in range(KW["periods"])]
    tr, st = RO.stack_episodes(env, seeds)
    fn = BL.make_magma_baseline(MCFG)
    m = RO.make_baseline_episode_batch(env, fn)(st, tr, draws)
    for k in ("counted", "hits", "arrived"):
        np.testing.assert_array_equal(m[k].numpy(), np.asarray(jm[k]))
    assert int(m["counted"].sum()) > 0
    # the entry point a user calls: a generator from the eval seeds
    out = RO.evaluate_batch_baseline(env, fn, seeds)
    assert 0.0 <= out["sla_rate"] <= 1.0 and out["counted"] > 0


def test_make_magma_baseline_memoised():
    a = BL.make_magma_baseline(BL.MagmaConfig(population=8, generations=4))
    b = BL.make_magma_baseline(BL.MagmaConfig(population=8, generations=4))
    c = BL.make_magma_baseline(BL.MagmaConfig(population=8, generations=5))
    assert a is b and a is not c
    assert a.__name__ == JBL.make_magma_baseline(JMCFG).__name__ \
        == "magma_p8g4"
    assert a.mcfg == MCFG and BL.MagmaConfig() == BL.MagmaConfig(
        population=100, generations=100)


def test_heuristics_ignore_rand(envs, period):
    env = envs[1]
    _, _, st, sl = period
    for fn in BL.BASELINES.values():
        a = fn(sl, st, env)
        b = fn(sl, st, env, torch.Generator().manual_seed(3))
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_relmas_scheduler_matches_jax(envs):
    jenv, env = envs
    jpcfg = JP.PolicyConfig(feat_dim=jenv.feat_dim, act_dim=jenv.act_dim,
                            hidden=16)
    jparams = JP.init_actor(jax.random.PRNGKey(1), jpcfg)
    params = P.tree_to_device(P.checked_numpy(
        jax.tree.map(np.asarray, jparams),
        P.net_shapes(jpcfg.feat_dim, 16, jpcfg.act_dim)), "cpu")
    pcfg = P.PolicyConfig(feat_dim=env.feat_dim, act_dim=env.act_dim,
                          hidden=16)
    sched = RelmasScheduler(params, pcfg)
    jsched = JRelmasScheduler(jparams, jpcfg)
    assert sched.macs_per_timestep() == jsched.macs_per_timestep()
    tr, st = RO.stack_episodes(env, [1, 2, 3])
    sl = env.build_slots(st, tr, st["t"])
    feats, mask = env.encode(sl, st)
    a, prio, sa = sched(feats, mask, sl, st)
    for s in range(3):
        ja, jprio, jsa = jsched(jnp.asarray(feats[s].numpy()),
                                jnp.asarray(mask[s].numpy()))
        np.testing.assert_allclose(a[s].numpy(), np.asarray(ja), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(prio[s].numpy(), np.asarray(jprio),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_array_equal(sa[s].numpy(), np.asarray(jsa))
