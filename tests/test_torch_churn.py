"""Fleet churn in the port (``repro_torch.sim.churn``, the env's churn
rows, masking in the policy, churned rounds and evaluation) against the
JAX package.

Randomness crosses as data: the NumPy event draws are shared ground
truth (compared exactly), and a churned round takes the schedules the
JAX round draws from its key.  Tolerances:
- NumPy events, compiled schedules: exactly equal;
- episodes under churn: ``counted``/``hits`` and masks equal; features,
  actions, rewards and energy within 1e-5 (float32 sums in another
  order, as in tests/test_torch_train.py);
- an all-no-op schedule against the static path: bit for bit;
- one churned round: the criteria of tests/test_torch_train.py's round.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as JBL
from repro.core import ddpg as JD
from repro.core import policy as JP
from repro.core import replay as JR
from repro.core import rollout as JRO
from repro.core.train import make_train_round
from repro.sim import churn as JC
from repro.sim.arrivals import ArrivalConfig as JArrivalConfig
from repro.sim.arrivals import generate_traces_jax
from repro.sim.env import EnvConfig as JEnvConfig
from repro.sim.env import SchedulingEnv as JEnv
from repro.workloads import build_registry as jax_build_registry
from repro_torch.core import baselines as BL
from repro_torch.core import ddpg as D
from repro_torch.core import policy as P
from repro_torch.core import rollout as RO
from repro_torch.core import train as TR
from repro_torch.core.generalist import (GeneralistSpec, build_padded_envs,
                                         generalist_act_fn)
from repro_torch.core.replay import replay_init
from repro_torch.sim import churn as C
from repro_torch.sim.arrivals import ArrivalConfig, generate_traces
from repro_torch.sim.env import EnvConfig, SchedulingEnv
from repro_torch.workloads import build_registry

torch.set_num_threads(1)
KW = dict(periods=6, max_rq=16, max_jobs=8)
LOADED = dict(periods=16, max_rq=32, max_jobs=16)
HIDDEN = 8
TOL = dict(atol=1e-5, rtol=1e-5)
ROUND_KW = dict(batch_episodes=2, num_updates=3, batch_size=8,
                sigma_min=0.05, sigma_decay=0.97)


def _arr(cfg, **kw):
    return dict(max_jobs=cfg.max_jobs, horizon_us=cfg.horizon_us,
                slack_us=2 * cfg.t_s_us, **kw)


def _pair(kw, **arr):
    jcfg, cfg = JEnvConfig(**kw), EnvConfig(**kw)
    jenv = JEnv(jax_build_registry("light"), jcfg,
                JArrivalConfig(**_arr(jcfg, **arr)))
    env = SchedulingEnv(build_registry("light"), cfg,
                        ArrivalConfig(**_arr(cfg, **arr)), device="cpu")
    return jenv, env


@pytest.fixture(scope="module")
def envs():
    return _pair(KW)


@pytest.fixture(scope="module")
def loaded():
    """Enough contention that the SLA discriminates (the smoke env hits
    1.0 everywhere), as the JAX package's churn tests use."""
    return _pair(LOADED, load=1.3, qos_factor=2.5)[1]


@pytest.fixture(scope="module")
def params(envs):
    jenv = envs[0]
    pcfg = JP.PolicyConfig(feat_dim=jenv.feat_dim, act_dim=jenv.act_dim,
                           hidden=HIDDEN)
    jp = JP.init_actor(jax.random.PRNGKey(3), pcfg)
    return jp, D.tree_map(lambda a: torch.tensor(np.asarray(a)),
                          jax.tree.map(np.asarray, jp))


def _pcfg(env):
    return P.PolicyConfig(feat_dim=env.feat_dim, act_dim=env.act_dim,
                          hidden=HIDDEN)


def _events(rows, E=4):
    ev = C.no_op_events(E)
    for i, (p, s, c, g) in enumerate(rows):
        ev["period"][i], ev["sa"][i] = p, s
        ev["code"][i], ev["mag"][i] = c, g
    return ev


# ---------------------------------------------------------------------------
# the shared NumPy draws and the compiled schedules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scenario", C.CHURN_SCENARIOS)
def test_numpy_churn_events_equal_jax(scenario):
    cfg = C.churn_preset(scenario)
    jcfg = JC.churn_preset(scenario)
    for seed in range(5):
        for M in (4, 6, 8):
            got = C.churn_events(cfg, 20, M, np.random.default_rng(seed))
            want = JC.churn_events(jcfg, 20, M, np.random.default_rng(seed))
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
                assert got[k].dtype == want[k].dtype
    assert C._event_plan(cfg) == JC._event_plan(jcfg)


@pytest.mark.parametrize("width", [None, 8])
def test_churn_schedules_equal_jax(width):
    for name in ("mixed", "fail", "join"):
        got = C.churn_schedules(C.churn_preset(name), 12, 6, [3, 4, 5],
                                width=width)
        want = JC.churn_schedules(JC.churn_preset(name), 12, 6, [3, 4, 5],
                                  width=width)
        for k in want:
            assert got[k].shape == want[k].shape == (3, 12, width or 6)
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


def test_compile_schedule_bit_equal_jax():
    """Random events (codes over all five, repeated targets so later
    rows overwrite earlier ones) compile to the same rows, one at a time
    and batched."""
    rng = np.random.default_rng(0)
    evs = []
    for _ in range(24):
        E = 5
        ev = dict(period=rng.integers(0, 9, E).astype(np.int32),
                  sa=rng.integers(0, 4, E).astype(np.int32),
                  code=rng.integers(0, 5, E).astype(np.int32),
                  mag=rng.uniform(1.0, 8.0, E).astype(np.float32))
        evs.append(ev)
        got = C.compile_schedule(ev, 8, 4)
        want = JC.compile_schedule({k: jnp.asarray(v) for k, v in ev.items()},
                                   8, 4)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
            assert got[k].dtype == (torch.bool if k == "valid"
                                    else torch.float32)
    batched = C.compile_schedule({k: np.stack([e[k] for e in evs])
                                  for k in evs[0]}, 8, 4)
    for i, ev in enumerate(evs):
        one = C.compile_schedule(ev, 8, 4)
        for k in one:
            assert torch.equal(batched[k][i], one[k])


def test_compile_semantics_and_no_op():
    T, M = 8, 3
    noop = C.compile_schedule(C.no_op_events(), T, M)
    ident = C.no_op_schedule(T, M)
    for k in ident:
        assert torch.equal(noop[k], ident[k])
    s = C.compile_schedule(_events([(2, 0, C.EV_FAIL, 1.0),
                                    (5, 0, C.EV_JOIN, 1.0),
                                    (3, 1, C.EV_SLOWDOWN, 4.0),
                                    (4, 2, C.EV_THROTTLE, 2.0)]), T, M)
    v = s["valid"].numpy()
    # a join target is absent until its period; the later JOIN row
    # revives the earlier FAIL of the same SA
    assert not v[:5, 0].any() and v[5:, 0].all() and v[:, 1:].all()
    np.testing.assert_array_equal(s["lat_mult"][:, 1].numpy(),
                                  [1, 1, 1, 4, 4, 4, 4, 4])
    np.testing.assert_array_equal(s["bw_mult"][:, 2].numpy(),
                                  [1, 1, 1, 1, 2, 2, 2, 2])


@pytest.mark.parametrize("scenario", ["fail", "join", "throttle",
                                      "slowdown", "mixed"])
def test_torch_event_twin_plan_window_and_mask(scenario):
    """The torch twin of ``churn_events_jax``: the plan's codes, periods
    inside the window, distinct targets, inside ``sa_mask``."""
    cfg = C.churn_preset(scenario, n_events=3)
    gen = torch.Generator().manual_seed(0)
    periods, M, B = 20, 8, 64
    lo, hi = int(0.25 * periods), int(0.75 * periods)
    plan = C._event_plan(cfg)
    mask = torch.arange(M) < 5
    for sa_mask in (None, mask):
        ev = C.churn_events_torch(cfg, periods, M, gen, B, sa_mask)
        assert ev["period"].shape == ev["sa"].shape == (B, cfg.max_events)
        code = ev["code"].numpy()
        assert (code[:, :len(plan)] == plan).all()
        assert (code[:, len(plan):] == C.EV_NONE).all()
        p = ev["period"].numpy()
        assert (p >= lo).all() and (p < hi).all()
        assert len(np.unique(p)) > 3                 # not a constant
        sa = ev["sa"].numpy()
        assert all(len(set(r)) == cfg.max_events for r in sa)
        degr = np.isin(code, [C.EV_THROTTLE, C.EV_SLOWDOWN])
        np.testing.assert_array_equal(ev["mag"].numpy(),
                                      np.where(degr, 4.0, 1.0))
        if sa_mask is not None:
            assert (sa[:, :len(plan)] < 5).all()
    sched = C.churn_schedules_torch(cfg, periods, M, gen, 4, mask)
    assert sched["valid"].shape == (4, periods, M)
    assert sched["valid"][..., 5:].all()         # padding never churns


# ---------------------------------------------------------------------------
# episodes under churn against JAX
# ---------------------------------------------------------------------------
def _jax_episodes(jenv, act, tr, sched):
    jtraces = jenv._finish_trace(tr)

    def one(state, trace, ch):
        return jenv.episode(state, trace, act, churn=ch)
    return jax.jit(jax.vmap(one))(jax.vmap(jenv.init_state)(jtraces),
                                  jtraces, sched)


@pytest.mark.parametrize("policy", ["relmas", "herald"])
def test_episode_under_churn_matches_jax(envs, params, policy):
    jenv, env = envs
    seeds = [11, 12, 13]
    churn = C.churn_preset("mixed")
    sched = C.churn_schedules(churn, KW["periods"], env.num_sas, seeds)
    jsched = JC.churn_schedules(JC.churn_preset("mixed"), KW["periods"],
                                jenv.num_sas, seeds)
    assert not sched["valid"].all()
    tr = generate_traces(env.min_lat, env.arrivals,
                         np.random.default_rng(1), len(seeds))
    jp, tp = params
    pcfg = _pcfg(env)
    if policy == "relmas":
        jact = JRO._policy_act_fn(jp, JP.PolicyConfig(
            feat_dim=jenv.feat_dim, act_dim=jenv.act_dim, hidden=HIDDEN))
        z = jnp.zeros((KW["periods"],))
        jout = _jax_episodes(jenv, lambda f, m, sl, st, k, a: jact(
            f, m, sl, st, k, z[0]), tr, jsched)
        act = RO._policy_act_fn(tp, pcfg)
    else:
        jout = _jax_episodes(jenv, lambda f, m, sl, st, k, a: JBL.herald(
            sl, st, jenv), tr, jsched)
        act = lambda f, m, sl, st, a: BL.herald(sl, st, env)
    traces = env.to_trace(tr)
    _, trans, infos, mets = env.episode(env.init_state(traces), traces,
                                        act, churn=sched)
    _, jtrans, jinfos, jmets = jout
    for k in ("mask", "mask2"):
        np.testing.assert_array_equal(trans[k].numpy(), np.asarray(jtrans[k]))
    for k in ("s", "a", "r", "s2"):
        np.testing.assert_allclose(trans[k].numpy(), np.asarray(jtrans[k]),
                                   **TOL)
    for k in ("hits", "counted", "arrived"):
        np.testing.assert_array_equal(mets[k].numpy(), np.asarray(jmets[k]))
    np.testing.assert_allclose(mets["energy_uj"].numpy(),
                               np.asarray(jmets["energy_uj"]), rtol=1e-5)
    np.testing.assert_array_equal(infos["committed"].numpy(),
                                  np.asarray(jinfos["committed"]))


def _assert_bitequal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_bitequal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        for x, y in zip(a, b):
            _assert_bitequal(x, y)
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["specialist", "generalist"])
def test_zero_churn_bit_parity(envs, kind):
    """An all-no-op schedule through the churn-enabled episode is the
    static path bit for bit (every churn site is an IEEE identity), the
    descriptor-conditioned generalist on a padded env included."""
    env = envs[1]
    if kind == "generalist":
        env = build_padded_envs("light", ("paper6",), EnvConfig(**KW),
                                env.arrivals, m_max=8, device="cpu")[0]
        pcfg = GeneralistSpec(m_max=8).pcfg(hidden=HIDDEN)
        p = P.init_actor(torch.Generator().manual_seed(0), pcfg, "cpu")
        g = generalist_act_fn(p, pcfg, env.descriptors, env.sa_mask)
    else:
        pcfg = _pcfg(env)
        p = P.init_actor(torch.Generator().manual_seed(0), pcfg, "cpu")
        g = RO._policy_act_fn(p, pcfg)
    act = lambda f, m, sl, st, a: g(f, m, sl, st, a)
    traces, states = env.new_episodes(np.random.default_rng(12), 3)
    noise = 0.3 * RO.noise_block(env, 3, torch.Generator().manual_seed(1))
    static = env.episode(states, traces, act, aux=noise)
    churned = env.episode(states, traces, act, aux=noise,
                          churn=C.no_op_schedule(KW["periods"], env.num_sas,
                                                 3))
    _assert_bitequal(static, churned)


def test_zero_churn_preset_matches_plain_eval(envs, params):
    env, tp = envs[1], params[1]
    plain = RO.evaluate_batch(env, _pcfg(env), tp, [21, 22])
    nochurn = RO.evaluate_batch(env, _pcfg(env), tp, [21, 22],
                                churn=C.churn_preset("none"))
    assert plain == nochurn


# ---------------------------------------------------------------------------
# event semantics end to end
# ---------------------------------------------------------------------------
def test_failed_sa_never_selected_act_fn(envs, params):
    env, tp = envs[1], params[1]
    act = RO._policy_act_fn(tp, _pcfg(env))
    traces, state = env.new_episodes(np.random.default_rng(0), 2)
    slots = env.build_slots(state, traces, cutoff=state["t"])
    feats, mask = env.encode(slots, state)
    valid = torch.tensor([[False] * (env.num_sas - 1) + [True],
                          [True] + [False] * (env.num_sas - 1)])
    _, _, sa = act(feats, mask, slots, {**state, "sa_valid": valid}, None)
    assert (sa[0] == env.num_sas - 1).all() and (sa[1] == 0).all()


def _record(act):
    seen = []

    def rec(f, m, sl, st, a):
        out = act(f, m, sl, st, a)
        seen.append((out[2], sl["valid"], st.get("sa_valid")))
        return out
    return rec, seen


@pytest.mark.parametrize("policy", ["relmas", "fcfs"])
def test_failed_sa_gets_no_work(loaded, policy):
    """An SA failed from period 0 is never chosen for a real slot and
    never accumulates busy time; without churn it does."""
    env, dead = loaded, 2
    T = env.cfg.periods
    valid = torch.ones((3, T, env.num_sas), dtype=torch.bool)
    valid[..., dead] = False
    sched = dict(valid=valid, lat_mult=torch.ones(valid.shape),
                 bw_mult=torch.ones(valid.shape))
    traces, states = env.new_episodes(np.random.default_rng(3), 3)
    noise = None
    if policy == "fcfs":
        act = lambda f, m, sl, st, a: BL.fcfs_h(sl, st, env)
    else:
        # exploration noise spreads the untrained actor over every SA
        p = P.init_actor(torch.Generator().manual_seed(2), _pcfg(env), "cpu")
        act = RO._policy_act_fn(p, _pcfg(env))
        noise = RO.noise_block(env, 3, torch.Generator().manual_seed(0))
    rec, seen = _record(act)
    final = env.episode(states, traces, rec, aux=noise, churn=sched)[0]
    assert (final["sa_free"][:, dead] == 0.0).all()
    assert all(not ((sa == dead) & v).any() for sa, v, _ in seen)
    plain = env.episode(states, traces, act, aux=noise)[0]
    assert (plain["sa_free"][:, dead] > 0.0).any()


def test_join_event_flips_validity(loaded):
    env, j = loaded, 1
    T = env.cfg.periods
    never = C.compile_schedule(_events([(T + 1, j, C.EV_JOIN, 1.0)]), T,
                               env.num_sas)
    mid = C.compile_schedule(_events([(T // 2, j, C.EV_JOIN, 1.0)]), T,
                             env.num_sas)
    v = mid["valid"][:, j].numpy()
    assert not never["valid"][:, j].any()
    assert not v[:T // 2].any() and v[T // 2:].all()
    traces, states = env.new_episodes(np.random.default_rng(4), 2)
    act = lambda f, m, sl, st, a: BL.fcfs_h(sl, st, env)
    run = lambda s: env.episode(states, traces, act, churn={
        k: x.expand(2, *x.shape) for k, x in s.items()})[0]
    assert (run(never)["sa_free"][:, j] == 0.0).all()
    assert (run(mid)["sa_free"][:, j] > 0.0).any()


def test_throttle_lowers_sla(loaded):
    """Memory-path degradation never improves the SLA on the same seeds,
    and a heavy one costs hits."""
    seeds = [31, 32, 33]
    base = RO.evaluate_batch_baseline(loaded, BL.fcfs_h, seeds)
    hit = RO.evaluate_batch_baseline(
        loaded, BL.fcfs_h, seeds,
        churn=C.churn_preset("throttle", n_events=2, magnitude=16.0))
    assert hit["sla_rate"] <= base["sla_rate"] + 1e-9
    assert hit["counted"] == base["counted"]


# ---------------------------------------------------------------------------
# a churned round and churned evaluation against JAX
# ---------------------------------------------------------------------------
def test_churned_round_matches_jax_round(envs):
    jenv, env = envs
    jdcfg = JD.DDPGConfig(policy=JP.PolicyConfig(
        feat_dim=jenv.feat_dim, act_dim=jenv.act_dim, hidden=HIDDEN))
    dcfg = D.DDPGConfig(policy=_pcfg(env))
    jstate = JD.init_ddpg(jax.random.PRNGKey(0), jdcfg)
    cap, sigma, B = 64, np.float32(0.3), ROUND_KW["batch_episodes"]
    key = jax.random.PRNGKey(5)
    jchurn = JC.churn_preset("mixed")
    jnew, jbuf, jsigma, jm = make_train_round(jenv, jdcfg, churn=jchurn,
                                              **ROUND_KW)(
        jax.tree.map(jnp.copy, jstate),
        JR.replay_init(cap, jenv.seq_len, jenv.feat_dim, jenv.act_dim),
        key, jnp.float32(sigma), jnp.bool_(True))
    # what the JAX round draws from its key (train.py:140-143)
    ktrace, kroll, kup, kchurn = jax.random.split(key, 4)
    tr = generate_traces_jax(jenv.min_lat, jenv.arrivals, ktrace, B)
    z = jax.random.normal(kroll, (B, KW["periods"], KW["max_rq"],
                                  jenv.act_dim))
    n = min(B * KW["periods"], cap)
    idx = [jax.random.randint(k, (ROUND_KW["batch_size"],), 0, n)
           for k in jax.random.split(kup, ROUND_KW["num_updates"])]
    sched = JC.churn_schedules_jax(jchurn, KW["periods"], jenv.num_sas,
                                   jax.random.split(kchurn, B))
    assert not np.asarray(sched["valid"]).all()
    draws = dict(traces=jax.tree.map(np.asarray, tr),
                 noise=torch.tensor(np.asarray(z)),
                 idx=torch.tensor(np.stack([np.asarray(i) for i in idx])),
                 churn={k: torch.tensor(np.asarray(v))
                        for k, v in sched.items()})
    state = D.ddpg_state_from_numpy(jax.tree.map(np.asarray, jstate), dcfg,
                                    device="cpu")
    buf = replay_init(cap, env.seq_len, env.feat_dim, env.act_dim, "cpu")
    new, buf, sig, m = TR._round_body(env, dcfg, churn=C.churn_preset("mixed"),
                                      **ROUND_KW)(state, buf, draws,
                                                  float(sigma), True)
    assert sig == float(jsigma) and buf["size"] == int(jbuf["size"])
    for k in ("mask", "mask2"):
        np.testing.assert_array_equal(buf[k].numpy(), np.asarray(jbuf[k]))
    for k in ("s", "a", "r", "s2"):
        np.testing.assert_allclose(buf[k].numpy(), np.asarray(jbuf[k]), **TOL)
    assert m["sla"] == float(jm["sla"])
    for k in TR.INFO_KEYS:
        assert m[k] == pytest.approx(float(jm[k]), rel=1e-4, abs=1e-6), k
    U = ROUND_KW["num_updates"]
    for name, lr in (("actor", dcfg.actor_lr), ("critic", dcfg.critic_lr)):
        for g, w in zip(D.tree_leaves(getattr(new, name)),
                        jax.tree.leaves(getattr(jnew, name))):
            w = np.asarray(w)
            lim = 2 * lr * U + 1e-5 * np.abs(w).max()
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=lim)
    # the port's own draws: schedules of the round's episodes
    d2 = TR.round_draws(env, 7, batch_episodes=B, num_updates=1,
                        batch_size=4, size_after=8,
                        churn=C.churn_preset("mixed"))
    assert d2["churn"]["valid"].shape == (B, KW["periods"], env.num_sas)


@pytest.mark.parametrize("policy", ["relmas", "fcfs", "herald", "magma"])
def test_eval_under_churn_matches_jax(envs, params, policy):
    """``_eval_churn_schedules`` draws the NumPy schedules per eval seed
    in both packages: equal counted / hits per episode, and the same
    means from the ``evaluate_*`` entry points.  MAGMA (population 8, 4
    generations) runs each period's search on the draws JAX takes from
    that period's key (one key per episode, split per period), as in
    tests/test_torch_magma.py; its entry point draws from a generator,
    so there only its validity is checked."""
    jenv, env = envs
    jp, tp = params
    seeds = range(7000, 7003)
    churn, jchurn = C.churn_preset("mixed"), JC.churn_preset("mixed")
    jtr, jst = JRO.stack_episodes(jenv, seeds)
    tr, st = RO.stack_episodes(env, seeds)
    sched = RO._eval_churn_schedules(env, churn, seeds)
    jsched = JRO._eval_churn_schedules(jenv, jchurn, seeds)
    assert sched["valid"].shape == (3, KW["periods"], env.num_sas)
    assert not sched["valid"].all()
    if policy == "relmas":
        jpcfg = JP.PolicyConfig(feat_dim=jenv.feat_dim, act_dim=jenv.act_dim,
                                hidden=HIDDEN)
        jm = JRO.make_evaluate_batch(jenv, jpcfg, churn=True)(jp, jst, jtr,
                                                              jsched)
        m = RO.make_evaluate_batch(env, _pcfg(env))(tp, st, tr, sched)
        want = JRO.evaluate_batch(jenv, jpcfg, jp, seeds, churn=jchurn)
        got = RO.evaluate_batch(env, _pcfg(env), tp, seeds, churn=churn)
    elif policy == "magma":
        from test_torch_magma import JMCFG, MCFG, _search_draws, _stack
        jm = JRO.make_baseline_episode_batch(
            jenv, JBL.make_magma_baseline(JMCFG), churn=True)(
            jst, jtr, seeds=seeds, churn_scheds=jsched)
        per_ep = [jax.random.split(jax.random.PRNGKey(s), KW["periods"])
                  for s in seeds]
        draws = [_stack([_search_draws(per_ep[e][p], env)
                         for e in range(len(seeds))])
                 for p in range(KW["periods"])]
        fn = BL.make_magma_baseline(MCFG)
        m = RO.make_baseline_episode_batch(env, fn)(st, tr, draws,
                                                    churn_scheds=sched)
        assert int(m["counted"].sum()) > 0
        got = RO.evaluate_batch_baseline(env, fn, seeds, churn=churn)
        assert 0.0 <= got["sla_rate"] <= 1.0
        assert got["arrived"] == float(np.mean(np.asarray(jm["arrived"])))
        want = {}
    else:
        jm = JRO.make_baseline_episode_batch(
            jenv, JBL.BASELINES[policy], churn=True)(
            jst, jtr, seeds=seeds, churn_scheds=jsched)
        m = RO.make_baseline_episode_batch(env, BL.BASELINES[policy])(
            st, tr, churn_scheds=sched)
        want = JRO.evaluate_batch_baseline(jenv, JBL.BASELINES[policy],
                                           seeds, churn=jchurn)
        got = RO.evaluate_batch_baseline(env, BL.BASELINES[policy], seeds,
                                         churn=churn)
    for k in ("counted", "hits", "arrived"):
        np.testing.assert_array_equal(m[k].numpy(), np.asarray(jm[k]))
    np.testing.assert_allclose(m["energy_uj"].numpy(),
                               np.asarray(jm["energy_uj"]), rtol=1e-5)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
