"""Heuristic scheduling baselines (paper Sec. 5.1), batched over streams.

All baselines emit the same action interface as RELMAS — a temporal
priority and an SA choice per RQ slot — and run on the identical
simulation platform:

- FCFS-H  : first-come-first-served priority + min-finish-time SA
            heuristic (greedy, contention-free estimate).
- PREMA-H : PREMA-style tokens (waiting time over budget) + shortest
            job first among high-token jobs, with the same SA heuristic.
- Herald  : EDF priority + load-balancing SA choice (argmin of the
            accumulated SA load), after Kwon et al.'s HDA scheduler.
- MAGMA   : genetic algorithm over (priority vector, SA assignment)
            with an SLA-aware fitness scored by the contention engine,
            custom operators as in Kao & Krishna (crossover + Gaussian /
            reset mutation), Herald-seeded, with elitism.

Every function takes ``(slots, state, env, rand=None)`` with a leading
stream axis ``S`` on every array.  ``rand`` is the baseline's
randomness, the counterpart of the JAX package's per-period ``key``:
the heuristics ignore it; MAGMA takes a ``torch.Generator`` (the
generations' draws come from it one generation at a time) or the
draws themselves as data (:func:`magma_search_scan`).  The greedy SA
assignment walks the slots in priority order: the JAX package's
``lax.scan`` over slots becomes a Python loop over slots, vectorised
across streams.  MAGMA's generation scan becomes a Python loop over
generations; each generation scores its whole population of every
stream in **one** engine call over ``S * P`` rows.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.sim import engine
from repro_torch.sim.engine import INF


def _greedy_sa(slots, sa_free_rel, prio, mode: str, num_jobs: int):
    """Sequential greedy assignment in descending-priority order.

    mode='finish': pick the SA minimising this SJ's estimated finish.
    mode='load'  : pick the SA minimising its resulting busy time.
    Contention-free estimates (it is a heuristic, as in the paper).
    """
    S, R = prio.shape
    dev = prio.device
    tie = torch.arange(R, dtype=torch.float32, device=dev) * 1e-6
    # stable descending order, as jnp.argsort(-x)
    order = torch.argsort(-(prio - tie), dim=1, stable=True)
    cost_all, valid = slots["cost_all"], slots["valid"]
    job, ready = slots["job"], slots["ready_rel"]
    avail = sa_free_rel.clone()                              # (S, M)
    javail = torch.zeros((S, num_jobs), dtype=torch.float32, device=dev)
    sa = torch.zeros((S, R), dtype=torch.int64, device=dev)
    rows = torch.arange(S, device=dev)
    for step in range(R):
        s = order[:, step]
        j = job[rows, s]
        cost = cost_all[rows, s]                             # (S, M)
        est_start = torch.maximum(
            avail, torch.maximum(javail[rows, j], ready[rows, s])[:, None])
        fin = est_start + cost
        score = fin if mode == "finish" else avail + cost
        m = torch.argmin(torch.where(cost > 0, score, INF), dim=1)
        ok = valid[rows, s]
        fin_m = fin[rows, m]
        avail[rows, m] = torch.where(ok, fin_m, avail[rows, m])
        javail[rows, j] = torch.where(ok, fin_m, javail[rows, j])
        sa[rows, s] = m
    return sa


def _pack_actions(prio, sa, num_sas):
    onehot = torch.nn.functional.one_hot(sa, num_sas).to(torch.float32)
    return torch.cat([prio[..., None], onehot * 2.0 - 1.0], dim=-1)


def _sa_free_rel(state):
    return torch.clamp(state["sa_free"] - state["t"][:, None], min=0.0)


def fcfs_h(slots, state, env, rand=None):
    """FCFS priority (earlier arrival first) + min-finish SA heuristic."""
    t = state["t"][:, None]
    prio = torch.clamp(-(slots["arrival"] - t) / (100.0 * env.cfg.t_s_us),
                       -1.0, 1.0)
    prio = torch.where(slots["valid"], prio, -1.0)
    sa = _greedy_sa(slots, _sa_free_rel(state), prio, "finish",
                    env.cfg.max_jobs)
    return _pack_actions(prio, sa, env.num_sas), prio, sa


def prema_h(slots, state, env, rand=None):
    """PREMA tokens (waiting/budget) gate + SJF among high-token jobs."""
    t = state["t"][:, None]
    token = torch.where(slots["valid"],
                        (t - slots["arrival"])
                        / torch.clamp(slots["q"], min=1e-3), 0.0)
    max_tok = token.amax(1, keepdim=True)
    cand = token >= 0.5 * max_tok
    # SJF score: smaller isolated layer cost -> higher priority
    min_c = torch.where(slots["cost_all"] > 0, slots["cost_all"],
                        INF).amin(2)
    sjf = -torch.clamp(min_c / env.cfg.t_s_us, 0.0, 2.0) / 2.0  # in [-1, 0]
    prio = torch.where(cand, 0.5 + 0.5 * (sjf + 1.0),
                       0.5 * (sjf + 1.0) - 1.0)
    prio = torch.where(slots["valid"], torch.clamp(prio, -1.0, 1.0), -1.0)
    sa = _greedy_sa(slots, _sa_free_rel(state), prio, "finish",
                    env.cfg.max_jobs)
    return _pack_actions(prio, sa, env.num_sas), prio, sa


def herald(slots, state, env, rand=None):
    """EDF priority + load-balancing SA selection (HDA/Herald-style)."""
    t = state["t"][:, None]
    prio = torch.clamp(1.0 - (slots["deadline"] - t)
                       / (env.cfg.ttd_norm_periods * env.cfg.t_s_us),
                       -1.0, 1.0)
    prio = torch.where(slots["valid"], prio, -1.0)
    sa = _greedy_sa(slots, _sa_free_rel(state), prio, "load",
                    env.cfg.max_jobs)
    return _pack_actions(prio, sa, env.num_sas), prio, sa


# ---------------------------------------------------------------------------
# MAGMA: genetic algorithm (offline-strength baseline, run per period)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MagmaConfig:
    population: int = 100   # paper settings: 100 x 100
    generations: int = 100
    tournament: int = 4
    cx_prob: float = 0.8
    mut_sigma: float = 0.25
    mut_prob: float = 0.15
    seed: int = 0


def _magma_fitness(env, state, slots, prio_pop, sa_pop):
    """Fitness ``(S, P)`` of populations ``prio_pop`` / ``sa_pop`` ``(S,
    P, R)``: projected job-final SLA hits plus 1e-3 x the clipped slack,
    from one engine call over the ``S * P`` candidate schedules."""
    S, P, R = prio_pop.shape
    t = state["t"][:, None, None]
    valid, job = slots["valid"], slots["job"]
    # a slot is "job-final" if it is the last uncommitted layer of its job
    nxt_same = torch.zeros_like(valid)
    nxt_same[:, :-1] = (job[:, 1:] == job[:, :-1]) & valid[:, 1:]
    is_final = (valid & ~nxt_same)[:, None]
    rep = lambda x: x[:, None].expand((S, P) + tuple(x.shape[1:])) \
        .reshape((S * P,) + tuple(x.shape[1:]))
    sa = sa_pop.reshape(S * P, R)
    take = lambda x: torch.gather(rep(x), 2, sa[..., None])[..., 0]
    _, fin = engine.simulate(
        rep(valid), sa, prio_pop.reshape(S * P, R), take(slots["cost_all"]),
        take(slots["bw_all"]), rep(slots["dep"]), rep(slots["ready_rel"]),
        rep(_sa_free_rel(state)), env.cfg.bandwidth_gbps,
        num_sas=env.num_sas)
    fin = fin.reshape(S, P, R)
    deadline = slots["deadline"][:, None]
    hit = (t + fin) <= deadline
    slack = torch.clamp((deadline - (t + fin))
                        / torch.clamp(slots["q"][:, None], min=1e-3),
                        -3.0, 3.0)
    hits = torch.where(is_final, hit, False).sum(-1).to(torch.float32)
    return hits + 1e-3 * torch.where(valid[:, None], slack, 0.0).sum(-1)


def _magma_init_draws(env, mcfg: MagmaConfig, S: int,
                      gen: torch.Generator) -> dict:
    """The initial population's draws: uniform priorities in [-1, 1),
    uniform SA indices."""
    shape, dev = (S, mcfg.population, env.cfg.max_rq), env.device
    return dict(prio=torch.rand(shape, generator=gen, device=dev) * 2.0 - 1.0,
                sa=torch.randint(0, env.num_sas, shape, generator=gen,
                                 device=dev))


def _magma_gen_draws(env, mcfg: MagmaConfig, S: int,
                     gen: torch.Generator) -> dict:
    """One generation's eight draws (the JAX package splits eight keys):
    two tournaments, the crossover mask and per-child crossover flag, the
    Gaussian mutation's events and magnitudes, the reset's events and
    values.  Bernoulli draws are booleans."""
    P, R, dev = mcfg.population, env.cfg.max_rq, env.device
    rand = lambda *s: torch.rand((S,) + s, generator=gen, device=dev)
    randint = lambda hi, *s: torch.randint(0, hi, (S,) + s, generator=gen,
                                           device=dev)
    return dict(
        sel_a=randint(P, P, mcfg.tournament),
        sel_b=randint(P, P, mcfg.tournament),
        cx=rand(P, R) < 0.5, do_cx=rand(P, 1) < mcfg.cx_prob,
        mut=rand(P, R) < mcfg.mut_prob,
        normal=torch.randn((S, P, R), generator=gen, device=dev),
        reset=rand(P, R) < mcfg.mut_prob, reset_sa=randint(env.num_sas, P, R))


def _magma_init(env, state, slots, d: dict):
    """Initial population from draws ``d``, individual 0 seeded with the
    Herald heuristic; returns ``(prio_pop, sa_pop, fit)``."""
    prio_pop = d["prio"].to(torch.float32).clone()
    sa_pop = d["sa"].to(torch.int64).clone()
    _, hp, hs = herald(slots, state, env)
    prio_pop[:, 0] = hp
    sa_pop[:, 0] = hs
    return prio_pop, sa_pop, _magma_fitness(env, state, slots, prio_pop,
                                            sa_pop)


def _magma_generation(env, mcfg: MagmaConfig, state, slots, prio_pop,
                      sa_pop, fit, d: dict):
    """One generation from draws ``d``: tournament selection of two
    parent sets, uniform crossover, Gaussian mutation of priorities and
    random reset of assignments, then elitism (the previous best
    replaces the new worst).  On ties argmax / argmin take the first
    index, as in JAX."""
    S, P, R = prio_pop.shape
    rows = torch.arange(S, device=prio_pop.device)

    def select(idx):
        f = torch.gather(fit, 1, idx.reshape(S, -1)).reshape(idx.shape)
        return torch.gather(idx, 2, torch.argmax(f, 2, keepdim=True))[..., 0]

    pick = lambda pop, i: torch.gather(pop, 1, i[..., None].expand(S, P, R))
    pa, pb = select(d["sel_a"].to(torch.int64)), \
        select(d["sel_b"].to(torch.int64))
    cx = d["cx"] & d["do_cx"]
    prio_c = torch.where(cx, pick(prio_pop, pa), pick(prio_pop, pb))
    sa_c = torch.where(cx, pick(sa_pop, pa), pick(sa_pop, pb))
    prio_m = torch.clamp(prio_c + d["mut"].to(torch.float32) * mcfg.mut_sigma
                         * d["normal"].to(torch.float32), -1.0, 1.0)
    sa_m = torch.where(d["reset"], d["reset_sa"].to(torch.int64), sa_c)
    new_fit = _magma_fitness(env, state, slots, prio_m, sa_m)
    best = torch.argmax(fit, 1)
    worst = torch.argmin(new_fit, 1)
    prio_m[rows, worst] = prio_pop[rows, best]
    sa_m[rows, worst] = sa_pop[rows, best]
    new_fit[rows, worst] = fit[rows, best]
    return prio_m, sa_m, new_fit


def magma_search_scan(env, mcfg: MagmaConfig, rand, state, slots):
    """The GA search of one period for every stream.

    ``rand`` is a ``torch.Generator`` on the env's device (each
    generation's draws are taken from it inside the loop: drawing a
    whole period at once would hold ~0.7 GB at paper settings and 32
    streams), None (a generator seeded ``mcfg.seed``), or the draws as
    data: ``dict(init=<_magma_init_draws>, gens=[<_magma_gen_draws>,
    ...])``, how the tests feed in what JAX draws from its keys.

    Returns ``(prio (S, R), sa (S, R), elite_fit (S, generations))``,
    ``elite_fit`` the best fitness after each generation (non-decreasing:
    elitism).  ``1 + generations`` engine calls.
    """
    S = state["t"].shape[0]
    draws = rand if isinstance(rand, dict) else None
    gen = None if draws is not None else (
        rand if rand is not None else
        torch.Generator(device=env.device).manual_seed(mcfg.seed))
    init = (draws["init"] if draws is not None
            else _magma_init_draws(env, mcfg, S, gen))
    prio_pop, sa_pop, fit = _magma_init(env, state, slots, init)
    elite = []
    for g in range(mcfg.generations):
        d = (draws["gens"][g] if draws is not None
             else _magma_gen_draws(env, mcfg, S, gen))
        prio_pop, sa_pop, fit = _magma_generation(env, mcfg, state, slots,
                                                  prio_pop, sa_pop, fit, d)
        elite.append(fit.amax(1))
    rows = torch.arange(S, device=fit.device)
    best = torch.argmax(fit, 1)
    elite_fit = (torch.stack(elite, 1) if elite
                 else fit.new_zeros((S, 0)))
    return prio_pop[rows, best], sa_pop[rows, best], elite_fit


def magma(slots, state, env, mcfg: MagmaConfig = MagmaConfig(), rand=None):
    """GA search per scheduling period (paper: 100 generations x 100
    individuals), packed as a baseline action."""
    prio, sa, _ = magma_search_scan(env, mcfg, rand, state, slots)
    return _pack_actions(prio, sa, env.num_sas), prio, sa


@functools.lru_cache(maxsize=None)
def make_magma_baseline(mcfg: MagmaConfig = MagmaConfig()):
    """MAGMA as an episode baseline ``(slots, state, env, rand=None)``,
    memoised per ``mcfg`` (the same function object for equal configs,
    named ``magma_p<population>g<generations>`` as in JAX)."""
    def magma_b(slots, state, env, rand=None):
        return magma(slots, state, env, mcfg, rand)
    magma_b.mcfg = mcfg
    magma_b.__name__ = f"magma_p{mcfg.population}g{mcfg.generations}"
    return magma_b


BASELINES = {"fcfs": fcfs_h, "prema": prema_h, "herald": herald}
