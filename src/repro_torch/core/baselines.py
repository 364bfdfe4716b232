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

Every function takes ``(slots, state, env)`` with a leading stream axis
``S`` on every array.  The greedy SA assignment walks the slots in
priority order: the JAX package's ``lax.scan`` over slots becomes a
Python loop over slots, vectorised across streams.  MAGMA comes later.
"""
from __future__ import annotations

import torch

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


def fcfs_h(slots, state, env):
    """FCFS priority (earlier arrival first) + min-finish SA heuristic."""
    t = state["t"][:, None]
    prio = torch.clamp(-(slots["arrival"] - t) / (100.0 * env.cfg.t_s_us),
                       -1.0, 1.0)
    prio = torch.where(slots["valid"], prio, -1.0)
    sa = _greedy_sa(slots, _sa_free_rel(state), prio, "finish",
                    env.cfg.max_jobs)
    return _pack_actions(prio, sa, env.num_sas), prio, sa


def prema_h(slots, state, env):
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


def herald(slots, state, env):
    """EDF priority + load-balancing SA selection (HDA/Herald-style)."""
    t = state["t"][:, None]
    prio = torch.clamp(1.0 - (slots["deadline"] - t)
                       / (env.cfg.ttd_norm_periods * env.cfg.t_s_us),
                       -1.0, 1.0)
    prio = torch.where(slots["valid"], prio, -1.0)
    sa = _greedy_sa(slots, _sa_free_rel(state), prio, "load",
                    env.cfg.max_jobs)
    return _pack_actions(prio, sa, env.num_sas), prio, sa


BASELINES = {"fcfs": fcfs_h, "prema": prema_h, "herald": herald}
