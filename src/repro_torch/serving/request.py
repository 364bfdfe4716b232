"""Inference request objects + synthetic multi-tenant request streams.

Admission validation lives here: :func:`resolve_request` is the single
place a host-side :class:`Request` becomes a device-queue row, and it
rejects malformed requests with clear errors (unknown model id, a
non-positive SLA budget) *before* they can scatter poisoned rows into
the device-resident queue — a bad deadline or an out-of-range model
index would otherwise silently corrupt every downstream SLA number.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    tenant: str              # model name (registry key)
    arrival_us: float
    deadline_us: float
    # SLA budget used for reward-slack normalization; None derives
    # deadline - arrival (trace replays pass the trace's exact q so the
    # batched path stays bit-identical to the reference)
    q_us: float | None = None
    prompt: np.ndarray | None = None    # token ids (data-plane path)
    max_new: int = 16
    # filled by the service
    finish_us: float = float("inf")
    hit: bool = False
    tokens_out: list = dataclasses.field(default_factory=list)


def resolve_request(req: Request, model_names) -> tuple[int, float, float, float]:
    """Validate + resolve one request into its device-queue row.

    Returns ``(model_id, arrival_us, deadline_us, q_us)``.  Raises
    ``ValueError`` for an unknown model id (tenant not served by the
    registry) or a non-positive SLA budget (``deadline <= arrival``, or
    an explicit ``q_us <= 0``) — the two ways a request can poison the
    queue's env rows.
    """
    try:
        mid = list(model_names).index(req.tenant)
    except ValueError:
        raise ValueError(
            f"request {req.rid}: unknown model id {req.tenant!r}; "
            f"this registry serves {sorted(model_names)}") from None
    budget = req.deadline_us - req.arrival_us
    q = req.q_us if req.q_us is not None else budget
    if budget <= 0 or q <= 0:
        raise ValueError(
            f"request {req.rid} ({req.tenant}): non-positive SLA budget "
            f"(arrival={req.arrival_us}, deadline={req.deadline_us}, "
            f"q={q}); the SLA multiplier must be positive")
    return mid, float(req.arrival_us), float(req.deadline_us), float(q)


def synth_requests(tenants: list[str], *, n: int, horizon_us: float,
                   qos_budget_us: dict[str, float], seed: int = 0,
                   pareto_shape: float = 2.0, vocab: int = 256,
                   prompt_len: int = 8, max_new: int = 16) -> list[Request]:
    """Pareto inter-arrivals (paper Sec. 5), uniform tenant mix."""
    rng = np.random.default_rng(seed)
    mean_ia = horizon_us / max(n, 1)
    xm = mean_ia * (pareto_shape - 1.0) / pareto_shape
    inter = xm * (1.0 + rng.pareto(pareto_shape, size=n))
    arrivals = np.cumsum(np.minimum(inter, 20 * mean_ia))
    arrivals[0] = 0.0
    out = []
    for i, t_us in enumerate(arrivals):
        tenant = tenants[int(rng.integers(len(tenants)))]
        out.append(Request(
            rid=i, tenant=tenant, arrival_us=float(t_us),
            deadline_us=float(t_us + qos_budget_us[tenant]),
            prompt=rng.integers(0, vocab, size=prompt_len).astype(np.int32),
            max_new=max_new))
    return out
