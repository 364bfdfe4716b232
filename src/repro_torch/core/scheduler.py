"""Deployment-time RELMAS scheduler (paper Fig. 2a).

Wraps trained actor parameters into the act-fn interface consumed by
``SchedulingEnv.period``: deterministic (no exploration noise), the
serving actor's whole-sequence ``lstm_seq`` route, one kernel launch
per call on the card.  Batch-first, like the rest of the port:
``feats`` (S, T, F) and ``mask`` (S, T) for ``S`` streams.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import policy as P


class RelmasScheduler:
    def __init__(self, params, cfg: P.PolicyConfig):
        self.params = params
        self.cfg = cfg
        self._seq_cfg = dataclasses.replace(cfg, use_pallas=True)

    @torch.no_grad()
    def __call__(self, feats, mask, *_unused):
        """-> (a (S, T-1, G), prio (S, T-1), sa (S, T-1))."""
        a = P.actor_apply(self.params, self._seq_cfg, feats, mask)
        return a, a[..., 0], torch.argmax(a[..., 1:], dim=-1)

    def macs_per_timestep(self) -> int:
        return P.actor_macs_per_timestep(self.cfg)
