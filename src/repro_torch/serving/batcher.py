"""Continuous batcher: the data plane of the serving stack, running real
token generation for the LM workloads (a literal port of
``repro.serving.batcher``).

Fixed-slot continuous batching: ``n_slots`` concurrent sequences share
one decode step; new requests are prefilled into free slots; finished
sequences free their slot at once (no batch barrier).  The cache is
preallocated on the model's device by ``model.init_cache``: a
``(L, n_slots, Hkv, smax, D)`` K/V pair for the dense, MoE and VLM
families, the SSM and conv states ``(L, n_slots, ...)`` for Mamba-2,
one of either per sublayer for the hybrid; per-slot positions advance
independently.  The batcher knows no family.  It passes no ``frames``
or ``patches``, as the reference's does not: whisper decodes against
a zero cross cache, and a VLM request is text only.

``add`` prefills a prompt token by token through full batched decode
steps.  While it does, the other slots re-run their last token at their
last position.  For attention that rewrites the same cache slot with
the same values; for an SSM it advances the slot's state once more.  A
slot's SSM and conv state are not reset when a new request takes it.
Both are the reference's behaviour, kept as they are, so Mamba-2 token
streams, and the hybrid's through its Mamba-2 sublayers, depend on the
slots' history.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.model import LM
from repro_torch.models.steps import make_decode_step


@dataclasses.dataclass
class _Slot:
    req: object | None = None
    pos: int = 0
    remaining: int = 0


class ContinuousBatcher:
    def __init__(self, model: LM, *, n_slots: int = 4, smax: int = 256,
                 eos: int | None = None):
        self.model = model
        self.cfg = model.cfg
        self.n_slots = n_slots
        self.smax = smax
        self.eos = eos
        self.cache = model.init_cache(n_slots, smax, model.dtype)
        self.slots = [_Slot() for _ in range(n_slots)]
        self._decode = make_decode_step(model)
        self._tok = np.zeros((n_slots, 1), np.int32)
        self._pos = np.zeros((n_slots,), np.int32)

    # ------------------------------------------------------------------
    def has_free_slot(self) -> bool:
        return any(s.req is None for s in self.slots)

    def active(self) -> int:
        return sum(s.req is not None for s in self.slots)

    def add(self, req) -> bool:
        """Prefill ``req.prompt`` token by token into a free slot."""
        for i, s in enumerate(self.slots):
            if s.req is None:
                s.req, s.pos, s.remaining = req, 0, req.max_new
                # single-slot prefill: feed prompt tokens sequentially
                for t in req.prompt:
                    self._tok[i, 0] = int(t)
                    self._pos[i] = s.pos
                    self._step()
                    s.pos += 1
                return True
        return False

    def _step(self):
        dev = self.model.device
        batch = {"token": torch.from_numpy(self._tok).to(dev),
                 "pos": torch.from_numpy(self._pos).to(dev)}
        tok, logits, self.cache = self._decode(self.cache, batch)
        return tok.cpu().numpy(), logits

    def step(self) -> list:
        """One batched decode step; returns requests finished this step."""
        if self.active() == 0:
            return []
        for i, s in enumerate(self.slots):
            if s.req is not None:
                self._pos[i] = s.pos
        tok, _ = self._step()
        done = []
        for i, s in enumerate(self.slots):
            if s.req is None:
                continue
            t = int(tok[i])
            s.req.tokens_out.append(t)
            self._tok[i, 0] = t
            s.pos += 1
            s.remaining -= 1
            if s.remaining <= 0 or (self.eos is not None and t == self.eos) \
                    or s.pos >= self.smax - 1:
                done.append(s.req)
                s.req = None
        return done
