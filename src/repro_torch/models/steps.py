"""Serving step factories: batch prefill and one greedy decode step, as
``repro.models.steps.make_prefill_step`` / ``make_decode_step``, for
every family: the prefill passes the batch through as it is (whisper's
``frames``, the VLM's ``patches``).  The training step is ported with
the LM-training slice."""
from __future__ import annotations

import torch

from repro_torch.models.model import LM


def make_prefill_step(model: LM, *, pad_to: int | None = None):
    @torch.no_grad()
    def prefill_step(batch):
        return model.prefill(batch, pad_to=pad_to)

    return prefill_step


def make_decode_step(model: LM):
    @torch.no_grad()
    def decode_step(cache, batch):
        logits, cache = model.decode_step(cache, batch)
        # greedy token out (serving returns ids, not logits, to the host)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, cache

    return decode_step
