"""LM model zoo, every family of the reference (dense, MoE, Mamba-2,
the Jamba hybrid, encoder-decoder, VLM): layers, the MoE FFN, the
Mamba-2 block, the decoder stacks, the Whisper encoder-decoder, the
``LM`` module, its train step and its serving steps (a port of
``repro.models``)."""
from repro_torch.models.model import LM, build_model, lm_params_from_numpy
from repro_torch.models.steps import (make_decode_step, make_loss_fn,
                                      make_prefill_step, make_train_step)

__all__ = ["LM", "build_model", "lm_params_from_numpy", "make_prefill_step",
           "make_decode_step", "make_loss_fn", "make_train_step"]
