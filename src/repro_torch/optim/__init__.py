"""Optimizers + LR schedules for LM training, a port of ``repro.optim``:
AdamW (moments in a configurable dtype) and Adafactor (factored second
moment, the 405B config's optimizer), the cosine and WSD (MiniCPM)
schedules, global-norm clipping.  Functional transforms over nested
dicts of tensors; ``torch.optim`` is not used (its AdamW decays the
weights another way)."""
from repro_torch.optim.optimizers import (Optimizer, adafactor, adamw,
                                          clip_by_norm, global_norm,
                                          make_optimizer)
from repro_torch.optim.schedules import cosine_lr, make_schedule, wsd_lr

__all__ = ["Optimizer", "adamw", "adafactor", "make_optimizer",
           "global_norm", "clip_by_norm", "cosine_lr", "wsd_lr",
           "make_schedule"]
