"""Device selection shared by every entry point of the package."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it is unusable.

    Entry points default to ``"cuda"``.  Without a GPU they raise rather
    than fall back to the CPU: a caller that wants the plain CPU path
    (the tests, the parity phases of ``chip_smoke.py``) passes
    ``device="cpu"``.  Float32 products stay full float32 on the card:
    TF32 is switched off for matmuls and cuDNN alike; bf16 matmuls keep
    float32 sums (no reduced-precision split-K reductions).
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain CPU path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev
