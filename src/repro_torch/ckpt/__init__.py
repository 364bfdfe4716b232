"""Checkpoint reading (NumPy only)."""
from repro_torch.ckpt.checkpoint import (latest_step, read_checkpoint_meta,
                                         restore_checkpoint)

__all__ = ["latest_step", "read_checkpoint_meta", "restore_checkpoint"]
