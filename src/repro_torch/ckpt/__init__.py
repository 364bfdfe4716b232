"""Checkpoints in the JAX package's format (NumPy only)."""
from repro_torch.ckpt.checkpoint import (CheckpointManager, latest_step,
                                         read_checkpoint_meta,
                                         restore_checkpoint, save_checkpoint)

__all__ = ["CheckpointManager", "latest_step", "read_checkpoint_meta",
           "restore_checkpoint", "save_checkpoint"]
