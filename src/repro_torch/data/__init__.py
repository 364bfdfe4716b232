"""Token data pipeline: deterministic, resumable, shard-aware (NumPy)."""
from repro_torch.data.pipeline import TokenPipeline, synthetic_batch

__all__ = ["TokenPipeline", "synthetic_batch"]
