"""llama3-405b — GQA, 128k vocab [arXiv:2407.21783; unverified].

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
Memory plan for a 256-chip v5e pod (16 GB HBM): Adafactor (factored
second moment), bf16 params 2D-sharded (fsdp x tp = 256-way -> 3.2 GB),
8-way gradient accumulation (f32 grad accumulator 6.3 GB, one
microbatch of activations at a time).  See DESIGN.md §5.
"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv=8, head_dim=128,
    d_ff=53248, vocab=128256, rope_theta=500000.0,
    optimizer="adafactor", grad_accum=8,
    source="[arXiv:2407.21783; unverified]",
)

SMOKE = ArchConfig(
    name="llama3-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv=2, head_dim=8,
    d_ff=256, vocab=512, optimizer="adafactor", grad_accum=2,
    param_dtype="float32", remat=False,
)
