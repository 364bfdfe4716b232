"""olmoe-1b-7b — 64 experts top-8 [arXiv:2409.02060; hf].

16L d_model=2048 16H (GQA kv=16) d_ff=1024 (per expert) vocab=50304.
"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv=16, head_dim=128,
    d_ff=1024, vocab=50304, n_experts=64, top_k=8,
    source="[arXiv:2409.02060; hf]",
)

SMOKE = ArchConfig(
    name="olmoe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16,
    d_ff=32, vocab=512, n_experts=8, top_k=2,
    param_dtype="float32", remat=False,
)
