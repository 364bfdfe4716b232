"""mixtral-8x7b — 8 experts top-2, SWA [arXiv:2401.04088; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, sliding window
4096 -> sub-quadratic (ring KV cache), long_500k runs.
"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, head_dim=128,
    d_ff=14336, vocab=32000, n_experts=8, top_k=2,
    window=4096, rope_theta=1e6, subquadratic=True,
    source="[arXiv:2401.04088; hf]",
)

SMOKE = ArchConfig(
    name="mixtral-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
    d_ff=128, vocab=512, n_experts=4, top_k=2,
    window=32, subquadratic=True, param_dtype="float32", remat=False,
)
