"""internlm2-1.8b — GQA dense [arXiv:2403.17297; hf].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv=8, head_dim=128,
    d_ff=8192, vocab=92544,
    source="[arXiv:2403.17297; hf]",
)

SMOKE = ArchConfig(
    name="internlm2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
    d_ff=128, vocab=512, param_dtype="float32", remat=False,
)
