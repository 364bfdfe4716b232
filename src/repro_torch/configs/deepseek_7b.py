"""deepseek-7b — llama-arch dense [arXiv:2401.02954; hf].

30L d_model=4096 32H (GQA kv=32, i.e. MHA) d_ff=11008 vocab=102400.
"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv=32, head_dim=128,
    d_ff=11008, vocab=102400,
    source="[arXiv:2401.02954; hf]",
)

SMOKE = ArchConfig(
    name="deepseek-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16,
    d_ff=128, vocab=512, param_dtype="float32", remat=False,
)
