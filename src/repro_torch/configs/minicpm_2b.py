"""minicpm-2b — WSD schedule, llama-like arch [arXiv:2404.06395; hf].

40L d_model=2304 36H (MHA kv=36) d_ff=5760 vocab=122753 (padded to
122880 for TP), tied embeddings, WSD learning-rate schedule.
"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv=36, head_dim=64,
    d_ff=5760, vocab=122753, tie_embeddings=True, lr_schedule="wsd",
    source="[arXiv:2404.06395; hf]",
)

SMOKE = ArchConfig(
    name="minicpm-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16,
    d_ff=128, vocab=512, tie_embeddings=True, lr_schedule="wsd",
    param_dtype="float32", remat=False,
)
