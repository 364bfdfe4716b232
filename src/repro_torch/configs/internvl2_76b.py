"""internvl2-76b — InternViT + LLM backbone [arXiv:2404.16821; unverified].

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.  The vision
tower is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (B, 256, vit_dim=1024); the framework owns
the projector (vit_dim -> d_model) and the LM backbone.  Text tokens
fill the remaining sequence positions (total = the cell's seq_len).
"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv=8, head_dim=128,
    d_ff=28672, vocab=128256, n_patches=256, vit_dim=1024,
    grad_accum=4,
    source="[arXiv:2404.16821; unverified]",
)

SMOKE = ArchConfig(
    name="internvl2-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
    d_ff=128, vocab=512, n_patches=4, vit_dim=32,
    param_dtype="float32", remat=False,
)
