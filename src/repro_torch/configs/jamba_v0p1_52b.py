"""jamba-v0.1-52b — Mamba+attention 1:7 interleave, MoE
[arXiv:2403.19887; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2
on every second sublayer.  Super-block layout (attn_every=8): one
attention mixer at index 4 of each 8-layer block, Mamba elsewhere
(Jamba's published 1:7 ratio; Mamba-1 state size 16).  Hybrid ->
sub-quadratic: long_500k runs (4 attention layers carry the full-seq KV
cache at batch=1; Mamba layers carry O(1) state).
"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, head_dim=128,
    d_ff=14336, vocab=65536, n_experts=16, top_k=2, moe_every=2,
    ssm_state=16, ssm_expand=2, ssm_headdim=64, ssm_conv=4, ssd_chunk=128,
    attn_every=8, attn_index=4, subquadratic=True,
    source="[arXiv:2403.19887; hf]",
)

SMOKE = ArchConfig(
    name="jamba-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv=2, head_dim=16,
    d_ff=128, vocab=512, n_experts=4, top_k=2, moe_every=2,
    ssm_state=16, ssm_expand=2, ssm_headdim=16, ssm_conv=4, ssd_chunk=16,
    attn_every=2, attn_index=1, subquadratic=True,
    param_dtype="float32", remat=False,
)
