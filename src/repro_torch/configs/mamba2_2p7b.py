"""mamba2-2.7b — SSD (state-space duality) [arXiv:2405.21060; unverified].

64L d_model=2560 attention-free, vocab=50280, ssm_state=128.
expand=2 -> d_inner=5120, headdim=64 -> 80 SSM heads.
"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_conv=4, ssd_chunk=128,
    subquadratic=True,
    source="[arXiv:2405.21060; unverified]",
)

SMOKE = ArchConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, d_ff=0, vocab=512,
    ssm_state=16, ssm_expand=2, ssm_headdim=16, ssm_conv=4, ssd_chunk=16,
    subquadratic=True, param_dtype="float32", remat=False,
)
