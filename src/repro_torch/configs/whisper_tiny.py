"""whisper-tiny — enc-dec, conv frontend stubbed [arXiv:2212.04356;
unverified].

4L encoder + 4L decoder, d_model=384 6H (MHA kv=6) d_ff=1536
vocab=51865, 1500 audio frames.  The log-mel + conv frontend is a STUB:
``input_specs()`` provides precomputed frame embeddings (B, 1500, 384).
Decode shapes run (it has a decoder); long_500k is skipped (full
attention).
"""
from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, enc_layers=4, d_model=384, n_heads=6, n_kv=6, head_dim=64,
    d_ff=1536, vocab=51865, n_frames=1500, tie_embeddings=True,
    source="[arXiv:2212.04356; unverified]",
)

SMOKE = ArchConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16,
    d_ff=128, vocab=512, n_frames=8, tie_embeddings=True,
    param_dtype="float32", remat=False,
)
