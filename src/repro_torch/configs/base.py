"""Architecture + input-shape descriptors."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str            # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab: int = 0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1      # every k-th layer is MoE (jamba: 2)
    capacity_factor: float = 1.25
    # --- SSM (Mamba-2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssd_chunk: int = 128
    # --- attention flavour ---
    window: int = 0          # sliding-window size (Mixtral: 4096)
    rope_theta: float = 10000.0
    # --- hybrid (Jamba): attn at index attn_index of every attn_every ---
    attn_every: int = 0
    attn_index: int = 0
    # --- encoder-decoder (Whisper) ---
    enc_layers: int = 0
    n_frames: int = 0        # precomputed frame embeddings (audio stub)
    # --- VLM ---
    n_patches: int = 0       # precomputed patch embeddings (vision stub)
    vit_dim: int = 0         # stub patch-embedding dim (projector input)
    # --- numerics / training ---
    param_dtype: str = "bfloat16"
    remat: bool = True
    # scan-over-layers unrolling + attention q-block: production keeps the
    # rolled loop (compile time, HLO size); the roofline cost modules set
    # scan_unroll=True and attn_block_q=inf because XLA's HloCostAnalysis
    # counts a while body ONCE (see launch/roofline.py).
    scan_unroll: bool = False
    attn_block_q: int = 512
    # decode KV-cache write strategy: "onehot" keeps seq-sharded caches
    # sharded (zero resharding collectives under SPMD); "scatter" writes
    # one slot (minimal HBM traffic, unsharded/CPU path).  §Perf H2.
    cache_update: str = "onehot"
    optimizer: str = "adamw"      # adafactor for the 405B config
    moment_dtype: str = "float32" # adam moment dtype (bf16 for huge configs)
    lr_schedule: str = "cosine"   # cosine | wsd (MiniCPM)
    grad_accum: int = 1           # microbatch accumulation inside train_step
    zloss: float = 0.0            # logit z-loss coefficient (stability)
    aux_loss_w: float = 0.01      # MoE load-balance loss weight
    tie_embeddings: bool = False
    # sub-quadratic? (drives long_500k applicability)
    subquadratic: bool = False
    source: str = ""              # provenance note ([arXiv; tier])

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to 256 so the embedding/head shard 16-way TP.

        Standard MaxText-style padding: padded logit columns receive no
        targets; see DESIGN.md 'Assumptions changed'.
        """
        return -(-self.vocab // 256) * 256

    @property
    def n_ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_headdim if \
            self.ssm_state else 0


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}
