"""Architecture registry: ``--arch <id>`` lookup, per-arch shape grids
and the abstract input specs of each cell (``batch_specs`` /
``cache_specs``: tensors with shapes and dtypes and no data), a port of
``repro.configs.registry``.

Shape cells:
  train_4k     seq 4096   x batch 256   -> train step
  prefill_32k  seq 32768  x batch 32    -> prefill (serve)
  decode_32k   seq 32768  x batch 128   -> decode_step (1 token vs cache)
  long_500k    seq 524288 x batch 1     -> decode_step; sub-quadratic only

Modality stubs: encdec gets ``frames`` (B, n_frames, d), vlm gets
``patches`` (B, n_patches, vit_dim) and text tokens filling
``seq_len - n_patches`` positions.
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec, SHAPES

_MODULES = {
    "mamba2-2.7b": "mamba2_2p7b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "deepseek-7b": "deepseek_7b",
    "internlm2-1.8b": "internlm2_1p8b",
    "minicpm-2b": "minicpm_2b",
    "llama3-405b": "llama3_405b",
    "internvl2-76b": "internvl2_76b",
    "whisper-tiny": "whisper_tiny",
    "jamba-v0.1-52b": "jamba_v0p1_52b",
}


def _load(name: str):
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


ARCHS: dict[str, ArchConfig] = {}
SMOKES: dict[str, ArchConfig] = {}
for _name in _MODULES:
    _m = _load(_name)
    ARCHS[_name] = _m.FULL
    SMOKES[_name] = _m.SMOKE


def list_archs() -> list[str]:
    return list(ARCHS)


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return SMOKES[name] if smoke else ARCHS[name]


def shapes_for(cfg: ArchConfig) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        out.append("long_500k")
    return out


def grid() -> list[tuple[str, str]]:
    """All (arch, shape) baseline cells (long_500k only for the
    sub-quadratic archs)."""
    return [(a, s) for a, cfg in ARCHS.items() for s in shapes_for(cfg)]


def shape_spec(name: str) -> ShapeSpec:
    return SHAPES[name]


# ---------------------------------------------------------------------------
# input specs (abstract): what each step is traced against
# ---------------------------------------------------------------------------
def _act_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def _text_len(cfg: ArchConfig, seq_len: int) -> int:
    return seq_len - cfg.n_patches if cfg.family == "vlm" else seq_len


def batch_specs(cfg: ArchConfig, shape: ShapeSpec,
                device: str | torch.device = "meta") -> dict:
    """The *data* inputs of the cell's step as empty tensors on
    ``device`` (``meta`` by default; under ``FakeTensorMode`` fake
    tensors of that device): no storage is allocated either way."""
    B = shape.global_batch
    dt = _act_dtype(cfg)

    def spec(dims, dtype):
        return torch.empty(dims, dtype=dtype, device=device)
    if shape.kind in ("train", "prefill"):
        S = _text_len(cfg, shape.seq_len)
        batch = {"tokens": spec((B, S), torch.int32)}
        if cfg.family == "encdec":
            batch["frames"] = spec((B, cfg.n_frames, cfg.d_model), dt)
        if cfg.family == "vlm":
            batch["patches"] = spec((B, cfg.n_patches, cfg.vit_dim), dt)
        return batch
    # decode: one new token against a cache of shape.seq_len
    return {"token": spec((B, 1), torch.int32),
            "pos": spec((B,), torch.int32)}


def cache_specs(cfg: ArchConfig, shape: ShapeSpec,
                device: str | torch.device = "cpu"):
    """The decode cell's KV / state cache, ``LM.init_cache`` traced
    under ``FakeTensorMode`` (the active one, else a new one): fake
    tensors on ``device`` with no storage."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.model import LM
    mode = detect_fake_mode()
    with mode if mode is not None else FakeTensorMode():
        model = LM(cfg, device=device)
        return model.init_cache(shape.global_batch, shape.seq_len,
                                _act_dtype(cfg))
