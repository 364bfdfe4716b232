"""Architecture registry: ``--arch <id>`` lookup and per-arch shape grids.

A copy of ``repro.configs.registry`` without the abstract input specs
(``batch_specs``/``cache_specs``), which belong to the dry-run tooling.

Shape cells:
  train_4k     seq 4096   x batch 256   -> train step
  prefill_32k  seq 32768  x batch 32    -> prefill (serve)
  decode_32k   seq 32768  x batch 128   -> decode_step (1 token vs cache)
  long_500k    seq 524288 x batch 1     -> decode_step; sub-quadratic only
"""
from __future__ import annotations

import importlib

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
