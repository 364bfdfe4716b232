"""Architecture configs (``--arch <id>``): the ten LM architectures as
plain data, copies of ``repro.configs``."""
from repro_torch.configs.base import ArchConfig, SHAPES, ShapeSpec
from repro_torch.configs.registry import (ARCHS, SMOKES, get_arch,
                                          list_archs)

__all__ = ["ArchConfig", "SHAPES", "ShapeSpec", "ARCHS", "SMOKES",
           "get_arch", "list_archs"]
