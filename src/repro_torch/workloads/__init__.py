"""Benchmark workloads (paper Table 2): the CNN zoo.

The LM-architecture layerization is not part of this package yet.
"""
from repro_torch.workloads.cnn_zoo import (
    squeezenet, yolo_lite, keyword_spotting, alexnet, inception_v3,
    resnet50, yolo_v2, LIGHT_MODELS, HEAVY_MODELS, MIXED_MODELS,
    build_registry, WORKLOADS,
)

__all__ = [
    "squeezenet", "yolo_lite", "keyword_spotting", "alexnet", "inception_v3",
    "resnet50", "yolo_v2", "LIGHT_MODELS", "HEAVY_MODELS", "MIXED_MODELS",
    "build_registry", "WORKLOADS",
]
