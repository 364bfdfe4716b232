"""Benchmark workloads (paper Table 2) + LM-architecture layerization."""
from repro_torch.workloads.cnn_zoo import (
    squeezenet, yolo_lite, keyword_spotting, alexnet, inception_v3,
    resnet50, yolo_v2, LIGHT_MODELS, HEAVY_MODELS, MIXED_MODELS,
    build_registry, WORKLOADS,
)
from repro_torch.workloads.llm_zoo import (
    llm_layer_specs, build_llm_registry, LM_WORKLOADS,
)

__all__ = [
    "squeezenet", "yolo_lite", "keyword_spotting", "alexnet", "inception_v3",
    "resnet50", "yolo_v2", "LIGHT_MODELS", "HEAVY_MODELS", "MIXED_MODELS",
    "build_registry", "WORKLOADS",
    "llm_layer_specs", "build_llm_registry", "LM_WORKLOADS",
]
