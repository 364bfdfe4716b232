"""Layer descriptors: every schedulable sub-job is one of these.

A layer is reduced to (a) a GEMM-equivalent (M, K, N) triple — the
canonical mapping used by both row-stationary and weight-stationary
dataflow analyses — and (b) its DRAM-resident tensor footprints.
Non-GEMM layers (pooling, activations, elementwise) carry their traffic
and a trivial MAC count; they are bandwidth-bound by construction.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer (== one sub-job type) of a registered DNN model."""
    name: str
    kind: str            # conv | dwconv | fc | gemm | pool | elementwise | ssm_scan
    gemm_m: int          # GEMM-equivalent dims (already include batch)
    gemm_k: int
    gemm_n: int
    in_bytes: int        # DRAM-resident activation input footprint
    w_bytes: int         # weight footprint
    out_bytes: int       # output footprint
    dtype_bytes: int = 1  # int8 CNN inference by default; LMs use 2 (bf16)

    @property
    def macs(self) -> int:
        return self.gemm_m * self.gemm_k * self.gemm_n

    @property
    def traffic_floor(self) -> int:
        """Compulsory DRAM traffic (every tensor touched once)."""
        return self.in_bytes + self.w_bytes + self.out_bytes


def conv2d(name: str, h: int, w: int, cin: int, cout: int, k: int,
           stride: int = 1, batch: int = 1, dtype_bytes: int = 1,
           groups: int = 1) -> LayerSpec:
    """Standard conv mapped to GEMM via im2col: M=B*Ho*Wo, K=Cin/g*k*k, N=Cout."""
    ho, wo = max(1, math.ceil(h / stride)), max(1, math.ceil(w / stride))
    kdim = (cin // groups) * k * k
    return LayerSpec(
        name=name, kind="conv",
        gemm_m=batch * ho * wo, gemm_k=kdim, gemm_n=cout,
        in_bytes=batch * h * w * cin * dtype_bytes,
        w_bytes=(cin // groups) * cout * k * k * dtype_bytes,
        out_bytes=batch * ho * wo * cout * dtype_bytes,
        dtype_bytes=dtype_bytes,
    )


def dwconv2d(name: str, h: int, w: int, c: int, k: int, stride: int = 1,
             batch: int = 1, dtype_bytes: int = 1) -> LayerSpec:
    """Depthwise conv: no cross-channel reuse -> tiny K, poor PE utilization."""
    ho, wo = max(1, math.ceil(h / stride)), max(1, math.ceil(w / stride))
    return LayerSpec(
        name=name, kind="dwconv",
        gemm_m=batch * ho * wo * c, gemm_k=k * k, gemm_n=1,
        in_bytes=batch * h * w * c * dtype_bytes,
        w_bytes=c * k * k * dtype_bytes,
        out_bytes=batch * ho * wo * c * dtype_bytes,
        dtype_bytes=dtype_bytes,
    )


def fc(name: str, cin: int, cout: int, batch: int = 1,
       dtype_bytes: int = 1) -> LayerSpec:
    return LayerSpec(
        name=name, kind="fc",
        gemm_m=batch, gemm_k=cin, gemm_n=cout,
        in_bytes=batch * cin * dtype_bytes,
        w_bytes=cin * cout * dtype_bytes,
        out_bytes=batch * cout * dtype_bytes,
        dtype_bytes=dtype_bytes,
    )


def gemm(name: str, m: int, k: int, n: int, *, weight_resident: bool = True,
         dtype_bytes: int = 2, kind: str = "gemm") -> LayerSpec:
    """Generic GEMM (LM attention/FFN blocks). weight_resident=False marks
    activation x activation products (e.g. QK^T) whose 'weights' are streamed."""
    return LayerSpec(
        name=name, kind=kind,
        gemm_m=m, gemm_k=k, gemm_n=n,
        in_bytes=m * k * dtype_bytes,
        w_bytes=k * n * dtype_bytes,
        out_bytes=m * n * dtype_bytes,
        dtype_bytes=dtype_bytes,
    )


def pool(name: str, h: int, w: int, c: int, k: int, stride: int,
         batch: int = 1, dtype_bytes: int = 1) -> LayerSpec:
    ho, wo = max(1, math.ceil(h / stride)), max(1, math.ceil(w / stride))
    return LayerSpec(
        name=name, kind="pool",
        gemm_m=batch * ho * wo * c, gemm_k=k * k, gemm_n=1,
        in_bytes=batch * h * w * c * dtype_bytes, w_bytes=0,
        out_bytes=batch * ho * wo * c * dtype_bytes,
        dtype_bytes=dtype_bytes,
    )


def elementwise(name: str, numel: int, dtype_bytes: int = 1,
                n_inputs: int = 1) -> LayerSpec:
    return LayerSpec(
        name=name, kind="elementwise",
        gemm_m=numel, gemm_k=1, gemm_n=1,
        in_bytes=numel * dtype_bytes * n_inputs, w_bytes=0,
        out_bytes=numel * dtype_bytes,
        dtype_bytes=dtype_bytes,
    )
