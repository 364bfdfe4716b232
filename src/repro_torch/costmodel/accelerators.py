"""Analytical sub-accelerator model (paper Table 1) + layer cost evaluation.

Latency model
-------------
``compute_cycles = macs / (peak_macs_per_cycle * util)`` where ``util``
is a dataflow-specific base utilization per layer kind, degraded for
layers too small to fill the PE array / MAC lanes.

DRAM traffic follows the classic tiled-GEMM reuse analysis: the
*stationary* operand is fetched once, the streaming operand is refetched
once per stationary tile:

- weight-stationary (Simba): weights resident in PE weight buffers;
  tile ``Tn = wbuf / (K*dbytes)``; input refetched ``ceil(N/Tn)`` times.
- row-stationary (Eyeriss): activation rows resident in the global
  buffer; tile ``Tm = gbuf / (K*dbytes)``; weights refetched
  ``ceil(M/Tm)`` times.

``latency = max(compute_cycles, traffic / DRAM_bytes_per_cycle)`` (the
roofline combine, contention-free).  The *bandwidth requirement* fed to
the scheduler is ``b = traffic / latency`` (bytes/cycle == GB/s @1GHz):
memory-bound layers demand the full 16 GB/s, compute-bound layers less —
exactly the quantity whose sum drives the contention model of Sec. 3.

Energy = MACs*e_mac + DRAM traffic*e_dram + buffer traffic*e_buf +
NoP transfer of in/out at 1.3 pJ/bit (paper Table 1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.costmodel.layers import LayerSpec

# Shared platform constants (paper Table 1)
FREQ_GHZ = 1.0
DRAM_GBPS = 16.0            # shared off-chip bandwidth
DRAM_BYTES_PER_CYCLE = DRAM_GBPS / FREQ_GHZ
NOP_GBPS = 100.0
NOP_PJ_PER_BIT = 1.3

# Energy constants (Accelergy-style per-op costs, 45nm-ish)
E_DRAM_PJ_PER_BYTE = 16.0
E_GBUF_PJ_PER_BYTE = 1.2
E_NOP_PJ_PER_BYTE = NOP_PJ_PER_BIT * 8.0


@dataclasses.dataclass(frozen=True)
class SAClass:
    name: str
    dataflow: str            # "rs" (row stationary) | "ws" (weight stationary)
    num_pe: int
    macs_per_pe: int
    gbuf_bytes: int          # global buffer
    pe_buf_bytes: int        # per-PE buffer
    e_mac_pj: float

    @property
    def peak_macs_per_cycle(self) -> int:
        return self.num_pe * self.macs_per_pe

    # base utilization of the PE array by (dataflow, layer kind)
    _UTIL = {
        ("rs", "conv"): 0.85, ("rs", "dwconv"): 0.55, ("rs", "fc"): 0.35,
        ("rs", "gemm"): 0.45, ("rs", "pool"): 0.9, ("rs", "elementwise"): 0.9,
        ("rs", "ssm_scan"): 0.40,
        ("ws", "conv"): 0.70, ("ws", "dwconv"): 0.20, ("ws", "fc"): 0.85,
        ("ws", "gemm"): 0.80, ("ws", "pool"): 0.9, ("ws", "elementwise"): 0.9,
        ("ws", "ssm_scan"): 0.55,
    }

    def utilization(self, layer: LayerSpec) -> float:
        base = self._UTIL[(self.dataflow, layer.kind)]
        # small-layer degradation: not enough independent work to fill the
        # PE array (M*N spatial/output parallelism) or MAC lanes (K depth).
        fill_array = min(1.0, (layer.gemm_m * layer.gemm_n) / self.num_pe)
        fill_lanes = min(1.0, layer.gemm_k / self.macs_per_pe)
        return max(1e-3, base * fill_array * fill_lanes)

    def dram_traffic(self, layer: LayerSpec) -> float:
        """Tiled-GEMM DRAM traffic in bytes (>= compulsory floor)."""
        if layer.kind in ("pool", "elementwise"):
            return float(layer.traffic_floor)
        k_bytes = max(1, layer.gemm_k * layer.dtype_bytes)
        if self.dataflow == "ws":
            wbuf = self.num_pe * self.pe_buf_bytes          # weights live in PE bufs
            tile_n = max(1, wbuf // k_bytes)
            refetch = math.ceil(layer.gemm_n / tile_n)
            return float(layer.w_bytes + layer.in_bytes * refetch + layer.out_bytes)
        else:  # rs: activation rows resident in global buffer
            tile_m = max(1, self.gbuf_bytes // k_bytes)
            refetch = math.ceil(layer.gemm_m / tile_m)
            return float(layer.in_bytes + layer.w_bytes * refetch + layer.out_bytes)

    def compute_cycles(self, layer: LayerSpec) -> float:
        if layer.kind in ("pool", "elementwise"):
            # one op per element through the vector path
            return layer.gemm_m * layer.gemm_k / max(1, self.peak_macs_per_cycle)
        return layer.macs / (self.peak_macs_per_cycle * self.utilization(layer))


def layer_cost(sa: SAClass, layer: LayerSpec,
               dram_gbps: float = DRAM_GBPS) -> tuple[float, float, float]:
    """-> (latency_us, bandwidth_GBps, energy_uJ) for `layer` alone on `sa`.

    ``dram_gbps`` is the MAS's *shared* bandwidth (Table 1: 16 GB/s for
    the edge chiplet system; HBM-class for the datacenter LM scenario).
    """
    traffic = sa.dram_traffic(layer)
    comp = sa.compute_cycles(layer)
    mem = traffic / (dram_gbps / FREQ_GHZ)
    cycles = max(comp, mem, 1.0)
    latency_us = cycles / (FREQ_GHZ * 1e3)
    bw_gbps = traffic / cycles  # bytes/cycle == GB/s at 1 GHz
    buf_traffic = layer.traffic_floor * 2.0  # in+out of the global buffer
    energy_pj = (layer.macs * sa.e_mac_pj
                 + traffic * E_DRAM_PJ_PER_BYTE
                 + buf_traffic * E_GBUF_PJ_PER_BYTE
                 + (layer.in_bytes + layer.out_bytes) * E_NOP_PJ_PER_BYTE)
    return latency_us, bw_gbps, energy_pj * 1e-6


# ---- Paper Table 1 instances -------------------------------------------------
EYERISS_SMALL = SAClass("eyeriss_small", "rs", num_pe=256, macs_per_pe=1,
                        gbuf_bytes=64 * 1024, pe_buf_bytes=220, e_mac_pj=1.0)
EYERISS_LARGE = SAClass("eyeriss_large", "rs", num_pe=512, macs_per_pe=1,
                        gbuf_bytes=64 * 1024, pe_buf_bytes=220, e_mac_pj=1.0)
SIMBA_SMALL = SAClass("simba_small", "ws", num_pe=16, macs_per_pe=16,
                      gbuf_bytes=32 * 1024, pe_buf_bytes=24 * 1024, e_mac_pj=0.6)
SIMBA_LARGE = SAClass("simba_large", "ws", num_pe=32, macs_per_pe=16,
                      gbuf_bytes=64 * 1024, pe_buf_bytes=24 * 1024, e_mac_pj=0.6)

# Datacenter-class scale-ups (for LM-arch serving scenarios; same dataflows).
EYERISS_XL = dataclasses.replace(EYERISS_LARGE, name="eyeriss_xl", num_pe=16384,
                                 gbuf_bytes=8 * 1024 * 1024)
SIMBA_XL = dataclasses.replace(SIMBA_LARGE, name="simba_xl", num_pe=1024,
                               gbuf_bytes=8 * 1024 * 1024)


@dataclasses.dataclass(frozen=True)
class MASConfig:
    """A multi-accelerator system: the machine the scheduler targets."""
    sas: tuple[SAClass, ...]
    dram_gbps: float = DRAM_GBPS

    @property
    def num_sas(self) -> int:
        return len(self.sas)


# Fig. 1: six chiplets, half Eyeriss-class half Simba-class, small+large mix.
DEFAULT_MAS = MASConfig(sas=(
    EYERISS_LARGE, EYERISS_SMALL, EYERISS_SMALL,
    SIMBA_LARGE, SIMBA_SMALL, SIMBA_SMALL,
))

DATACENTER_MAS = MASConfig(
    sas=(EYERISS_XL, EYERISS_XL, SIMBA_XL, SIMBA_XL),
    dram_gbps=819.0,  # HBM-class shared bandwidth for LM serving scenarios
)
