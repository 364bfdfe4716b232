"""Per-SA hardware descriptors: the fleet as a *feature*, not a shape.

A copy of the JAX package's ``costmodel/descriptors.py``: the NumPy
tables are the same code; :func:`churn_descriptors` is written in torch.

RELMAS (paper Sec. 4.1) encodes the platform only implicitly — slot
features are ``4 + 2M`` numbers whose *meaning* depends on which fleet
the agent was trained on, so every fleet needs its own checkpoint.
Following the hardware-conditioning argument of Herald-style fair
scheduling (arXiv:2403.00766) and MoCA (arXiv:2305.05843), this module
turns the platform into an explicit input: a static descriptor vector
per sub-accelerator, derived from the :class:`~repro_torch.costmodel
.accelerators.SAClass` / :class:`~repro_torch.costmodel
.accelerators.MASConfig` the registration phase already consumes.

Descriptor layout (:data:`DESC_FIELDS`, one row per SA slot):

====  ===========  ====================================================
 idx  field        value
====  ===========  ====================================================
   0  present      1.0 for a real SA, 0.0 for an ``M_max`` padding slot
   1  df_rs        dataflow one-hot: row-stationary (Eyeriss-class)
   2  df_ws        dataflow one-hot: weight-stationary (Simba-class)
   3  peak_macs    log2(peak MACs/cycle) / 16   (simba_small 256 -> .5)
   4  gbuf         log2(global buffer KiB) / 16
   5  pe_buf       log2(total PE-local KiB) / 16  (num_pe * pe_buf)
   6  clock        clock GHz / 4                  (Table 1: 1 GHz)
   7  bw_share     log2(1 + DRAM GB/s / M) / 10   (per-SA fair share)
====  ===========  ====================================================

All values land in [0, 1] for every Table-1 instance *and* the
HBM-class datacenter scale-ups (log scales: PE counts and buffer sizes
span three orders of magnitude across presets).  Padding rows are
all-zero — ``present`` doubles as the validity mask the M-agnostic
policy consumes (``repro_torch.core.generalist``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.costmodel.accelerators import FREQ_GHZ, MASConfig, SAClass

DESC_FIELDS = ("present", "df_rs", "df_ws", "peak_macs", "gbuf",
               "pe_buf", "clock", "bw_share")
DESC_DIM = len(DESC_FIELDS)

# normalization references (denominators of the table above); chosen so
# the largest preset instance (eyeriss_xl: 16384 MACs/cycle, 8 MiB gbuf,
# 819 GB/s HBM share) stays strictly inside [0, 1]
_LOG2_MACS_REF = 16.0     # 64Ki MACs/cycle
_LOG2_KIB_REF = 16.0      # 64 MiB
_CLOCK_REF_GHZ = 4.0
_LOG2_BW_REF = 10.0       # 1 TB/s per-SA share


def sa_descriptor(sa: SAClass, mas: MASConfig) -> np.ndarray:
    """Static descriptor row (DESC_DIM,) for one SA inside one MAS.

    Depends only on the SA class and the MAS-level shared-bandwidth
    share — two fleets containing the same SAClass at the same DRAM
    share produce identical rows (the property that makes descriptors
    transferable across fleets).
    """
    bw_share = mas.dram_gbps / max(1, mas.num_sas)
    return np.array([
        1.0,
        1.0 if sa.dataflow == "rs" else 0.0,
        1.0 if sa.dataflow == "ws" else 0.0,
        math.log2(max(1, sa.peak_macs_per_cycle)) / _LOG2_MACS_REF,
        math.log2(max(1.0, sa.gbuf_bytes / 1024.0)) / _LOG2_KIB_REF,
        math.log2(max(1.0, sa.num_pe * sa.pe_buf_bytes / 1024.0))
        / _LOG2_KIB_REF,
        FREQ_GHZ / _CLOCK_REF_GHZ,
        math.log2(1.0 + bw_share) / _LOG2_BW_REF,
    ], dtype=np.float32)


def fleet_descriptors(mas: MASConfig, m_max: int | None = None) -> np.ndarray:
    """Descriptor table (m_max, DESC_DIM) for a whole fleet.

    Rows beyond ``mas.num_sas`` (when padding to a larger ``m_max``)
    are all-zero: ``present == 0`` marks them invalid for the
    M-agnostic policy's masked allocation.
    """
    m_max = mas.num_sas if m_max is None else m_max
    if m_max < mas.num_sas:
        raise ValueError(f"m_max {m_max} < fleet num_sas {mas.num_sas}")
    out = np.zeros((m_max, DESC_DIM), dtype=np.float32)
    for i, sa in enumerate(mas.sas):
        out[i] = sa_descriptor(sa, mas)
    return out


_PEAK_MACS_IDX = DESC_FIELDS.index("peak_macs")
_BW_SHARE_IDX = DESC_FIELDS.index("bw_share")


def churn_descriptors(desc, valid, lat_mult, bw_mult):
    """Time-varying descriptor rows under in-episode churn.

    ``desc`` is the static ``(M, DESC_DIM)`` fleet table; ``valid`` /
    ``lat_mult`` / ``bw_mult`` are one period's churn rows, ``(M,)`` or
    ``(S, M)`` (``repro_torch.sim.churn``); the result is ``(..., M,
    DESC_DIM)``.  An invalid (failed / not-yet-joined) SA's row zeroes
    out, like an ``M_max`` padding slot; a slowed SA's ``peak_macs``
    field drops by ``log2(lat_mult)`` on its log scale, a throttled
    SA's ``bw_share`` by ``log2(bw_mult)``.

    All-true validity with unit multipliers is the bit-exact identity
    (``x * 1.0`` and ``x + (-0.0)`` keep every IEEE bit).
    """
    desc = torch.as_tensor(desc)
    v = valid.to(desc.dtype)
    out = desc * v[..., None]
    out[..., _PEAK_MACS_IDX] += (-v * torch.log2(lat_mult).to(desc.dtype)
                                 / _LOG2_MACS_REF)
    out[..., _BW_SHARE_IDX] += (-v * torch.log2(bw_mult).to(desc.dtype)
                                / _LOG2_BW_REF)
    return out
