"""The reference's cost tables: each tenant's layers characterised on
each sub-accelerator of the configuration's fleet.

A frozen copy of the port's analytical model (``costmodel/layers.py``,
``costmodel/accelerators.py::layer_cost``, ``costmodel/registry.py``)
and of the paper's CNN zoo (``workloads/cnn_zoo.py``, Table 2).  The
fleet's sub-accelerators come from the configuration file, so the
tables are worked out here from the configuration alone.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

FREQ_GHZ = 1.0
E_DRAM_PJ_PER_BYTE = 16.0
E_GBUF_PJ_PER_BYTE = 1.2
E_NOP_PJ_PER_BYTE = 1.3 * 8.0

# base utilisation of the PE array by (dataflow, layer kind)
UTIL = {
    ("rs", "conv"): 0.85, ("rs", "dwconv"): 0.55, ("rs", "fc"): 0.35,
    ("rs", "pool"): 0.9,
    ("ws", "conv"): 0.70, ("ws", "dwconv"): 0.20, ("ws", "fc"): 0.85,
    ("ws", "pool"): 0.9,
}


@dataclasses.dataclass(frozen=True)
class Layer:
    kind: str
    m: int
    k: int
    n: int
    in_bytes: int
    w_bytes: int
    out_bytes: int
    dtype_bytes: int = 1

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n

    @property
    def floor(self) -> int:
        return self.in_bytes + self.w_bytes + self.out_bytes


def conv2d(h, w, cin, cout, k, stride=1, dtype_bytes=1):
    ho, wo = max(1, math.ceil(h / stride)), max(1, math.ceil(w / stride))
    return Layer("conv", ho * wo, cin * k * k, cout, h * w * cin * dtype_bytes,
                 cin * cout * k * k * dtype_bytes, ho * wo * cout * dtype_bytes,
                 dtype_bytes)


def dwconv2d(h, w, c, k, stride=1, dtype_bytes=1):
    ho, wo = max(1, math.ceil(h / stride)), max(1, math.ceil(w / stride))
    return Layer("dwconv", ho * wo * c, k * k, 1, h * w * c * dtype_bytes,
                 c * k * k * dtype_bytes, ho * wo * c * dtype_bytes,
                 dtype_bytes)


def fc(cin, cout, dtype_bytes=1):
    return Layer("fc", 1, cin, cout, cin * dtype_bytes,
                 cin * cout * dtype_bytes, cout * dtype_bytes, dtype_bytes)


def pool(h, w, c, k, stride, dtype_bytes=1):
    ho, wo = max(1, math.ceil(h / stride)), max(1, math.ceil(w / stride))
    return Layer("pool", ho * wo * c, k * k, 1, h * w * c * dtype_bytes, 0,
                 ho * wo * c * dtype_bytes, dtype_bytes)


# ---- the paper's CNN tenants (Table 2), chains of layers --------------------
def squeezenet():
    ls = [conv2d(224, 224, 3, 96, 7, 2), pool(111, 111, 96, 3, 2)]
    h, cin = 55, 96
    fires = [(16, 64, 64), (16, 64, 64), (32, 128, 128), (32, 128, 128),
             (48, 192, 192), (48, 192, 192), (64, 256, 256), (64, 256, 256)]
    for i, (s, e1, e3) in enumerate(fires, start=2):
        ls += [conv2d(h, h, cin, s, 1), conv2d(h, h, s, e1, 1),
               conv2d(h, h, s, e3, 3)]
        cin = e1 + e3
        if i in (4, 8):
            ls.append(pool(h, h, cin, 3, 2))
            h //= 2
    return ls + [conv2d(h, h, cin, 1000, 1), pool(h, h, 1000, h, h)]


def yolo_lite():
    ls, h, cin = [], 224, 3
    for cout in (16, 32, 64, 128, 128, 256):
        ls += [conv2d(h, h, cin, cout, 3), pool(h, h, cout, 2, 2)]
        h, cin = h // 2, cout
    return ls + [conv2d(h, h, cin, 125, 1)]


def keyword_spotting():
    ls = [conv2d(49, 10, 1, 64, 10, 2)]
    h, w = 25, 5
    for _ in range(4):
        ls += [dwconv2d(h, w, 64, 3), conv2d(h, w, 64, 64, 1)]
    return ls + [pool(h, w, 64, h, h), fc(64, 12)]


def alexnet():
    return [conv2d(227, 227, 3, 96, 11, 4), pool(55, 55, 96, 3, 2),
            conv2d(27, 27, 96, 256, 5), pool(27, 27, 256, 3, 2),
            conv2d(13, 13, 256, 384, 3), conv2d(13, 13, 384, 384, 3),
            conv2d(13, 13, 384, 256, 3), pool(13, 13, 256, 3, 2),
            fc(256 * 6 * 6, 4096), fc(4096, 4096), fc(4096, 1000)]


def _inception(ls, h, cin, b1, b3r, b3, b5r, b5, bp):
    ls += [conv2d(h, h, cin, b1, 1), conv2d(h, h, cin, b3r, 1),
           conv2d(h, h, b3r, b3, 3), conv2d(h, h, cin, b5r, 1),
           conv2d(h, h, b5r, b5, 3), conv2d(h, h, b5, b5, 3),
           pool(h, h, cin, 3, 1), conv2d(h, h, cin, bp, 1)]
    return b1 + b3 + b5 + bp


def inception_v3():
    ls = [conv2d(299, 299, 3, 32, 3, 2), conv2d(149, 149, 32, 32, 3),
          conv2d(147, 147, 32, 64, 3), pool(147, 147, 64, 3, 2),
          conv2d(73, 73, 64, 80, 1), conv2d(73, 73, 80, 192, 3),
          pool(71, 71, 192, 3, 2)]
    cin = 192
    for bp in (32, 64, 64):
        cin = _inception(ls, 35, cin, 64, 48, 64, 64, 96, bp)
    ls.append(conv2d(35, 35, cin, 384, 3, 2))
    cin = 384 + cin
    for c7 in (128, 160, 160, 192):
        ls += [conv2d(17, 17, cin, 192, 1), conv2d(17, 17, cin, c7, 1),
               conv2d(17, 17, c7, c7, 7), conv2d(17, 17, c7, 192, 7),
               pool(17, 17, cin, 3, 1), conv2d(17, 17, cin, 192, 1)]
        cin = 192 * 4
    ls.append(conv2d(17, 17, cin, 320, 3, 2))
    cin = 320 + cin
    for _ in range(2):
        ls += [conv2d(8, 8, cin, 320, 1), conv2d(8, 8, cin, 384, 1),
               conv2d(8, 8, 384, 384, 3), conv2d(8, 8, 384, 448, 3),
               pool(8, 8, cin, 3, 1), conv2d(8, 8, cin, 192, 1)]
        cin = 320 + 384 + 448 + 192
    return ls + [pool(8, 8, cin, 8, 8), fc(cin, 1000)]


def resnet50():
    ls = [conv2d(224, 224, 3, 64, 7, 2), pool(112, 112, 64, 3, 2)]
    h, cin = 56, 64
    for si, (mid, cout, blocks) in enumerate(
            [(64, 256, 3), (128, 512, 4), (256, 1024, 6), (512, 2048, 3)],
            start=2):
        for b in range(blocks):
            stride = 2 if (b == 0 and si > 2) else 1
            ls.append(conv2d(h, h, cin, mid, 1, stride))
            hh = h // stride if stride == 2 else h
            ls += [conv2d(hh, hh, mid, mid, 3), conv2d(hh, hh, mid, cout, 1)]
            if b == 0:
                ls.append(conv2d(h, h, cin, cout, 1, stride))
            h, cin = hh, cout
    return ls + [pool(7, 7, 2048, 7, 7), fc(2048, 1000)]


def yolo_v2():
    ls, h, cin = [], 416, 3
    plan = [(32, 3, True), (64, 3, True), (128, 3, False), (64, 1, False),
            (128, 3, True), (256, 3, False), (128, 1, False), (256, 3, True),
            (512, 3, False), (256, 1, False), (512, 3, False),
            (256, 1, False), (512, 3, True), (1024, 3, False),
            (512, 1, False), (1024, 3, False), (512, 1, False),
            (1024, 3, False)]
    for cout, k, p in plan:
        ls.append(conv2d(h, h, cin, cout, k))
        cin = cout
        if p:
            ls.append(pool(h, h, cout, 2, 2))
            h //= 2
    ls += [conv2d(h, h, 1024, 1024, 3) for _ in range(3)]
    return ls + [conv2d(h, h, 1024, 425, 1)]


CNN = {"squeezenet": squeezenet, "yolo_lite": yolo_lite,
       "keyword_spotting": keyword_spotting, "alexnet": alexnet,
       "inception_v3": inception_v3, "resnet50": resnet50,
       "yolo_v2": yolo_v2}


# ---- characterisation ---------------------------------------------------------
def layer_cost(sa: dict, layer: Layer, dram_gbps: float):
    """(latency us, bandwidth GB/s, energy uJ) of ``layer`` alone on
    ``sa``: roofline of compute and tiled-GEMM DRAM traffic."""
    pe, lanes = sa["num_pe"], sa["macs_per_pe"]
    peak = pe * lanes
    if layer.kind == "pool":
        traffic = float(layer.floor)
        comp = layer.m * layer.k / max(1, peak)
    else:
        kb = max(1, layer.k * layer.dtype_bytes)
        if sa["dataflow"] == "ws":
            tile = max(1, (pe * sa["pe_buf_bytes"]) // kb)
            traffic = float(layer.w_bytes + layer.in_bytes
                            * math.ceil(layer.n / tile) + layer.out_bytes)
        else:
            tile = max(1, sa["gbuf_bytes"] // kb)
            traffic = float(layer.in_bytes + layer.w_bytes
                            * math.ceil(layer.m / tile) + layer.out_bytes)
        util = max(1e-3, UTIL[(sa["dataflow"], layer.kind)]
                   * min(1.0, (layer.m * layer.n) / pe)
                   * min(1.0, layer.k / lanes))
        comp = layer.macs / (peak * util)
    cycles = max(comp, traffic / (dram_gbps / FREQ_GHZ), 1.0)
    energy_pj = (layer.macs * sa["e_mac_pj"] + traffic * E_DRAM_PJ_PER_BYTE
                 + layer.floor * 2.0 * E_GBUF_PJ_PER_BYTE
                 + (layer.in_bytes + layer.out_bytes) * E_NOP_PJ_PER_BYTE)
    return cycles / (FREQ_GHZ * 1e3), traffic / cycles, energy_pj * 1e-6


def tenant_layers(config: dict) -> list[tuple[str, list]]:
    """``[(tenant, layers), ...]`` in the configuration's order."""
    ten = config["tenants"]
    if ten["kind"] == "cnn":
        return [(name, CNN[name]()) for name in ten["models"]]
    raise ValueError(f"unknown tenant kind {ten['kind']!r}")


def tables(config: dict) -> dict:
    """Dense tables of the deployment: ``lat``/``bw``/``en`` (models,
    Lmax, M) float64 padded with zeros, ``n_layers``, ``min_lat`` (the
    contention-free chain latency, best SA per layer), ``names``."""
    fleet = config["fleet"]
    sas, dram = fleet["sas"], float(fleet["dram_gbps"])
    per = tenant_layers(config)
    n, M = len(per), len(sas)
    lmax = max(len(ls) for _, ls in per)
    lat = np.zeros((n, lmax, M))
    bw = np.zeros((n, lmax, M))
    en = np.zeros((n, lmax, M))
    nl = np.zeros((n,), np.int64)
    for i, (_, ls) in enumerate(per):
        for li, layer in enumerate(ls):
            for mi, sa in enumerate(sas):
                lat[i, li, mi], bw[i, li, mi], en[i, li, mi] = layer_cost(
                    sa, layer, dram)
        nl[i] = len(ls)
    min_lat = np.array([lat[i, :nl[i]].min(axis=1).sum() for i in range(n)])
    return dict(lat=lat, bw=bw, en=en, n_layers=nl, min_lat=min_lat,
                names=[name for name, _ in per], lmax=lmax, num_sas=M,
                dram_gbps=dram)
