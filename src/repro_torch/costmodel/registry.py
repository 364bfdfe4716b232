"""Model registration: DNN layer graph -> (latency, bandwidth, energy) tables.

This is the paper's "registration phase" (Sec. 3): every DNN model that may
be requested is characterized offline on every sub-accelerator, producing
the ``c[i, s, m]`` / ``b[i, s, m]`` tables the online scheduler consumes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.costmodel.accelerators import MASConfig, layer_cost
from repro_torch.costmodel.layers import LayerSpec


@dataclasses.dataclass(frozen=True)
class ModelTable:
    """Characterization of one DNN model on one MAS."""
    name: str
    layers: tuple[LayerSpec, ...]
    latency_us: np.ndarray     # (L, M) float64
    bw_gbps: np.ndarray        # (L, M)
    energy_uj: np.ndarray      # (L, M)
    deps: np.ndarray           # (L,) int32: predecessor layer idx or -1

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    @property
    def min_latency_us(self) -> float:
        """Contention-free lower bound: best SA per layer, chain-sequential.

        This is the PREMA-style "isolated execution latency" used to derive
        SLA targets: q_j = qos_factor * min_latency.
        """
        return float(self.latency_us.min(axis=1).sum())

    @property
    def min_energy_uj(self) -> float:
        return float(self.energy_uj.min(axis=1).sum())


def register_model(name: str, layers: list[LayerSpec], mas: MASConfig,
                   deps: list[int] | None = None) -> ModelTable:
    L, M = len(layers), mas.num_sas
    lat = np.zeros((L, M))
    bw = np.zeros((L, M))
    en = np.zeros((L, M))
    for li, layer in enumerate(layers):
        for mi, sa in enumerate(mas.sas):
            lat[li, mi], bw[li, mi], en[li, mi] = layer_cost(
                sa, layer, dram_gbps=mas.dram_gbps)
    if deps is None:
        deps = [-1] + list(range(L - 1))  # linear chain
    return ModelTable(name=name, layers=tuple(layers), latency_us=lat,
                      bw_gbps=bw, energy_uj=en,
                      deps=np.asarray(deps, dtype=np.int32))


class Registry:
    """All registered models of a deployment, with dense padded tables.

    Produces the fixed-shape arrays the environment indexes into:
      lat/bw/en: (num_models, Lmax, M) padded with zeros
      n_layers:  (num_models,)
      deps:      (num_models, Lmax)
      min_lat:   (num_models,)
    """

    def __init__(self, mas: MASConfig):
        self.mas = mas
        self.tables: dict[str, ModelTable] = {}
        self._order: list[str] = []

    def register(self, name: str, layers: list[LayerSpec],
                 deps: list[int] | None = None) -> ModelTable:
        tab = register_model(name, layers, self.mas, deps)
        self.tables[name] = tab
        self._order.append(name)
        return tab

    @property
    def model_names(self) -> list[str]:
        return list(self._order)

    def model_id(self, name: str) -> int:
        return self._order.index(name)

    def dense(self) -> dict[str, np.ndarray]:
        n = len(self._order)
        lmax = max(t.num_layers for t in self.tables.values())
        M = self.mas.num_sas
        lat = np.zeros((n, lmax, M), np.float64)
        bw = np.zeros((n, lmax, M), np.float64)
        en = np.zeros((n, lmax, M), np.float64)
        deps = np.full((n, lmax), -1, np.int32)
        nl = np.zeros((n,), np.int32)
        minlat = np.zeros((n,), np.float64)
        for i, name in enumerate(self._order):
            t = self.tables[name]
            L = t.num_layers
            lat[i, :L] = t.latency_us
            bw[i, :L] = t.bw_gbps
            en[i, :L] = t.energy_uj
            deps[i, :L] = t.deps
            nl[i] = L
            minlat[i] = t.min_latency_us
        return dict(lat=lat, bw=bw, en=en, deps=deps, n_layers=nl,
                    min_lat=minlat, lmax=lmax, num_models=n, num_sas=M)
