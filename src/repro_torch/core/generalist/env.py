"""Padded environments: any fleet presented at a fixed width ``M_max``.

:class:`PaddedEnv` is a :class:`~repro_torch.sim.env.SchedulingEnv`
whose characterization tables are padded along the SA axis to ``M_max``
columns, so envs built on fleets of different ``num_sas`` share one set
of shapes (features ``4 + 2 M_max``, actions ``1 + M_max``).  Padding
SAs are *poisoned*, not free: their latency column is
:data:`PAD_LAT_US` (work routed to a phantom SA is an unmissable SLA
miss, never silent free compute), and the masked allocation of
``repro_torch.core.generalist.features`` never selects them.  SLA
budgets come from the real registry, so deadlines are the plain env's.

:func:`stack_fleet_tables` stacks the padded tables of several fleets
into ``(K, ...)`` tensors; a training round on fleet ``f`` runs the
``f``-th env itself (the JAX package rebinds a template env's tables by
a traced index; here nothing is compiled, so the env is picked on the
host) and the update gathers each sample's descriptors from the stack.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.costmodel.descriptors import fleet_descriptors
from repro_torch.sim.arrivals import ArrivalConfig
from repro_torch.sim.env import EnvConfig, SchedulingEnv
from repro_torch.workloads import build_registry

# latency of a padding SA: large enough that any accidental selection
# is an unmissable SLA miss, small enough to stay finite through the
# engine's float32 arithmetic (INF / 2 guards sit at ~5e29)
PAD_LAT_US = 1.0e7


class PaddedEnv(SchedulingEnv):
    """SchedulingEnv at width ``m_max`` with SA-axis-padded tables.

    ``true_num_sas`` keeps the fleet's real width; ``sa_mask`` (M_max,)
    bool and ``descriptors`` (M_max, DESC_DIM) float32 tensors on the
    env's device are what the generalist policy conditions on.  At
    ``m_max == num_sas`` this IS the plain env (no padding, the same
    tables) plus those two attributes.
    """

    def __init__(self, registry, cfg: EnvConfig, m_max: int | None = None,
                 arrivals: ArrivalConfig | None = None, *,
                 device: str | torch.device = "cuda"):
        super().__init__(registry, cfg, arrivals, device=device)
        m_max = self.num_sas if m_max is None else m_max
        if m_max < self.num_sas:
            raise ValueError(f"m_max {m_max} < fleet num_sas "
                             f"{self.num_sas}")
        self.true_num_sas = self.num_sas
        pad = m_max - self.num_sas
        if pad:
            self.lat = F.pad(self.lat, (0, pad), value=PAD_LAT_US)
            self.bw = F.pad(self.bw, (0, pad))
            self.en = F.pad(self.en, (0, pad))
            self.num_sas = m_max
            self.feat_dim = 4 + 2 * m_max
            self.act_dim = 1 + m_max
        self.sa_mask = torch.arange(m_max, device=self.device) \
            < self.true_num_sas
        self.descriptors = torch.as_tensor(
            fleet_descriptors(registry.mas, m_max), device=self.device)


def build_padded_envs(workload: str, fleets, cfg: EnvConfig,
                      arrivals: ArrivalConfig | None = None,
                      m_max: int | None = None, *,
                      device: str | torch.device = "cuda"
                      ) -> list[PaddedEnv]:
    """One :class:`PaddedEnv` per fleet preset, all at a common width
    (``m_max``, default the widest requested fleet; pass a checkpoint's
    ``m_max`` to restore a generalist onto narrower fleets).  All envs
    characterize the same ``workload``, so every shape agrees."""
    regs = [build_registry(workload, mas=f) for f in fleets]
    m_max = m_max or max(r.mas.num_sas for r in regs)
    return [PaddedEnv(r, cfg, m_max, arrivals, device=device) for r in regs]


def stack_fleet_tables(envs: list[PaddedEnv]) -> dict[str, torch.Tensor]:
    """Per-fleet padded tables stacked into ``(K, ...)`` tensors on the
    first env's device: characterization tables, per-model min latency,
    the fleet's shared DRAM bandwidth, and the descriptor / validity
    tensors the policy conditions on."""
    if len({(e.num_sas, tuple(e.lat.shape)) for e in envs}) != 1:
        raise ValueError("fleet envs must share m_max and table shapes")
    dev = envs[0].device
    stk = lambda xs: torch.stack([torch.as_tensor(x, dtype=torch.float32,
                                                  device=dev) for x in xs])
    return dict(
        lat=stk([e.lat for e in envs]),
        bw=stk([e.bw for e in envs]),
        en=stk([e.en for e in envs]),
        min_lat=stk([e.min_lat for e in envs]),
        bandwidth=torch.tensor([e.cfg.bandwidth_gbps for e in envs],
                               dtype=torch.float32, device=dev),
        desc=stk([e.descriptors for e in envs]),
        sa_mask=torch.stack([e.sa_mask for e in envs]),
    )
