"""Named accelerator-fleet presets: the MAS as a first-class sweep axis.

The paper's headline claim (up to 173% SLA improvement) is made *across*
heterogeneous multi-accelerator platforms built from different mixes of
Simba- and Eyeriss-class sub-accelerators.  A :class:`FleetConfig` is a
:class:`~repro.costmodel.accelerators.MASConfig` with a name, registered
in :data:`FLEETS`, so the platform becomes a preset every consumer can
select by string:

- ``Registry``/``build_registry(workload, mas=fleet)`` re-characterize
  the ``c[i,s,m]`` / ``b[i,s,m]`` tables per fleet (registration phase);
- ``SchedulingEnv`` derives ``num_sas``, the policy feature/action dims
  (``F = 4 + 2M``, ``G = 1 + M``) and — when ``EnvConfig.bandwidth_gbps``
  is left at 0 — the shared DRAM bandwidth from the fleet;
- ``benchmarks/sweep.py --fleets`` crosses fleets with scenarios x
  policies x bandwidths; ``launch/rl_train.py --fleet`` trains a
  per-fleet agent; ``benchmarks/rollout_throughput.py`` reports
  periods/sec at small vs. large fleets (``fleet_scaling``).

Preset naming: ``<n><class>[_<n><class>]`` counts sub-accelerators per
class (each class contributes a large/small or big/little mix of the
Table 1 instances); ``paper6`` is the Fig. 1 six-chiplet baseline every
committed benchmark and checkpoint was produced on.
"""
from __future__ import annotations

import dataclasses

from repro_torch.costmodel.accelerators import (DATACENTER_MAS, DEFAULT_MAS,
                                          EYERISS_LARGE, EYERISS_SMALL,
                                          MASConfig, SAClass, SIMBA_LARGE,
                                          SIMBA_SMALL)


@dataclasses.dataclass(frozen=True)
class FleetConfig(MASConfig):
    """A named MAS preset (hashable: usable as a cache / jit-static key)."""
    name: str = "custom"

    def describe(self) -> str:
        """One-line fleet summary for logs and benchmark records."""
        counts: dict[str, int] = {}
        for sa in self.sas:
            counts[sa.name] = counts.get(sa.name, 0) + 1
        mix = "+".join(f"{n}x{cls}" for cls, n in counts.items())
        return f"{self.name}: {self.num_sas} SAs ({mix}) @ {self.dram_gbps:g} GB/s"


# big/LITTLE variants: same dataflows, scaled PE arrays and buffers
# (a big core trades area for throughput; a little core keeps the small
# layers' fill-utilization from collapsing on the big array).
EYERISS_BIG = dataclasses.replace(EYERISS_LARGE, name="eyeriss_big",
                                  num_pe=1024, gbuf_bytes=128 * 1024)
EYERISS_LITTLE = dataclasses.replace(EYERISS_SMALL, name="eyeriss_little",
                                     num_pe=128, gbuf_bytes=32 * 1024)
SIMBA_BIG = dataclasses.replace(SIMBA_LARGE, name="simba_big",
                                num_pe=64, gbuf_bytes=128 * 1024)
SIMBA_LITTLE = dataclasses.replace(SIMBA_SMALL, name="simba_little",
                                   num_pe=8, gbuf_bytes=16 * 1024)


def _fleet(name: str, sas: tuple[SAClass, ...],
           dram_gbps: float = DEFAULT_MAS.dram_gbps) -> FleetConfig:
    return FleetConfig(name=name, sas=sas, dram_gbps=dram_gbps)


FLEETS: dict[str, FleetConfig] = {f.name: f for f in (
    # Fig. 1 baseline: the fleet every committed benchmark/checkpoint
    # was produced on (3 Eyeriss-class + 3 Simba-class chiplets).
    _fleet("paper6", DEFAULT_MAS.sas),
    # 8-SA balanced mix (large+small pair per class and size).
    _fleet("4simba_4eyeriss", (EYERISS_LARGE, EYERISS_LARGE,
                               EYERISS_SMALL, EYERISS_SMALL,
                               SIMBA_LARGE, SIMBA_LARGE,
                               SIMBA_SMALL, SIMBA_SMALL)),
    # homogeneous-dataflow fleets: the cross-platform extremes — ws
    # favours FC/GEMM-heavy tenants, rs favours convs.
    _fleet("8simba", (SIMBA_LARGE,) * 4 + (SIMBA_SMALL,) * 4),
    _fleet("8eyeriss", (EYERISS_LARGE,) * 4 + (EYERISS_SMALL,) * 4),
    # skewed mix: mostly-rs platform with a small ws sidecar.
    _fleet("2simba_6eyeriss", (EYERISS_LARGE, EYERISS_LARGE, EYERISS_LARGE,
                               EYERISS_SMALL, EYERISS_SMALL, EYERISS_SMALL,
                               SIMBA_LARGE, SIMBA_SMALL)),
    # minimal heterogeneous fleet (throughput-scaling small arm).
    _fleet("2simba_2eyeriss", (EYERISS_LARGE, EYERISS_SMALL,
                               SIMBA_LARGE, SIMBA_SMALL)),
    # big/LITTLE: one scaled-up + two scaled-down cores per dataflow.
    _fleet("big_little", (EYERISS_BIG, EYERISS_LITTLE, EYERISS_LITTLE,
                          SIMBA_BIG, SIMBA_LITTLE, SIMBA_LITTLE)),
    # HBM-class 4-SA scale-up for the LM serving scenarios.
    _fleet("datacenter", DATACENTER_MAS.sas, DATACENTER_MAS.dram_gbps),
)}

DEFAULT_FLEET = FLEETS["paper6"]


def fleet_names() -> list[str]:
    return list(FLEETS)


def get_fleet(fleet: str | MASConfig) -> MASConfig:
    """Resolve a preset name to its FleetConfig (MASConfig passes through)."""
    if isinstance(fleet, MASConfig):
        return fleet
    try:
        return FLEETS[fleet]
    except KeyError:
        raise ValueError(f"unknown fleet {fleet!r}; available: "
                         f"{', '.join(FLEETS)}") from None
