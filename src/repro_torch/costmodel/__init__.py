"""Analytical cost model: the registration-phase tables of the scheduler.

NumPy copies of ``layers``, ``accelerators``, ``fleets``, ``registry``
and ``descriptors`` (the per-SA hardware descriptors of the generalist
policy; their churn variant is torch).  Host code keeps these tables as
NumPy arrays; the environment moves its own float32 copies to the
device.
"""
from repro_torch.costmodel.accelerators import (
    SAClass, EYERISS_SMALL, EYERISS_LARGE, SIMBA_SMALL, SIMBA_LARGE,
    DEFAULT_MAS, MASConfig, layer_cost,
)
from repro_torch.costmodel.descriptors import (
    DESC_DIM, DESC_FIELDS, fleet_descriptors, sa_descriptor,
)
from repro_torch.costmodel.fleets import (
    FLEETS, DEFAULT_FLEET, FleetConfig, fleet_names, get_fleet,
)
from repro_torch.costmodel.layers import (LayerSpec, conv2d, dwconv2d, fc,
                                          pool, gemm, elementwise)
from repro_torch.costmodel.registry import ModelTable, register_model, Registry

__all__ = [
    "SAClass", "EYERISS_SMALL", "EYERISS_LARGE", "SIMBA_SMALL", "SIMBA_LARGE",
    "DEFAULT_MAS", "MASConfig", "layer_cost",
    "DESC_DIM", "DESC_FIELDS", "fleet_descriptors", "sa_descriptor",
    "FLEETS", "DEFAULT_FLEET", "FleetConfig", "fleet_names", "get_fleet",
    "LayerSpec", "conv2d", "dwconv2d", "fc", "pool", "gemm", "elementwise",
    "ModelTable", "register_model", "Registry",
]
