"""The PyTorch port's cost-model tables against the JAX package's.

Both packages build the tables in NumPy float64 from the same layer
graphs, so the dense arrays must be bit-equal for every fleet preset
and workload.
"""
import numpy as np
import pytest
import torch

from repro.costmodel import fleet_names as jax_fleet_names
from repro.workloads import build_registry as jax_build_registry
from repro_torch.costmodel import fleet_names
from repro_torch.workloads import build_registry

torch.set_num_threads(1)


def test_fleet_presets_match():
    assert fleet_names() == jax_fleet_names()


@pytest.mark.parametrize("workload", ["light", "heavy", "mixed"])
@pytest.mark.parametrize("fleet", jax_fleet_names())
def test_registry_dense_bit_equal(fleet, workload):
    got = build_registry(workload, mas=fleet)
    want = jax_build_registry(workload, mas=fleet)
    assert got.model_names == want.model_names
    d_got, d_want = got.dense(), want.dense()
    assert d_got.keys() == d_want.keys()
    for k, v in d_want.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == d_got[k].dtype, k
            np.testing.assert_array_equal(d_got[k], v, err_msg=k)
        else:
            assert d_got[k] == v, k
