"""The port's LM control plane against the JAX package's: the
``llm_zoo`` layer tables of the ten LM architectures, and the serving
driver on LM tenants.

Both packages build the tables in NumPy float64 from the same configs,
so the dense arrays must be bit-equal for every ``lm_*`` workload and
both phases.  The batched service on ``lm_light`` must give the same
hits and counted per stream as the JAX service (the serving parity of
``tests/test_torch_serving.py``, on LM tenants).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.serving import MultiTenantService as JService
from repro.serving import request_streams as jax_request_streams
from repro.sim.arrivals import ArrivalConfig as JArrivalConfig
from repro.sim.env import EnvConfig as JEnvConfig
from repro.workloads import LM_WORKLOADS as JLM_WORKLOADS
from repro.workloads import build_llm_registry as jax_build_llm_registry
from repro.workloads import llm_layer_specs as jax_llm_layer_specs
from repro.configs.registry import ARCHS as JARCHS
from repro_torch.configs import ARCHS
from repro_torch.launch import serve as serve_cli
from repro_torch.serving import LoadGenConfig, request_streams
from repro_torch.workloads import (LM_WORKLOADS, build_llm_registry,
                                   llm_layer_specs)

torch.set_num_threads(1)


def test_workload_sets_match():
    assert LM_WORKLOADS == JLM_WORKLOADS


@pytest.mark.parametrize("phase", ["decode", "prefill"])
@pytest.mark.parametrize("workload", list(JLM_WORKLOADS))
def test_llm_registry_dense_bit_equal(workload, phase):
    got = build_llm_registry(workload, phase=phase)
    want = jax_build_llm_registry(workload, phase=phase)
    assert got.model_names == want.model_names
    d_got, d_want = got.dense(), want.dense()
    assert d_got.keys() == d_want.keys()
    for k, v in d_want.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == d_got[k].dtype, k
            np.testing.assert_array_equal(d_got[k], v, err_msg=k)
        else:
            assert d_got[k] == v, k


@pytest.mark.parametrize("name", list(JARCHS))
def test_llm_layer_specs_match(name):
    for kw in (dict(phase="decode", ctx=4096), dict(phase="prefill",
                                                    seq=512)):
        got = llm_layer_specs(ARCHS[name], **kw)
        want = jax_llm_layer_specs(JARCHS[name], **kw)
        assert [dataclasses.asdict(s) for s in got] == \
            [dataclasses.asdict(s) for s in want]


@pytest.mark.parametrize("phase", ["decode", "prefill"])
def test_lm_light_batched_matches_jax(phase):
    """``serve --workload lm_light --batched`` on the CPU against the JAX
    service built the way the JAX driver builds it (datacenter fleet,
    t_s = 2000 us)."""
    argv = ["--workload", "lm_light", "--policy", "fcfs", "--batched",
            "--streams", "2", "--requests", "10", "--periods", "24",
            "--max-rq", "24", "--max-jobs", "8", "--phase", phase,
            "--seq", "64", "--device", "cpu"]
    args = serve_cli.parse_args(argv)
    svc = serve_cli.build_service(args)
    assert svc.env.cfg.t_s_us == 2000.0
    reg = jax_build_llm_registry("lm_light", phase=phase, seq=64,
                                 mas="datacenter")
    ecfg = JEnvConfig(t_s_us=2000.0, periods=24, max_rq=24, max_jobs=8)
    arr = JArrivalConfig(max_jobs=8, load=args.load,
                         qos_factor=args.qos_factor, qos_level=args.qos,
                         horizon_us=ecfg.horizon_us,
                         slack_us=2 * ecfg.t_s_us)
    jsvc = JService(reg, policy="fcfs", env_cfg=ecfg, arrivals=arr)
    lg = LoadGenConfig(scenario=args.scenario, rate_scale=args.rate_scale,
                       n_requests=args.requests, qos_factor=args.qos_factor,
                       qos_level=args.qos)
    reqs = request_streams(svc.env, lg, 2, seed=9000)
    jreqs = jax_request_streams(jsvc.env, lg, 2, seed=9000)
    assert [[vars(r) for r in st] for st in reqs] == \
        [[vars(r) for r in st] for st in jreqs]
    out = svc.serve_stream(reqs, tick_k=args.tick_k)
    jout = jsvc.serve_stream(jreqs, tick_k=args.tick_k, seed=9000)
    assert out["aggregate"]["counted"] > 0
    for m, jm in zip(out["metrics"], jout["metrics"]):
        for k in ("hits", "counted", "arrived"):
            assert m[k] == jm[k], k
    summary, _ = serve_cli.serve_batched(svc, args)
    assert summary["counted"] == jout["aggregate"]["counted"]
