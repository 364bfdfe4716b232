"""The port's serving path against the JAX package's
``MultiTenantService`` on the same request streams.

Both packages draw the requests with the same NumPy loadgen code and
seed (checked first).  Expected: equal hits, counted, arrived, per-tenant
tables and completion ``rid``/``hit``/``missed`` per stream; energy and
``finish_us`` to rtol 1e-5 (float32 sums in another order).  The actor
carries the JAX service's weights.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import save_checkpoint
from repro.core import policy as P
from repro.serving import MultiTenantService as JService
from repro.serving import request_streams as jax_request_streams
from repro.sim.env import EnvConfig as JEnvConfig
from repro.workloads import build_registry as jax_build_registry
from repro_torch.launch import serve as serve_cli
from repro_torch.serving import (LoadGenConfig, MultiTenantService, Request,
                                 pack_admissions, queue_admit, queue_init,
                                 queue_retire, request_streams,
                                 trace_to_requests)
from repro_torch.sim.engine import INF
from repro_torch.sim.env import EnvConfig, SchedulingEnv
from repro_torch.workloads import build_registry

torch.set_num_threads(1)
KW = dict(periods=10, max_rq=32, max_jobs=12)
HIDDEN = 32
LG = LoadGenConfig(scenario="default", rate_scale=1.5, n_requests=14)
INT_KEYS = ("hits", "counted", "arrived", "sla_rate")


def _services(policy, ckpt_dir=None):
    jsvc = JService(jax_build_registry("light"), policy=policy,
                    env_cfg=JEnvConfig(**KW), hidden=HIDDEN,
                    ckpt_dir=ckpt_dir)
    svc = MultiTenantService(build_registry("light"), policy=policy,
                             env_cfg=EnvConfig(**KW), hidden=HIDDEN,
                             ckpt_dir=ckpt_dir, device="cpu")
    if policy == "relmas" and ckpt_dir is None:
        svc.actor.load_numpy(jax.tree.map(np.asarray, jsvc.params))
    return jsvc, svc


def _assert_metrics(m, jm):
    for k in INT_KEYS:
        assert m[k] == jm[k], k
    assert m["per_tenant"] == jm["per_tenant"]
    np.testing.assert_allclose(m["energy_uj"], jm["energy_uj"], rtol=1e-5)


@pytest.mark.parametrize("policy", ["relmas", "fcfs", "prema", "herald"])
def test_serve_stream_matches_jax(policy):
    jsvc, svc = _services(policy)
    jreqs = jax_request_streams(jsvc.env, LG, 3, seed=4)
    reqs = request_streams(svc.env, LG, 3, seed=4)
    assert [[vars(r) for r in st] for st in reqs] == \
        [[vars(r) for r in st] for st in jreqs]
    jout = jsvc.serve_stream(jreqs, tick_k=8, seed=4)
    out = svc.serve_stream(reqs, tick_k=8)
    assert out["aggregate"]["counted"] > 0
    for m, jm in zip(out["metrics"], jout["metrics"]):
        _assert_metrics(m, jm)
    for comp, jcomp in zip(out["completions"], jout["completions"]):
        assert [(c["rid"], c["hit"], c["missed"]) for c in comp] == \
            [(c["rid"], c["hit"], c["missed"]) for c in jcomp]
        np.testing.assert_allclose([c["finish_us"] for c in comp],
                                   [c["finish_us"] for c in jcomp],
                                   rtol=1e-5)
    for k in ("admitted", "deferred", "unserved"):
        assert out["stats"][k] == jout["stats"][k], k


@pytest.mark.parametrize("policy", ["relmas", "fcfs"])
def test_serve_trace_host_matches_jax_and_serve_stream(policy):
    jsvc, svc = _services(policy)
    trace, _ = jsvc.env.new_episode(np.random.default_rng(2))
    jm = jsvc.serve_trace_host(trace, seed=2)
    m = svc.serve_trace_host(trace)
    _assert_metrics(m, jm)
    # inside the port, the batched tick on the replayed trace gives the
    # reference's numbers bit for bit
    reqs = trace_to_requests(svc.env, jax.tree.map(np.asarray, trace))
    out = svc.serve_stream(reqs, tick_k=KW["max_jobs"])
    assert out["metrics"][0] == m


def test_jax_checkpoint_restores_and_serves(tmp_path):
    pcfg = P.PolicyConfig(feat_dim=16, act_dim=7, hidden=HIDDEN)
    params = P.init_actor(jax.random.PRNGKey(42), pcfg)
    save_checkpoint(str(tmp_path), 5, params, meta={"fleet": "paper6"})
    jsvc, svc = _services("relmas", ckpt_dir=str(tmp_path))
    for name, mod in (("lstm", svc.actor.lstm), ("fc1", svc.actor.fc1),
                      ("fc2", svc.actor.fc2)):
        for k, v in mod.items():
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(params[name][k]))
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 9, 16)).astype(np.float32)
    mask = np.arange(9)[None, :] < np.array([[9], [4]])
    want = jax.vmap(P.actor_apply, in_axes=(None, None, 0, 0))(
        params, pcfg, feats, mask)
    with torch.no_grad():
        got = svc.actor(torch.as_tensor(feats), torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    jreqs = jax_request_streams(jsvc.env, LG, 2, seed=8)
    jout = jsvc.serve_stream(jreqs, tick_k=8, seed=8)
    out = svc.serve_stream(request_streams(svc.env, LG, 2, seed=8), tick_k=8)
    for m, jm in zip(out["metrics"], jout["metrics"]):
        _assert_metrics(m, jm)


def test_checkpoint_of_another_fleet_is_refused(tmp_path, capsys):
    pcfg = P.PolicyConfig(feat_dim=16, act_dim=7, hidden=HIDDEN)
    params = P.init_actor(jax.random.PRNGKey(42), pcfg)
    save_checkpoint(str(tmp_path), 1, params, meta={"fleet": "big_little"})
    svc = MultiTenantService(build_registry("light", mas="paper6"),
                             hidden=HIDDEN, env_cfg=EnvConfig(**KW),
                             ckpt_dir=str(tmp_path), device="cpu")
    assert "trained on fleet 'big_little'" in capsys.readouterr().out
    assert not np.array_equal(svc.actor.lstm["wx"].numpy(),
                              np.asarray(params["lstm"]["wx"]))
    # a generalist checkpoint is not fleet-locked: it serves any fleet
    # whose num_sas fits its m_max, on a padded env
    gcfg = P.PolicyConfig(feat_dim=4 + 2 * 8 + 8 * 8, act_dim=9,
                          hidden=HIDDEN)
    gparams = P.init_actor(jax.random.PRNGKey(43), gcfg)
    save_checkpoint(str(tmp_path), 2, gparams,
                    meta={"policy_kind": "generalist", "m_max": 8,
                          "hidden": HIDDEN, "fleet": "big_little"})
    svc = MultiTenantService(build_registry("light"), hidden=HIDDEN,
                             env_cfg=EnvConfig(**KW), ckpt_dir=str(tmp_path),
                             device="cpu")
    assert svc.policy_kind == "generalist" and svc.env.num_sas == 8
    np.testing.assert_array_equal(svc.actor.lstm["wx"].numpy(),
                                  np.asarray(gparams["lstm"]["wx"]))


@pytest.mark.parametrize("batched", [True, False])
def test_cli_prints_json_summary(capsys, batched):
    argv = ["--workload", "light", "--policy", "fcfs", "--device", "cpu",
            "--periods", "6", "--max-rq", "24", "--max-jobs", "8",
            "--episodes", "1", "--streams", "2", "--requests", "6"]
    out = serve_cli.main(argv + (["--batched"] if batched else []))
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == out
    assert out["device"] == "cpu"
    # the LM tenants are served too (datacenter fleet, 2000 us period)
    lm = serve_cli.main(["--workload", "lm_light"] + argv[2:]
                        + (["--batched"] if batched else []))
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == lm
    assert lm["workload"] == "lm_light" and lm["device"] == "cpu"


def _tiny_env(max_jobs=4):
    return SchedulingEnv(build_registry("light"),
                         EnvConfig(periods=4, max_rq=16, max_jobs=max_jobs),
                         device="cpu")


def _adm(rows_per_stream, k):
    packed = [pack_admissions(rows, k) for rows in rows_per_stream]
    return {key: torch.as_tensor(np.stack([p[key] for p in packed]))
            for key in packed[0]}


def test_queue_admit_rejects_overflow_rows():
    env = _tiny_env(max_jobs=4)
    qs = queue_init(env, 2)
    rows = [(i, 0, 0.0, 1000.0, 1000.0) for i in range(6)]
    n_adm = queue_admit(env, qs, _adm([rows, rows[:2]], 6))
    assert n_adm.tolist() == [4, 2]
    assert qs["occupied"].sum(1).tolist() == [4, 2]
    assert qs["acc"]["admitted"].tolist() == [4, 2]
    assert qs["acc"]["rejected"].tolist() == [2, 0]
    # the admitted rows landed in arrival order at the lowest slots
    assert qs["rid"].tolist() == [[0, 1, 2, 3], [0, 1, -1, -1]]
    # a second admission fills stream 1's free slots only
    n_adm = queue_admit(env, qs, _adm([rows[4:5], rows[4:6]], 2))
    assert n_adm.tolist() == [0, 2]
    assert qs["rid"][1].tolist() == [0, 1, 4, 5]
    with pytest.raises(ValueError, match="> tick_k"):
        pack_admissions(rows[:3], 2)


def test_queue_retire_frees_slots_and_accumulates():
    env = _tiny_env(max_jobs=4)
    qs = queue_init(env, 1)
    queue_admit(env, qs, _adm([[(i, 0, 0.0, 1000.0, 1000.0)
                                for i in range(4)]], 4))
    qs["state"]["done"] = torch.tensor([[True, False, True, False]])
    qs["state"]["hit"] = torch.tensor([[True, False, False, False]])
    out = queue_retire(env, qs)
    assert out["completed"].tolist() == [[True, False, True, False]]
    assert qs["occupied"].tolist() == [[False, True, False, True]]
    assert out["depth"].tolist() == [2]
    # freed slots become invisible to build_slots/mark_drops
    assert bool((qs["trace"]["arrival"][0, [0, 2]] >= INF / 2).all())
    assert qs["acc"]["counted"].tolist() == [2]
    assert qs["acc"]["hits"].tolist() == [1]
    assert qs["acc"]["ten_counted"][0, 0].item() == 2


def test_serve_stream_defers_then_serves_oversubscribed_burst():
    svc = MultiTenantService(build_registry("light"), policy="fcfs",
                             env_cfg=EnvConfig(periods=20, max_rq=24,
                                               max_jobs=8), device="cpu")
    name = svc.env.registry.model_names[0]
    reqs = [Request(rid=i, tenant=name, arrival_us=0.0, deadline_us=2000.0)
            for i in range(16)]
    out = svc.serve_stream(reqs, tick_k=8)
    assert out["stats"]["deferred"] > 0
    assert out["stats"]["unserved"] == 0
    assert out["aggregate"]["arrived"] == 16
    assert out["aggregate"]["counted"] == 16
    with pytest.raises(ValueError, match="unknown model id"):
        svc.serve_stream([Request(rid=0, tenant="not_served",
                                  arrival_us=0.0, deadline_us=100.0)])
