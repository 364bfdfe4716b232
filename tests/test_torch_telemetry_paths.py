"""Telemetry on the port's serving and training paths, against telemetry
off and against the JAX package.

- ``serve_stream`` with a telemetry session against none, on the same
  streams: metrics, aggregate, completions and the count statistics
  equal, the same number of tick and flush calls (bit-neutral; the
  telemetry ops add none).
- The device block (``stats["device_tele"]``) and the count fields of
  the ``serve_window``, ``tenant`` and ``serve_summary`` records equal
  the JAX package's ``serve_stream`` on the same streams (relmas, fcfs,
  herald): admitted, deferred, completed, ``mean_depth``, the tick
  range, the per-tenant rows; the host-clock quantiles are left out.
- A round and a generalist round with telemetry on against off on the
  JAX round's draws (``tests/test_torch_train.py``'s and
  ``tests/test_torch_generalist.py``'s harnesses): every metric, the
  learner state and the replay ring equal; the ``tele_*`` leaves equal
  the JAX round's (``replay_fill`` bit-equal as float32).
- Both drivers on ``--device cpu`` with ``--log-jsonl`` and
  ``--profile-dir``: their streams pass the reference's
  ``scripts/metrics_summary.py --require ...`` (run as a subprocess
  under the CPU JAX), and the trace holds the scope names.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_generalist as TG
import test_torch_train as TT
from repro.core import ddpg as JD
from repro.core import replay as JR
from repro.core.train import make_train_round
from repro.serving import MultiTenantService as JService
from repro.serving import request_streams as jax_request_streams
from repro.sim.env import EnvConfig as JEnvConfig
from repro.telemetry import ListSink as JListSink
from repro.telemetry import Telemetry as JTelemetry
from repro.workloads import build_registry as jax_build_registry
from repro_torch.core import ddpg as D
from repro_torch.core import generalist as G
from repro_torch.core import serve as core_serve
from repro_torch.core import train as TR
from repro_torch.core.replay import replay_init
from repro_torch.launch import rl_train
from repro_torch.launch import serve as serve_cli
from repro_torch.serving import LoadGenConfig, MultiTenantService
from repro_torch.serving import request_streams
from repro_torch.sim import churn as C
from repro_torch.sim.env import EnvConfig
from repro_torch.telemetry import ListSink, Telemetry
from repro_torch.telemetry.metrics import (ROUND_TELE_COUNTS,
                                           ROUND_TELE_KEYS)
from repro_torch.workloads import build_registry
from test_torch_generalist import fleets, params  # noqa: F401 (fixtures)
from test_torch_train import envs  # noqa: F401 (fixture)

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
KW = dict(periods=10, max_rq=32, max_jobs=12)
HIDDEN = 32
LG = LoadGenConfig(scenario="default", rate_scale=1.5, n_requests=14)
HOST_CLOCK = ("tick_p50_us", "tick_p99_us")
SERVE_SCOPES = {"serving.admit", "serving.period", "serving.retire",
                "serving.telemetry"}
ROUND_SCOPES = {"relmas.trace_gen", "relmas.rollout", "relmas.ring_write",
                "relmas.ddpg_update", "relmas.telemetry"}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _count_calls(monkeypatch) -> dict:
    """Count the tick and flush calls of every ``serve_stream``."""
    calls = {"tick": 0, "flush": 0}

    def counting(make, name):
        def wrapped(*a, **k):
            fn = make(*a, **k)

            def call(*x):
                calls[name] += 1
                return fn(*x)
            return call
        return wrapped
    monkeypatch.setattr(core_serve, "make_serving_tick",
                        counting(core_serve.make_serving_tick, "tick"))
    monkeypatch.setattr(core_serve, "make_serving_flush",
                        counting(core_serve.make_serving_flush, "flush"))
    return calls


@pytest.mark.parametrize("policy", ["relmas", "fcfs"])
def test_serve_stream_telemetry_is_bit_neutral(policy, monkeypatch):
    svc = MultiTenantService(build_registry("light"), policy=policy,
                             env_cfg=EnvConfig(**KW), hidden=HIDDEN,
                             device="cpu")
    reqs = request_streams(svc.env, LG, 3, seed=4)
    calls = _count_calls(monkeypatch)
    off = svc.serve_stream(reqs, tick_k=8)
    n_off = dict(calls)
    calls.update(tick=0, flush=0)
    sink = ListSink()
    on = svc.serve_stream(reqs, tick_k=8, telemetry=Telemetry([sink]),
                          window=4)
    assert calls == n_off == {"tick": KW["periods"], "flush": 1}
    assert on["aggregate"]["counted"] > 0
    for k in ("metrics", "aggregate", "completions"):
        assert on[k] == off[k], k
    for k, v in off["stats"].items():
        if k != "tick_wall_us":
            assert on["stats"][k] == v, k
    assert "device_tele" not in off["stats"]
    tele = on["stats"]["device_tele"]
    assert tele["ticks"] == KW["periods"]
    assert sum(tele["depth_hist"]) == KW["periods"] * 3
    kinds = [r["kind"] for r in sink.records]
    assert kinds == ["serve_window"] * 3 + ["tenant"] * len(
        svc.env.registry.model_names) + ["serve_summary"]
    assert [(r["tick_first"], r["tick_last"]) for r in sink.records[:3]] \
        == [(0, 3), (4, 7), (8, 9)]
    assert sum(r["admitted"] for r in sink.records[:3]) \
        == on["stats"]["admitted"]
    assert sum(r["completed"] for r in sink.records[:3]) \
        <= on["aggregate"]["completed"]


@pytest.mark.parametrize("policy", ["relmas", "fcfs", "herald"])
def test_serving_telemetry_counts_match_jax(policy):
    jsvc = JService(jax_build_registry("light"), policy=policy,
                    env_cfg=JEnvConfig(**KW), hidden=HIDDEN)
    svc = MultiTenantService(build_registry("light"), policy=policy,
                             env_cfg=EnvConfig(**KW), hidden=HIDDEN,
                             device="cpu")
    if policy == "relmas":
        svc.actor.load_numpy(jax.tree.map(np.asarray, jsvc.params))
    jsink, sink = JListSink(), ListSink()
    jout = jsvc.serve_stream(jax_request_streams(jsvc.env, LG, 3, seed=4),
                             tick_k=8, seed=4,
                             telemetry=JTelemetry([jsink]), window=4)
    out = svc.serve_stream(request_streams(svc.env, LG, 3, seed=4),
                           tick_k=8, telemetry=Telemetry([sink]), window=4)
    assert out["aggregate"]["counted"] > 0
    assert out["stats"]["device_tele"] == jout["stats"]["device_tele"]

    def counts(recs):
        return [{k: v for k, v in r.items() if k not in HOST_CLOCK}
                for r in recs]
    assert counts(sink.records) == counts(jsink.records)


# ---------------------------------------------------------------------------
# training rounds
# ---------------------------------------------------------------------------
def _assert_equal_rounds(a, b):
    """Two rounds' (state, buf, sigma, metrics): every tensor equal."""
    (sa, ba, siga, ma), (sb, bb, sigb, mb) = a, b
    assert siga == sigb
    assert ma == {k: mb[k] for k in ma}
    for f in dataclasses.fields(sa):
        if f.name == "step":
            assert sa.step == sb.step
            continue
        for x, y in zip(D.tree_leaves(getattr(sa, f.name)),
                        D.tree_leaves(getattr(sb, f.name))):
            assert torch.equal(x, y), f.name
    for k, v in ba.items():
        assert (torch.equal(v, bb[k]) if torch.is_tensor(v)
                else v == bb[k]), k


def _assert_tele_equal(m, jm):
    assert set(ROUND_TELE_KEYS) <= set(m)
    for k in ROUND_TELE_COUNTS:
        np.testing.assert_array_equal(m[k], np.asarray(jm[k]), err_msg=k)
    assert np.float32(m["tele_replay_fill"]).tobytes() == \
        np.asarray(jm["tele_replay_fill"], np.float32).tobytes()


@pytest.mark.parametrize("do_update", [False, True])
def test_round_telemetry_is_bit_neutral_and_matches_jax(envs,  # noqa: F811
                                                        do_update):
    jenv, env, jdcfg, dcfg, jstate = envs
    kw = TT.ROUND_KW
    cap, sigma = 64, np.float32(0.3)
    key = jax.random.PRNGKey(5)
    _, _, _, jm = make_train_round(jenv, jdcfg, telemetry=True, **kw)(
        jax.tree.map(jnp.copy, jstate),
        JR.replay_init(cap, jenv.seq_len, jenv.feat_dim, jenv.act_dim),
        key, jnp.float32(sigma), jnp.bool_(do_update))
    n = kw["batch_episodes"] * TT.KW["periods"]
    draws = TT._jax_round_draws(jenv, key, kw["batch_episodes"],
                                kw["num_updates"], kw["batch_size"],
                                min(n, cap))
    runs = []
    for tele in (False, True):
        state = D.ddpg_state_from_numpy(TT._np(jstate), dcfg, device="cpu")
        buf = replay_init(cap, env.seq_len, env.feat_dim, env.act_dim, "cpu")
        runs.append(TR._round_body(env, dcfg, telemetry=tele, **kw)(
            state, buf, draws, float(sigma), do_update))
    _assert_equal_rounds(*runs)
    assert set(runs[1][3]) - set(runs[0][3]) == set(ROUND_TELE_KEYS)
    _assert_tele_equal(runs[1][3], jm)
    assert runs[1][3]["tele_sla_hist"].sum() == kw["batch_episodes"]
    assert runs[1][3]["tele_reward_hist"].sum() == n


def test_generalist_round_telemetry_is_bit_neutral_and_matches_jax(
        fleets, params):  # noqa: F811
    jenvs, envs_ = fleets
    jpcfg, _, pcfg, _ = params
    dcfg = D.DDPGConfig(policy=pcfg)
    jstate = JD.init_ddpg(jax.random.PRNGKey(0), JD.DDPGConfig(policy=jpcfg))
    cap, sigma = 64, np.float32(0.3)
    (_, _, _, jm), draws = TG.jax_generalist_round(
        jenvs, jpcfg, jstate, TG.fleet_key(), cap, sigma, telemetry=True)
    runs = []
    for tele in (False, True):
        state = D.ddpg_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                        dcfg, device="cpu")
        buf = G.generalist_replay_init(cap, envs_[0].seq_len,
                                       G.GeneralistSpec(m_max=8), "cpu")
        runs.append(G.train._generalist_round_body(
            envs_, dcfg, churn=C.churn_preset("mixed"), telemetry=tele,
            **TG.ROUND_KW)(state, buf, draws, float(sigma), True))
    _assert_equal_rounds(*runs)
    assert runs[1][3]["fleet"] == int(jm["fleet"]) == 2
    _assert_tele_equal(runs[1][3], jm)


def test_train_rounds_host_carries_the_block(envs):  # noqa: F811
    """The flag reaches the round through ``train_rounds_host``: leaves
    stacked over the round axis; without it, none."""
    env, dcfg = envs[1], envs[3]
    out = {}
    for tele in (False, True):
        state = D.init_ddpg(torch.Generator().manual_seed(0), dcfg, "cpu")
        buf = replay_init(64, env.seq_len, env.feat_dim, env.act_dim, "cpu")
        out[tele] = TR.train_rounds_host(
            env, dcfg, state, buf, TR.round_keys(1, 0, 2), 0.3,
            [False, True], telemetry=tele, **TT.ROUND_KW)[3]
    assert not set(ROUND_TELE_KEYS) & set(out[False])
    assert out[True]["tele_sla_hist"].shape == (2, 8)
    assert out[True]["tele_reward_hist"].shape == (2, 10)
    assert out[True]["tele_committed"].shape == (2,)
    for k, v in out[False].items():
        np.testing.assert_array_equal(out[True][k], v, err_msg=k)


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------
def _summary(path, require):
    """The reference's validator on a stream, as a subprocess."""
    res = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "metrics_summary.py"),
         str(path), "--require", ",".join(require)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def _scopes(trace_dir) -> set:
    (trace,) = pathlib.Path(trace_dir).glob("*.pt.trace.json")
    return {e.get("name") for e in json.loads(trace.read_text())
            ["traceEvents"] if e.get("cat") == "user_annotation"}


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


SERVE_ARGV = ["--workload", "light", "--device", "cpu", "--periods", "6",
              "--max-rq", "24", "--max-jobs", "8", "--hidden", "16",
              "--streams", "2", "--requests", "6", "--episodes", "1"]


@pytest.mark.parametrize("batched", [True, False])
def test_serve_driver_streams_and_traces(tmp_path, batched):
    stream, trace = tmp_path / "serve.jsonl", tmp_path / "trace"
    out = serve_cli.main(SERVE_ARGV + ["--log-jsonl", str(stream),
                                       "--window", "4",
                                       "--profile-dir", str(trace)]
                         + (["--batched"] if batched else []))
    recs = _records(stream)
    head, end = recs[0], recs[-1]
    assert head["kind"] == "run_header" and head["role"] == "serve"
    assert head["jax_version"] == "none" and head["backend"] == "cpu"
    assert head["config"]["log_jsonl"] == str(stream)
    assert end == {"kind": "run_end", "v": 1, "summary": out}
    if batched:
        _summary(stream, ["run_header", "serve_window", "tenant",
                          "serve_summary", "span", "run_end"])
        assert [(r["tick_first"], r["tick_last"]) for r in recs
                if r["kind"] == "serve_window"] == [(0, 3), (4, 5)]
        summ = next(r for r in recs if r["kind"] == "serve_summary")
        assert (summ["counted"], summ["ticks"]) == (out["counted"], 6)
        assert SERVE_SCOPES <= _scopes(trace)
    else:
        _summary(stream, ["run_header", "serve_episode", "tenant", "span",
                          "run_end"])
        assert [r["name"] for r in recs if r["kind"] == "span"] == \
            ["episode"]
        assert {"serving.admit", "serving.period"}.isdisjoint(
            _scopes(trace))


def test_serve_driver_without_the_flag_carries_no_block(monkeypatch):
    """No ``--log-jsonl``: the queues carry no telemetry block (the
    telemetry-off run), the console still prints the tenant table."""
    seen = []
    real = MultiTenantService.serve_stream

    def spy(self, *a, **k):
        seen.append(k.get("telemetry"))
        return real(self, *a, **k)
    monkeypatch.setattr(MultiTenantService, "serve_stream", spy)
    serve_cli.main(SERVE_ARGV + ["--batched"])
    assert seen == [None]


def test_rl_train_driver_streams_and_traces(tmp_path):
    stream, trace = tmp_path / "train.jsonl", tmp_path / "trace"
    res = rl_train.main(TT.SMOKE + ["--outdir", str(tmp_path / "run"),
                                    "--eval-baselines", "fcfs",
                                    "--log-jsonl", str(stream),
                                    "--profile-dir", str(trace)])
    _summary(stream, ["run_header", "baseline", "train_round", "train_eval",
                      "span", "run_end"])
    recs = _records(stream)
    rounds = [r for r in recs if r["kind"] == "train_round"]
    assert [r["episode"] for r in rounds] == \
        [h["episode"] for h in res["history"]] == [1, 3]
    for r in rounds:
        assert sum(r["sla_hist"]) == 2                   # episodes a round
        assert sum(r["reward_hist"]) == 2 * 6            # x periods
        assert r["committed"] > 0 and 0 < r["replay_fill"] <= 1
    assert [r["replay_fill"] for r in rounds] == [12 / 64, 24 / 64]
    assert {r["name"] for r in recs if r["kind"] == "span"} == \
        {"collect", "eval", "ckpt"}
    assert recs[-1]["kind"] == "run_end"
    assert ROUND_SCOPES <= _scopes(trace)
