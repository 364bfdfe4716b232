"""The port's telemetry plane (``repro_torch.telemetry``) against the JAX
package's ``repro.telemetry`` on the same inputs.

Inputs are seeded NumPy draws (plus edge values, +-inf, NaN, -0.0 and
fractional / negative weights) handed to both packages.  Expected, with
no tolerance: equal histogram counts, counters and gauges; equal
``round_telemetry`` leaves, ``replay_fill`` bit-equal as float32; equal
schema tables and equal verdicts (and messages) of ``validate_record``;
equal console lines for every record kind; a JSONL stream that reads
back as written; a null session that writes nothing.
"""
import json
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.telemetry import console as JC
from repro.telemetry import metrics as JM
from repro.telemetry import schema as JS
from repro_torch.telemetry import (ConsoleSink, JsonlSink, ListSink,
                                   SchemaError, Telemetry, make_telemetry,
                                   null_telemetry, profile_trace)
from repro_torch.telemetry import console as C
from repro_torch.telemetry import metrics as M
from repro_torch.telemetry import runmeta as RM
from repro_torch.telemetry import schema as S

torch.set_num_threads(1)
EDGES = (-1.0, 0.0, 0.5, 1.0, 2.0)


def _draw(case: str, rng):
    """(values, weights or None, edges) of one primitive case."""
    if case == "uniform":
        return rng.uniform(-2.0, 3.0, 257), None, EDGES
    if case == "on_edges":
        e = np.asarray(EDGES, np.float32)
        v = np.concatenate([e, np.nextafter(e, -np.inf),
                            np.nextafter(e, np.inf)])
        return rng.permutation(v), None, EDGES
    if case == "nonfinite":
        return (np.array([np.nan, np.inf, -np.inf, 1.0, 0.0, -0.0, np.nan,
                          -np.nan, 5.0, -5.0]), None, (0.0, 1.0))
    if case == "weights_fractional_negative":
        return (rng.uniform(-2.0, 3.0, 100), rng.uniform(-3.0, 3.0, 100),
                EDGES)
    if case == "weights_int":
        return rng.normal(0.0, 1.0, 64), rng.integers(-3, 9, 64), EDGES
    if case == "sla":      # float32 edges where float64 would differ
        e = np.asarray(JM.SLA_EDGES, np.float32)
        v = np.concatenate([rng.uniform(0, 1, 60), e,
                            np.float64(e) + 1e-9, np.float64(e) - 1e-9])
        return v, None, JM.SLA_EDGES
    if case == "reward":
        return rng.normal(0.0, 2.5, (8, 30)), None, JM.REWARD_EDGES
    raise ValueError(case)


CASES = ["uniform", "on_edges", "nonfinite", "weights_fractional_negative",
         "weights_int", "sla", "reward"]


@pytest.mark.parametrize("case", CASES)
def test_hist_add_matches_jax(case):
    v, w, edges = _draw(case, np.random.default_rng(CASES.index(case)))
    v32 = np.asarray(v, np.float32)
    want = JM.hist_add(JM.hist_init(edges), v32, w)
    got = M.hist_add(M.hist_init(edges), torch.as_tensor(v32),
                     None if w is None else torch.as_tensor(w))
    np.testing.assert_array_equal(got["edges"].numpy(),
                                  np.asarray(want["edges"]))
    assert got["counts"].dtype == torch.int32
    np.testing.assert_array_equal(got["counts"].numpy(),
                                  np.asarray(want["counts"]))


def test_hist_add_reference_examples():
    """The JAX package's counts on two hand-checked inputs: weights cast
    to int32 one by one (truncated toward zero) before the sum; NaN and
    +inf in the overflow bucket, -inf in the underflow bucket."""
    h = M.hist_add(M.hist_init((0.0, 1.0)),
                   torch.tensor([0.5, 0.5, 0.5, 2.0, -1.0]),
                   torch.tensor([0.6, 0.6, 1.7, 2.5, -0.4]))
    assert h["counts"].tolist() == [0, 1, 2]
    h = M.hist_add(M.hist_init((0.0, 1.0)),
                   torch.tensor([np.nan, np.inf, -np.inf, 1.0, 0.0]))
    assert h["counts"].tolist() == [1, 1, 3]


@pytest.mark.parametrize("seed", [0, 1])
def test_per_stream_hist_rows_match_jax_per_row(seed):
    """Counts with a leading stream axis (the serving queue's depth
    histograms) equal one JAX histogram per row."""
    rng = np.random.default_rng(seed)
    edges = [64 * f for f in (0.125, 0.25, 0.375, 0.5, 0.625, 0.75,
                              0.875)]
    depth = rng.integers(0, 65, (5, 32)).astype(np.int32)   # (ticks, S)
    h = M.hist_init(edges, shape=(32,))
    for row in depth:
        h = M.hist_add(h, torch.as_tensor(row))
    for s in range(32):
        jh = JM.hist_init(edges)
        for row in depth:
            jh = JM.hist_add(jh, row[s])
        np.testing.assert_array_equal(h["counts"][s].numpy(),
                                      np.asarray(jh["counts"]))


@pytest.mark.parametrize("n", [1, 7, 2.9, -2.9, "tensor"])
def test_counter_matches_jax(n):
    jn = np.int32(5) if n == "tensor" else n
    tn = torch.tensor(5, dtype=torch.int64) if n == "tensor" else n
    want = JM.counter_add(JM.counter_add(JM.counter_init(), jn), jn)
    got = M.counter_add(M.counter_add(M.counter_init(), tn), tn)
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == int(want)


@pytest.mark.parametrize("v", [0.25, 3, np.float32(0.1), -7.5])
def test_gauge_matches_jax(v):
    want = JM.gauge_set(JM.gauge_init(), v)
    got = M.gauge_set(M.gauge_init(), v)
    assert got.dtype == torch.float32
    assert np.float32(got.item()).tobytes() == \
        np.asarray(want, np.float32).tobytes()


def test_hist_merge_quantile_and_mean_match_jax():
    rng = np.random.default_rng(3)
    a, b = rng.uniform(-2, 3, 50), rng.uniform(-2, 3, 70)
    jm = JM.hist_merge(JM.hist_add(JM.hist_init(EDGES), a),
                       JM.hist_add(JM.hist_init(EDGES), b))
    m = M.hist_merge(M.hist_add(M.hist_init(EDGES), torch.tensor(a)),
                     M.hist_add(M.hist_init(EDGES), torch.tensor(b)))
    np.testing.assert_array_equal(m["counts"].numpy(),
                                  np.asarray(jm["counts"]))
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert M.hist_quantile(m, q) == JM.hist_quantile(jm, q)
    assert M.hist_mean(m) == JM.hist_mean(jm)
    empty = M.hist_init(EDGES)
    assert np.isnan(M.hist_quantile(empty, 0.5))
    assert np.isnan(M.hist_mean(empty))


@pytest.mark.parametrize("edges", [(), [[0.0, 1.0]]])
def test_hist_init_rejects_bad_edges(edges):
    with pytest.raises(ValueError, match="non-empty 1-D"):
        M.hist_init(edges)


@pytest.mark.parametrize("size,cap", [(480, 4000), (3, 7), (4000, 4000),
                                      (1, 3), (63, 64)])
def test_round_telemetry_matches_jax(size, cap):
    rng = np.random.default_rng(size)
    sla = rng.uniform(0, 1, 8).astype(np.float32)
    sla[:2] = (0.2, 0.95)                         # on SLA edges
    rew = rng.normal(0, 2, (8, 10)).astype(np.float32)
    rew[0, :3] = (0.0, -0.5, np.nan)
    com = rng.integers(0, 90, (8, 10))
    want = JM.round_telemetry(sla, rew, com.astype(np.int32), size, cap)
    got = M.round_telemetry(torch.tensor(sla), torch.tensor(rew),
                            torch.tensor(com), size, cap)
    assert set(got) == set(M.ROUND_TELE_KEYS) == set(JM.ROUND_TELE_KEYS)
    for k in M.ROUND_TELE_COUNTS:
        assert got[k].dtype == torch.int32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    fill = got["tele_replay_fill"]
    assert fill.dtype == torch.float32 and fill.shape == ()
    assert fill.numpy().tobytes() == \
        np.asarray(want["tele_replay_fill"]).tobytes()
    # a device-side replay size gives the same float32
    again = M.round_telemetry(torch.tensor(sla), torch.tensor(rew),
                              torch.tensor(com), torch.tensor(size), cap)
    assert again["tele_replay_fill"].numpy().tobytes() == \
        fill.numpy().tobytes()


# ---------------------------------------------------------------------------
# schema, console, sinks
# ---------------------------------------------------------------------------
def test_schema_table_equals_the_reference():
    assert S.SCHEMA_VERSION == JS.SCHEMA_VERSION == 1
    assert S.SCHEMAS == JS.SCHEMAS


def _rec(kind, **over):
    base = {
        "run_header": dict(run_id="abc", role="train", created_at="t",
                           git_sha="0123456789abcdef", jax_version="none",
                           backend="cuda", host_cores=8, config={}),
        "train_round": dict(episode=7, sla=0.5, sigma=0.3,
                            periods_per_sec=12.5),
        "train_eval": dict(episode=7, eval_sla=0.75),
        "baseline": dict(name="fcfs", sla_rate=0.8),
        "serve_window": dict(tick_first=0, tick_last=15, tick_p50_us=20e3,
                             tick_p99_us=90e3, admitted=30, deferred=2,
                             completed=25, mean_depth=3.5),
        "serve_episode": dict(episode=1, sla_rate=0.9, energy_uj=1234.5),
        "tenant": dict(tenant="resnet50", jobs=12, sla_rate=None),
        "serve_summary": dict(sla_rate=0.9, counted=100, ticks=60),
        "span": dict(name="collect", secs=1.5),
        "note": dict(msg="hello"),
        "run_end": dict(),
    }[kind]
    return {"kind": kind, "v": 1, **base, **over}


RECORDS = [
    ("good_header", _rec("run_header")),
    ("good_round_extra", _rec("train_round", replay_fill=0.1, fleet="x")),
    ("good_tenant_null_sla", _rec("tenant")),
    ("good_run_end_payload", _rec("run_end", best_sla=0.5)),
    ("good_int_as_number", _rec("train_round", sla=1)),
    ("bad_not_a_dict", ["kind", "note"]),
    ("bad_no_kind", {"v": 1, "msg": "x"}),
    ("bad_no_version", {"kind": "note", "msg": "x"}),
    ("bad_version_str", {"kind": "note", "v": "1", "msg": "x"}),
    ("bad_unknown_kind", {"kind": "nope", "v": 1}),
    ("bad_missing_field", {k: v for k, v in _rec("serve_window").items()
                           if k != "deferred"}),
    ("bad_bool_number", _rec("train_round", sla=True)),
    ("bad_bool_int", _rec("serve_summary", ticks=False)),
    ("bad_type", _rec("baseline", name=3)),
    ("bad_float_for_int", _rec("train_eval", episode=7.0)),
    ("bad_config_list", _rec("run_header", config=[])),
]


@pytest.mark.parametrize("rec", [r for _, r in RECORDS],
                         ids=[n for n, _ in RECORDS])
def test_validate_record_gives_the_reference_verdict(rec):
    try:
        JS.validate_record(rec)
        want = None
    except JS.SchemaError as e:
        want = str(e)
    if want is None:
        assert S.validate_record(rec) is rec
    else:
        with pytest.raises(SchemaError) as e:
            S.validate_record(rec)
        assert str(e.value) == want


FORMATS = [
    ("note", _rec("note")),
    ("train_round", _rec("train_round")),
    ("train_round_fill_fleet", _rec("train_round", replay_fill=0.123,
                                    fleet="paper6")),
    ("train_eval", _rec("train_eval")),
    ("baseline", _rec("baseline")),
    ("serve_window", _rec("serve_window")),
    ("serve_episode", _rec("serve_episode", counted=44)),
    ("serve_episode_no_count", _rec("serve_episode")),
    ("tenant_null", _rec("tenant")),
    ("tenant_rate", _rec("tenant", sla_rate=0.8333)),
    ("serve_summary", _rec("serve_summary")),
    ("run_header", _rec("run_header")),
    ("span", _rec("span")),
    ("run_end", _rec("run_end")),
]


@pytest.mark.parametrize("rec", [r for _, r in FORMATS],
                         ids=[n for n, _ in FORMATS])
def test_format_record_gives_the_reference_line(rec):
    assert C.format_record(rec) == JC.format_record(rec)


def test_jsonl_round_trip_and_console_rendering(tmp_path):
    path = tmp_path / "sub" / "m.jsonl"
    lines = []
    tele = Telemetry([JsonlSink(str(path)), ConsoleSink(lines.append),
                      ListSink()])
    tele.run_header("serve", {"a": 1}, device="cpu")
    tele.emit("serve_window", **{k: v for k, v in
                                 _rec("serve_window").items()
                                 if k not in ("kind", "v")})
    with tele.span("serve", streams=2):
        pass
    tele.note("free text")
    tele.emit("run_end", summary={"x": 1.5})
    with pytest.raises(SchemaError):
        tele.emit("baseline", name="fcfs")            # never reaches a sink
    tele.close()
    back = [json.loads(line) for line in path.read_text().splitlines()]
    assert back == tele.sinks[2].records
    assert [r["kind"] for r in back] == ["run_header", "serve_window",
                                         "span", "note", "run_end"]
    for r in back:
        JS.validate_record(r)                # the reference accepts it
    head = back[0]
    assert head["jax_version"] == "none" and head["backend"] == "cpu"
    assert head["device_name"] == "cpu"
    assert head["torch_version"] == torch.__version__
    assert back[2]["streams"] == 2 and back[2]["secs"] >= 0
    assert lines == [JC.format_record(back[0]), JC.format_record(back[1]),
                     "free text"]
    with pytest.raises(ValueError, match="closed"):
        tele.sinks[0].emit(back[0])


def test_make_telemetry_stacks_console_and_jsonl(tmp_path, capsys):
    tele = make_telemetry(jsonl_path=str(tmp_path / "m.jsonl"))
    assert [type(s).__name__ for s in tele.sinks] == ["ConsoleSink",
                                                      "JsonlSink"]
    tele.note("to both")
    tele.close()
    assert capsys.readouterr().out == "to both\n"
    assert json.loads((tmp_path / "m.jsonl").read_text())["msg"] == "to both"
    assert [type(s).__name__ for s in make_telemetry().sinks] == \
        ["ConsoleSink"]


def test_null_telemetry_validates_but_writes_nothing(capsys, tmp_path):
    tele = null_telemetry()
    tele.run_header("train", {}, device="cpu")
    tele.note("quiet")
    with tele.span("collect"):
        pass
    with pytest.raises(SchemaError):
        tele.emit("train_round", episode=1)
    tele.close()
    assert capsys.readouterr().out == ""
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("exc", [FileNotFoundError("git"),
                                 subprocess.TimeoutExpired("git", 10),
                                 subprocess.CalledProcessError(128, "git")])
def test_runmeta_never_fails_a_run(monkeypatch, exc):
    """No git, a hung git, a checkout without ``.git`` (``git archive``)
    and no ``nvidia-smi`` all read ``unknown``."""
    def boom(*a, **k):
        raise exc
    monkeypatch.setattr(RM.subprocess, "run", boom)
    assert RM.git_sha.__wrapped__() == "unknown"
    assert RM.power_limit_w.__wrapped__() == "unknown"
    meta = RM.run_meta("cpu")
    assert meta["jax_version"] == "none" and meta["backend"] == "cpu"
    assert meta["power_limit_w"] == "unknown"


def test_power_limit_parses_nvidia_smi(monkeypatch):
    class Done:
        stdout = "NVIDIA H100 80GB HBM3, 700.00 W\n"
    monkeypatch.setattr(RM.subprocess, "run", lambda *a, **k: Done())
    assert RM.power_limit_w.__wrapped__() == 700.0


def test_profile_trace_holds_the_ranges(tmp_path):
    with profile_trace("") as p:
        assert p is None                          # nullcontext: no-op
    with profile_trace(str(tmp_path), "cpu"):
        with torch.profiler.record_function("serving.admit"):
            torch.ones(3).sum()
    (trace,) = tmp_path.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(trace.read_text())
             ["traceEvents"] if e.get("cat") == "user_annotation"}
    assert "serving.admit" in names


def test_jax_arrays_and_tensors_give_one_histogram():
    """The host estimators take either package's counts."""
    h = M.hist_add(M.hist_init(EDGES), torch.tensor([0.1, 0.7, 1.5]))
    jh = {"edges": jnp.asarray(EDGES, jnp.float32),
          "counts": jnp.asarray(h["counts"].numpy())}
    assert M.hist_quantile(h, 0.5) == JM.hist_quantile(jh, 0.5)
