"""The port's spans and counts (``repro_torch/telemetry/profiler.py``) on
the serving path, on the CPU at 3 streams.

- Under ``torch.profiler`` one ``serve_stream`` opens every span of the
  service loop, the tick, the period and the engine, each nested as
  documented: the ``env.*`` spans and the engine inside
  ``serving.period``, ``engine.check`` inside ``engine.simulate``, the
  loop's spans outside the tick's.
- ``engine.iterations`` equals the iterations the profiler saw (one
  ``aten::isfinite`` an iteration), and each count carries a time
  inside its ``engine.simulate`` range as the profiler reports it;
  ``engine.kernel`` counts 0 for each call (the CPU's eager loop).
- With no profiler running no span enters ``record_function`` and no
  count is kept.
- ``serve_stream``'s outputs are bit-equal with the profiler on and off.
- ``SPANS`` is the one list of names: every span the package opens is
  in it, the docstring and the README name each of its spans and
  counters, and no range of the package opens outside ``span``.
- ``stats["tick_wall_us"]`` times the period from its staging to its
  completion records.
"""
import pathlib
import re
import time

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.serving import LoadGenConfig, MultiTenantService
from repro_torch.serving import request_streams
from repro_torch.sim.env import EnvConfig
from repro_torch.telemetry import ListSink, Telemetry
from repro_torch.telemetry import profiler as P
from repro_torch.workloads import build_registry

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
PERIODS = 8
KW = dict(periods=PERIODS, max_rq=32, max_jobs=12)
LG = LoadGenConfig(scenario="default", rate_scale=1.5, n_requests=14)
LOOP = ("serving.stage", "serving.readback", "serving.record")
TICK = ("serving.admit", "serving.period", "serving.retire",
        "serving.telemetry")
ENV = ("env.drops", "env.slots", "env.encode", "env.act", "env.commit")


def _service(policy="relmas"):
    svc = MultiTenantService(build_registry("light"), policy=policy,
                             env_cfg=EnvConfig(**KW), hidden=16,
                             device="cpu")
    return svc, request_streams(svc.env, LG, 3, seed=4)


def _profiled(fn):
    """``fn()`` under a CPU profiler: its result, the host events as
    ``(name, start_ns, end_ns)`` in start order, and the counts kept."""
    before = len(P.counts())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    evs = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CPU),
                 key=lambda ev: (ev[1], -ev[2]))
    return out, evs, P.counts()[before:]


def _named(evs, *names):
    return [ev for ev in evs if ev[0] in names]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.fixture(scope="module")
def traced():
    svc, reqs = _service()
    res, evs, cnt = _profiled(lambda: svc.serve_stream(
        reqs, tick_k=4, telemetry=Telemetry([ListSink()])))
    return res, evs, cnt


def test_every_span_opens_nested_as_documented(traced):
    res, evs, _ = traced
    for name in ("serving.resolve", "serving.flush"):
        assert len(_named(evs, name)) == 1, name
    for name in ("serving.stage", "serving.readback") + TICK + ENV + (
            "engine.simulate",):
        assert len(_named(evs, name)) == PERIODS, name
    assert 1 <= len(_named(evs, "serving.record")) <= PERIODS
    assert len(_named(evs, "engine.check")) >= PERIODS
    assert res["aggregate"]["completed"] > 0
    periods = _named(evs, "serving.period")
    for name in ENV + ("engine.simulate",):
        assert all(any(_inside(ev, p) for p in periods)
                   for ev in _named(evs, name)), name
    sims = _named(evs, "engine.simulate")
    assert all(any(_inside(c, s) for s in sims)
               for c in _named(evs, "engine.check"))
    # the engine runs between the actor and the commit of its period
    for p, s in zip(periods, sims):
        act = next(ev for ev in _named(evs, "env.act") if _inside(ev, p))
        com = next(ev for ev in _named(evs, "env.commit") if _inside(ev, p))
        assert act[2] <= s[1] and s[2] <= com[1]
    # the loop's spans hold no tick span and lie in none
    ticks = _named(evs, *TICK)
    for lp in _named(evs, *LOOP, "serving.resolve", "serving.flush"):
        assert not any(t[1] < lp[2] and lp[1] < t[2] for t in ticks), lp
    # a period's loop spans in order: stage, the tick, read-back, record
    stages, backs = _named(evs, "serving.stage"), _named(evs,
                                                         "serving.readback")
    for st, adm, p, bk in zip(stages, _named(evs, "serving.admit"),
                              periods, backs):
        assert st[2] <= adm[1] and p[2] <= bk[1]
    for rec in _named(evs, "serving.record"):
        assert any(bk[2] <= rec[1] for bk in backs)


def test_engine_iterations_match_the_profiled_iterations(traced):
    """One ``aten::isfinite`` an iteration of the event loop: the
    profiler's count of them inside each ``engine.simulate`` range is
    the iterations counted for it, whose time lies inside that range."""
    _, evs, cnt = traced
    sims = _named(evs, "engine.simulate")
    iters = [c for c in cnt if c[0] == "engine.iterations"]
    assert len(iters) == len(sims) == PERIODS
    finite = _named(evs, "aten::isfinite")
    for (_, t_ns, n), s in zip(iters, sims):
        assert s[1] <= t_ns <= s[2]
        assert n == sum(_inside(f, s) for f in finite) > 0
        # a check every 16 iterations; the loop leaves at a failed one,
        # or at its bound without one
        checks = sum(_inside(c, s) for c in _named(evs, "engine.check"))
        assert checks == (n // 16 + 1 if n % 16 == 0 else -(-n // 16))


def test_each_cpu_engine_call_counts_the_plain_route(traced):
    """On the CPU every engine call runs the eager loop: one
    ``engine.kernel`` count of 0 each, taken inside its
    ``engine.simulate`` range; the counter is listed in ``COUNTERS``,
    the docstring and the README."""
    _, evs, cnt = traced
    sims = _named(evs, "engine.simulate")
    kern = [c for c in cnt if c[0] == "engine.kernel"]
    assert [n for _, _, n in kern] == [0] * len(sims) == [0] * PERIODS
    for (_, t_ns, _), s in zip(kern, sims):
        assert s[1] <= t_ns <= s[2]
    assert "engine.kernel" in P.COUNTERS
    assert "``engine.kernel``" in P.__doc__
    assert "`engine.kernel`" in (ROOT / "README.md").read_text()


def test_a_count_carries_the_time_of_its_range():
    """The shared clock: a count taken inside a span lands between the
    span's start and end as the profiler reports them."""
    def fn():
        with P.span("engine.simulate"):
            time.sleep(0.002)
            P.count("engine.iterations", 3)
            time.sleep(0.002)
    _, evs, cnt = _profiled(fn)
    (_, s, e), = _named(evs, "engine.simulate")
    (name, t_ns, n), = cnt
    assert (name, n) == ("engine.iterations", 3)
    assert s + 1_000_000 <= t_ns <= e - 1_000_000


def test_no_profiler_no_range_and_no_count(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(P, "record_function", refuse)
    before = P.counts()
    with P.span("serving.stage"):
        P.count("engine.iterations", 5)
    svc, reqs = _service()
    res = svc.serve_stream(reqs, tick_k=4, telemetry=Telemetry([ListSink()]))
    assert res["aggregate"]["counted"] > 0
    assert P.counts() == before


@pytest.mark.parametrize("policy", ["relmas", "fcfs"])
def test_outputs_bit_equal_with_the_profiler_on_and_off(policy):
    svc, reqs = _service(policy)
    off = svc.serve_stream(reqs, tick_k=4)
    on, evs, _ = _profiled(lambda: svc.serve_stream(reqs, tick_k=4))
    assert _named(evs, "engine.simulate")
    for k in ("metrics", "aggregate", "completions"):
        assert on[k] == off[k], k
    for k, v in off["stats"].items():
        if k != "tick_wall_us":
            assert on["stats"][k] == v, k


def test_every_span_is_listed_and_no_range_bypasses_span():
    src = ROOT / "src" / "repro_torch"
    opened = set()
    for path in sorted(src.rglob("*.py")):
        text = path.read_text()
        # bare ``span(...)``: ``tele.span`` is a JSONL record, not a range
        opened |= set(re.findall(r"(?<![\w.])span\(\"([\w.]+)\"\)", text))
        if path.name != "profiler.py":
            assert "record_function" not in text, path
    assert opened == P.SPANS
    doc = P.__doc__
    readme = (ROOT / "README.md").read_text()
    for name in P.SPANS | P.COUNTERS:
        assert f"``{name}``" in doc, name
        assert f"`{name}`" in readme, name


def test_tick_wall_us_times_staging_through_the_records(monkeypatch):
    """A period with completions waits for its records: the repaired
    ``tick_wall_us`` holds them."""
    svc, reqs = _service("fcfs")
    record = MultiTenantService._record
    slow = []

    def sleepy(out, comp, completions):
        slow.append(len(slow))
        time.sleep(0.05)
        return record(out, comp, completions)
    monkeypatch.setattr(MultiTenantService, "_record",
                        staticmethod(sleepy))
    res = svc.serve_stream(reqs, tick_k=4)
    wall = res["stats"]["tick_wall_us"]
    assert len(wall) == PERIODS and len(slow) > 1   # the flush records too
    assert sum(w >= 5e4 for w in wall) == len(slow) - 1
