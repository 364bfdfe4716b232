"""The readers of the program's spans and counts: known values on a
hand-built profiled stretch, nothing on a program without the spans,
the idle split that sums to the device's idle time, and a traced run of
a cell on the CPU at four streams that yields every one of them."""
import pytest
import torch

from portbench import harness
from portbench import spans
from portbench import yardstick as ys

torch.set_num_threads(1)
NEW = ("engine_iters", "engine_iter_host_us", "engine_idle_share",
       "rq_build_ms", "stage_ms", "record_ms", "loop_idle_share")


def _period(t0, record):
    """One planted period of 5 s from ``t0``: the tick's and the env's
    spans, an engine call with two checks, an ATen op, the loop's spans;
    device busy but for four gaps."""
    host = [("serving.admit", 0.0, 0.5), ("serving.period", 0.5, 4.0),
            ("env.drops", 0.5, 0.7), ("env.slots", 0.7, 1.0),
            ("env.encode", 1.0, 1.2), ("env.act", 1.2, 1.5),
            ("engine.simulate", 1.6, 3.6), ("engine.check", 1.6, 1.8),
            ("aten::where", 2.0, 2.1), ("engine.check", 3.0, 3.2),
            ("env.commit", 3.7, 3.9), ("serving.retire", 4.0, 4.2),
            ("serving.readback", 4.3, 4.5), ("serving.stage", 4.9, 5.0)]
    if record:
        host.append(("serving.record", 4.5, 4.8))
    dev = [("k", 0.0, 1.0), ("k", 1.2, 2.0), ("k", 2.5, 3.1),
           ("k", 3.3, 4.4), ("k", 4.6, 5.0)]
    shift = lambda evs: [(n, t0 + s, t0 + e) for n, s, e in evs]
    return shift(host), shift(dev)


@pytest.fixture
def data(monkeypatch):
    from repro_torch.telemetry import profiler
    h1, d1 = _period(0.0, record=True)
    h2, d2 = _period(5.0, record=False)
    planted = [("engine.iterations", 2_600_000_000, 40),
               ("engine.iterations", 7_600_000_000, 24),
               ("engine.iterations", 11_000_000_000, 1000)]  # after
    monkeypatch.setattr(profiler, "counts", lambda: planted)
    return dict(host_events=[("portbench.window", 0.0, 10.0),
                             ("serving.stage", -0.1, 0.0)] + h1 + h2,
                device_events=d1 + d2, window=(0.0, 10.0), window_s=10.0,
                profiled_periods=2)


# idle a period: encode 0.2; engine.simulate 0.5 + 0.1, engine.check 0.1;
# readback 0.1, then record 0.1 (first period) or no span (second)
EXPECTED = dict(engine_iters=32.0,
                engine_iter_host_us=1e6 * 2 * (2.0 - 0.4) / 64,
                engine_idle_share=100 * 2 * 0.7 / 10,
                rq_build_ms=1e3 * 0.7, stage_ms=1e3 * 0.1,
                record_ms=1e3 * 0.3 / 2,
                loop_idle_share=100 * 2 * 0.2 / 10)


@pytest.mark.parametrize("metric", NEW)
def test_reader_reads_the_planted_stretch(data, metric):
    assert harness.reader(metric)(data) == pytest.approx(EXPECTED[metric],
                                                         rel=1e-9)


def test_idle_split_sums_to_the_idle_time(data):
    tot = spans.idle_by_span(data)
    idle = 10.0 - ys.busy_seconds(data["device_events"], 0.0, 10.0)
    assert sum(tot.values()) == pytest.approx(idle, rel=1e-12)
    assert tot == pytest.approx({"env.encode": 0.4, "engine.simulate": 1.2,
                                 "engine.check": 0.2,
                                 "serving.readback": 0.2,
                                 "serving.record": 0.1, spans.NONE: 0.1})
    assert harness.reader("device_idle_share")(data) == pytest.approx(22.0)


def test_a_program_without_the_spans_reads_nothing(data, monkeypatch):
    from repro_torch.telemetry import profiler
    old = {"serving.admit", "serving.period", "serving.retire",
           "serving.telemetry", "portbench.window"}
    data["host_events"] = [ev for ev in data["host_events"]
                           if ev[0] in old or ev[0].startswith("aten::")]
    monkeypatch.delattr(profiler, "counts")
    for metric in NEW:
        assert harness.reader(metric)(data) is None, metric
    assert harness.reader("admit_retire_ms")(data) is not None


def test_stretch_without_records_reads_zero(data):
    data["host_events"] = [ev for ev in data["host_events"]
                           if ev[0] != "serving.record"]
    assert harness.reader("record_ms")(data) == 0.0


def test_the_program_opens_every_span_the_readers_name():
    """The readers' names stay the program's; the program may add more."""
    from repro_torch.telemetry import profiler
    named = set(spans.LOOP) | set(spans.OTHER) | {"engine.simulate",
                                                  "engine.check"}
    assert named <= profiler.SPANS
    assert all(n.startswith(spans.ENGINE) for n in profiler.SPANS
               if n.startswith("engine"))
    assert "engine.iterations" in profiler.COUNTERS


@pytest.mark.parametrize("new", [
    ("engine.step", 2.2, 2.9),        # inside engine.simulate, over a gap
    ("env.extra", 1.0, 1.2),          # inside serving.period, over a gap
    ("serving.extra", 4.8, 4.95),     # the loop, outside every span
    ("serving.extra", 4.3, 4.5)])     # inside serving.readback
def test_a_span_the_program_adds_moves_no_metric(data, new):
    name, s, e = new
    data["host_events"] += [(name, s, e), (name, 5.0 + s, 5.0 + e)]
    for metric in NEW:
        assert harness.reader(metric)(data) == pytest.approx(
            EXPECTED[metric], rel=1e-9), metric


def test_a_traced_cpu_run_reads_every_new_metric():
    ctx = harness.load_ctx("paper6-light-pareto", 2 ** 33 + 5, 0.0, True,
                           "cpu", 0.0)
    ctx.traffic = dict(ctx.traffic, streams=4)
    out, res = harness.run_cell(ctx)
    assert out["correct"], out["checks"]
    mets = out["metrics"]
    for metric in NEW + ("admit_retire_ms",):
        assert metric in mets, metric
    data = res["data"]
    lo, hi = data["window"]
    # no device operations on the CPU: the split covers the stretch
    assert sum(spans.idle_by_span(data).values()) == pytest.approx(hi - lo)
    assert mets["engine_iters"]["value"] >= 1
    assert 0 < mets["engine_idle_share"]["value"] + \
        mets["loop_idle_share"]["value"] < 100
