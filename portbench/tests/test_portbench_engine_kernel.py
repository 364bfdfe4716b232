"""``engine_kernel_share``: the program's ``engine.kernel`` counts in the
profiled stretch, planted: the share of engine calls on the kernel, the
counts outside the stretch left out, nothing for a program without the
count."""
import pytest

from portbench import harness


def _data(monkeypatch, planted):
    from repro_torch.telemetry import profiler
    monkeypatch.setattr(profiler, "counts", lambda: planted)
    return dict(host_events=[("portbench.window", 0.0, 10.0)],
                device_events=[], window=(0.0, 10.0), window_s=10.0,
                profiled_periods=2)


@pytest.mark.parametrize("kernel,want", [((1, 1, 1), 100.0),
                                         ((0, 0, 0), 0.0),
                                         ((1, 0, 1), 200.0 / 3)])
def test_share_of_the_stretch_engine_calls(monkeypatch, kernel, want):
    planted = [("engine.kernel", t, k) for t, k in zip(
        (1_000_000_000, 4_000_000_000, 9_000_000_000), kernel)]
    planted += [("engine.kernel", 12_000_000_000, 0),          # after
                ("engine.iterations", 2_000_000_000, 40)]
    got = harness.reader("engine_kernel_share")(_data(monkeypatch, planted))
    assert got == pytest.approx(want, rel=1e-12)


def test_a_program_without_the_count_reads_nothing(monkeypatch):
    planted = [("engine.iterations", 2_000_000_000, 40)]
    data = _data(monkeypatch, planted)
    assert harness.reader("engine_kernel_share")(data) is None
    from repro_torch.telemetry import profiler
    monkeypatch.delattr(profiler, "counts")
    assert harness.reader("engine_kernel_share")(data) is None
