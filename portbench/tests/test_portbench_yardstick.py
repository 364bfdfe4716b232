"""The benchmark's arithmetic: percentiles, the union of
device intervals and the idle gaps, and the kernel's operations and
bytes against the port's own formulas."""
import numpy as np
import pytest
import torch

from portbench import traffic as gen
from portbench import yardstick as ys

torch.set_num_threads(1)


@pytest.mark.parametrize("q", [0, 5, 50, 95, 99, 100])
def test_percentile_is_numpys_linear(q):
    x = np.random.default_rng(0).lognormal(size=201)
    assert ys.percentile(x, q) == pytest.approx(np.percentile(x, q),
                                                rel=1e-12)


def test_busy_idle_and_gaps():
    dev = [("a", 0.0, 1.0), ("b", 0.5, 2.0), ("a", 3.0, 4.0),
           ("c", 9.0, 12.0)]
    assert ys.busy_seconds(dev, 0.5, 10.0) == pytest.approx(1.5 + 1.0 + 1.0)
    assert ys.idle_gaps(dev, 0.5, 10.0) == [(2.0, 3.0), (4.0, 9.0)]
    host = [("outer", 0.0, 10.0), ("inner", 3.5, 5.0)]
    rows = ys.gaps_by_host_op([(2.0, 3.0), (4.0, 9.0)], host)
    assert rows == [["inner", 5.0], ["outer", 1.0]]
    assert ys.device_time_by_name(dev, 0.0, 10.0) == [
        ["a", 2.0], ["b", 1.5], ["c", 1.0]]


def test_kernel_formulas_match_the_ports_when_every_step_is_live():
    from repro_torch.kernels.lstm_seq import ops
    T, B, F, H = 97, 32, 16, 256
    xs, mask = torch.zeros(T, B, F), torch.ones(T, B, dtype=torch.bool)
    wx, wh, b = torch.zeros(F, 4 * H), torch.zeros(H, 4 * H), torch.zeros(4 * H)
    assert ys.lstm_seq_flops(T * B, F, H) == ops.flops(
        xs.shape, mask.shape, wx.shape, wh.shape, b.shape)
    assert ys.lstm_seq_bytes(T, B, T * B, F, H) == ops.bytes_moved(
        xs, mask, wx, wh, b)


@pytest.mark.parametrize("scenario", gen.SCENARIOS)
def test_generator_draws_the_ports_streams(scenario):
    """The copied generator draws what the port's ``request_stream``
    draws from the same generator state."""
    from repro_torch.serving.loadgen import LoadGenConfig, request_stream
    from repro_torch.sim.arrivals import ArrivalConfig

    class Env:
        min_lat = np.array([2161.5, 681.0, 11.7, 6456.5], np.float32)
        arrivals = ArrivalConfig(load=0.9, qos_factor=3.0, slack_us=1000.0,
                                 horizon_us=18000.0)

        class registry:
            model_names = ["a", "b", "c", "d"]
    arr = dict(load=0.9, eff_parallelism=3.0, qos_factor=3.0,
               qos_level="medium", slack_us=1000.0)
    traffic = dict(scenario=scenario, rate_scale=1.5, requests_per_stream=40)
    mine = gen.stream(Env.min_lat, arr, traffic, 18000.0,
                      np.random.default_rng(11))
    theirs = request_stream(Env, LoadGenConfig(scenario=scenario,
                                               rate_scale=1.5, n_requests=40),
                            np.random.default_rng(11))
    assert [r.rid for r in theirs] == list(mine["rid"])
    assert [r.tenant for r in theirs] == [Env.registry.model_names[m]
                                          for m in mine["model"]]
    for k, col in (("arrival_us", "arrival"), ("deadline_us", "deadline"),
                   ("q_us", "q")):
        assert [getattr(r, k) for r in theirs] == [float(v)
                                                   for v in mine[col]]


def test_device_operations_leave_out_annotations():
    """A device event named as a host range is the range's annotation,
    not an operation."""
    from portbench.runners.relmas import split_events
    evs = [(("serving.admit", 0.0, 5.0), False),
           (("serving.admit", 0.1, 4.0), True),
           (("void lstm_seq_kernel<16, 8>", 1.0, 2.0), True),
           (("Memcpy DtoH (Device -> Pinned)", 3.0, 3.5), True)]
    dev, host, kinds = split_events(evs)
    assert [x[0] for x in dev] == ["void lstm_seq_kernel<16, 8>",
                                   "Memcpy DtoH (Device -> Pinned)"]
    assert host == [("serving.admit", 0.0, 5.0)]
    assert kinds == {"operation": 2, "annotation": 1}


def test_horizon_cut_keeps_the_env_traces_rows():
    """With ``horizon_cut``, a stream of ``max_jobs`` draws is the port's
    episode trace (``sim/arrivals.py::generate_trace``) less the rows it
    pads past the arrival horizon."""
    from repro_torch.sim.arrivals import ArrivalConfig, generate_trace
    min_lat = np.array([2161.5, 681.0, 11.7, 6456.5], np.float32)
    cfg = ArrivalConfig(max_jobs=64, load=0.9, qos_factor=3.0,
                        slack_us=1000.0, horizon_us=18000.0)
    arr = dict(load=0.9, eff_parallelism=3.0, qos_factor=3.0,
               qos_level="medium", slack_us=1000.0)
    traffic = dict(scenario="default", rate_scale=1.0,
                   requests_per_stream=64, horizon_cut=True)
    for seed in (3, 2 ** 33 + 1):
        mine = gen.stream(min_lat, arr, traffic, 18000.0,
                          np.random.default_rng(seed))
        env = generate_trace(min_lat, cfg, np.random.default_rng(seed))
        live = env["arrival"] < 1e29
        assert 0 < len(mine["arrival"]) == live.sum() < 64
        np.testing.assert_array_equal(mine["model"], env["model"][live])
        np.testing.assert_array_equal(mine["arrival"].astype(np.float32),
                                      env["arrival"][live])
