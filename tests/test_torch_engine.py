"""The PyTorch port's batched contention engine against the JAX engine
(per stream) and the float64 NumPy oracle, and its route: CPU tensors
and the segment engine run the eager loop ``_loop``; CUDA tensors the
event-loop kernel, which raises for shapes beyond its limits (here on
fake CUDA tensors, which launch nothing).  The kernel itself is held to
``_loop`` on the card (``tests/test_torch_kernels_gpu.py``).

Inputs are drawn with NumPy from a seed and handed to all three.
Tolerances: against ``simulate_jax`` the event sequence is the same in
float32, but sums (total bandwidth demand) and divisions may round in
another order, so times agree to rtol 1e-5 / atol 1e-3 us; against the
float64 oracle, the tolerance of ``tests/test_engine.py`` (rtol 1e-3,
atol 1e-2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch._subclasses.fake_tensor import FakeTensorMode
from torch.profiler import ProfilerActivity, profile

from repro.sim.engine import simulate_jax
from repro_torch.kernels.event_loop import ops as ev_ops
from repro_torch.sim import engine
from repro_torch.sim.engine import INF, simulate, simulate_np
from repro_torch.telemetry import profiler as P

torch.set_num_threads(1)


def _draw(seed, S, n, M):
    """Random schedules shaped like the env's packing: contiguous layer
    chains per job, some invalid tail slots."""
    rng = np.random.default_rng(seed)
    valid = np.zeros((S, n), bool)
    dep = np.full((S, n), -1, np.int64)
    for s in range(S):
        n_valid = rng.integers(1, n + 1)
        valid[s, :n_valid] = True
        for i in range(1, n_valid):
            if rng.uniform() < 0.6:
                dep[s, i] = i - 1
    return dict(
        valid=valid,
        assign=rng.integers(0, M, size=(S, n)),
        prio=rng.uniform(-1, 1, size=(S, n)).astype(np.float32),
        cost=rng.uniform(0.5, 200.0, size=(S, n)).astype(np.float32),
        bw=rng.uniform(0.5, 16.0, size=(S, n)).astype(np.float32),
        dep=dep,
        ready=(rng.uniform(0, 100, size=(S, n)) * (dep < 0)).astype(
            np.float32),
        sa_free=rng.uniform(0, 50, size=(S, M)).astype(np.float32),
        B=np.float32(rng.uniform(4.0, 16.0)))


def _torch(sc, M, stop):
    args = [torch.as_tensor(sc[k]) for k in
            ("valid", "assign", "prio", "cost", "bw", "dep", "ready",
             "sa_free")]
    s, f = simulate(*args, float(sc["B"]), num_sas=M, stop_start_after=stop)
    return s.numpy(), f.numpy()


# the shapes of tests/test_engine.py's property test, and the env's RQ
@pytest.mark.parametrize("S,n,M", [(4, 2, 1), (6, 12, 4), (3, 32, 6),
                                   (2, 96, 6)])
@pytest.mark.parametrize("stop", [None, 250.0])
def test_batched_engine_matches_simulate_jax(S, n, M, stop):
    sc = _draw(n * 7 + M, S, n, M)
    start, finish = _torch(sc, M, stop)
    for s in range(S):
        sj, fj = simulate_jax(
            *(jnp.asarray(sc[k][s]) for k in
              ("valid", "assign", "prio", "cost", "bw", "dep", "ready",
               "sa_free")), jnp.float32(sc["B"]), num_sas=M,
            stop_start_after=stop)
        sj, fj = np.asarray(sj), np.asarray(fj)
        # which SJs started / finished is the same decision
        np.testing.assert_array_equal(start[s] < INF / 2, sj < INF / 2)
        np.testing.assert_array_equal(finish[s] < INF / 2, fj < INF / 2)
        np.testing.assert_allclose(start[s], sj, rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(finish[s], fj, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("S,n,M", [(5, 12, 3), (3, 40, 6)])
def test_batched_engine_matches_numpy_oracle(S, n, M):
    sc = _draw(100 + n, S, n, M)
    start, finish = _torch(sc, M, None)
    for s in range(S):
        so, fo = simulate_np(*(sc[k][s] for k in
                               ("valid", "assign", "prio", "cost", "bw",
                                "dep", "ready", "sa_free")), float(sc["B"]))
        v = sc["valid"][s]
        assert np.all(finish[s][v] < INF / 2)
        np.testing.assert_allclose(start[s][v], so[v], rtol=1e-3, atol=1e-2)
        np.testing.assert_allclose(finish[s][v], fo[v], rtol=1e-3, atol=1e-2)


def test_stop_start_after_keeps_early_starters_exact():
    """The serving early exit: every SJ that starts before the horizon
    gets the start and finish of the full run, bit for bit."""
    sc = _draw(7, 4, 24, 3)
    s_full, f_full = _torch(sc, 3, None)
    stop = float(np.median(s_full[s_full < INF / 2]))
    s_cut, f_cut = _torch(sc, 3, stop)
    early = s_full < stop
    assert early.any() and not early.all()
    np.testing.assert_array_equal(s_cut[early], s_full[early])
    np.testing.assert_array_equal(f_cut[early], f_full[early])


def test_streams_do_not_couple():
    """A stream's schedule does not depend on the streams batched with
    it: running it alone gives the same numbers bit for bit."""
    sc = _draw(11, 5, 20, 4)
    start, finish = _torch(sc, 4, None)
    one = {k: (v[2:3] if isinstance(v, np.ndarray) and v.ndim == 2 else v)
           for k, v in sc.items()}
    s1, f1 = _torch(one, 4, None)
    np.testing.assert_array_equal(s1[0], start[2])
    np.testing.assert_array_equal(f1[0], finish[2])


def _args(sc):
    return [torch.as_tensor(sc[k]) for k in
            ("valid", "assign", "prio", "cost", "bw", "dep", "ready",
             "sa_free")]


def test_cpu_tensors_run_the_loop_and_count_no_kernel():
    """On the CPU ``simulate`` is ``_loop``, bit for bit; under a
    profiler the call counts ``engine.kernel`` 0 and its
    ``engine.iterations``."""
    sc = _draw(5, 4, 24, 3)
    before = len(P.counts())
    with profile(activities=[ProfilerActivity.CPU]):
        s1, f1 = simulate(*_args(sc), float(sc["B"]), num_sas=3)
    cnt = [(name, n) for name, _, n in P.counts()[before:]]
    assert ("engine.kernel", 0) in cnt
    assert [name for name, _ in cnt] == ["engine.kernel",
                                         "engine.iterations"]
    s2, f2, it = engine._loop(*_args(sc), float(sc["B"]), num_sas=3,
                              stop_start_after=None, segments=False)
    assert torch.equal(s1, s2) and torch.equal(f1, f2)
    assert it.shape == (4,) and 1 <= int(it.max()) <= 3 * 24 + 3 + 16


def _fake_call(device, S, n, M, fn=simulate):
    with FakeTensorMode():
        e = lambda *shape, dtype=torch.float32: torch.empty(
            shape, dtype=dtype, device=device)
        i64 = torch.int64
        out = fn(e(S, n, dtype=torch.bool), e(S, n, dtype=i64), e(S, n),
                 e(S, n), e(S, n), e(S, n, dtype=i64), e(S, n), e(S, M),
                 8.0, num_sas=M)
        return [(tuple(o.shape), o.device.type) for o in out]


@pytest.mark.parametrize("S,n,M,fits", [
    (1, 96, 6, True), (16384, 96, 6, True), (3, 256, 32, True),
    (1, 1, 1, True), (1, 257, 6, False), (4, 96, 33, False),
    (0, 96, 6, True), (4, 96, 0, False)])
def test_kernel_limits(S, n, M, fits):
    """The operator takes n <= 256 slots on 1 <= M <= 32 SAs and any
    number of streams; its checks run on the fake route as on the
    card's, so a shape beyond them raises before any launch."""
    call = lambda: _fake_call("cuda", S, n, M, ev_ops.event_loop)
    if fits:
        assert call() == [((S, n), "cuda")] * 2 + [((S,), "cuda")]
    else:
        with pytest.raises(ValueError, match="n <= 256 slots on 1 <= M "
                                             "<= 32 SAs"):
            call()


@pytest.mark.parametrize("device,S,n,M,route", [
    ("cuda", 16384, 96, 6, "kernel"), ("cuda", 3, 256, 32, "kernel"),
    ("cuda", 2, 257, 6, "raises"), ("cuda", 2, 96, 33, "raises"),
    ("cuda", 0, 96, 6, "kernel"), ("cpu", 4, 96, 6, "loop"),
    ("cpu", 2, 257, 33, "loop")])
def test_route_by_device_and_shape(monkeypatch, device, S, n, M, route):
    """CUDA tensors go to the operator (its fake route here: the
    outputs' shapes, no launch), which raises for a shape beyond the
    kernel's limits; CPU tensors, of any shape, to ``_loop``.
    ``engine.kernel`` says which."""
    counted, loops = [], []

    def loop(valid, *a, **k):
        loops.append(k["segments"])
        return valid.float(), valid.float(), valid.sum(1)
    monkeypatch.setattr(engine, "_loop", loop)
    monkeypatch.setattr(engine, "count", lambda name, v: counted.append(
        (name, v)))
    launches = ev_ops.LAUNCHES
    if route == "raises":
        with pytest.raises(ValueError, match="event_loop kernel takes"):
            _fake_call(device, S, n, M)
    else:
        assert _fake_call(device, S, n, M) == [((S, n), device)] * 2
    assert ev_ops.LAUNCHES == launches
    assert counted == [("engine.kernel", int(route != "loop"))]
    assert loops == ([False] if route == "loop" else [])


def test_segment_engine_never_takes_the_kernel(monkeypatch):
    loops = []

    def loop(valid, *a, **k):
        loops.append(k["segments"])
        return valid.float(), valid.float(), valid.sum(1)
    monkeypatch.setattr(engine, "_loop", loop)
    _fake_call("cuda", 4, 96, 6, engine.simulate_segments)
    assert loops == [True]


@pytest.mark.parametrize("stop", [None, 250.0])
def test_operator_cpu_route_is_the_loop(stop):
    """``event_loop`` on CPU tensors runs ``_loop``: ``simulate``'s start
    and finish bit for bit, and each stream's iterations as int32 (0
    for a stream with nothing valid); a per-stream ``B`` is
    ``simulate``'s with that tensor."""
    sc = _draw(21, 5, 32, 4)
    sc["valid"][3] = False
    B = torch.as_tensor(np.linspace(4.0, 16.0, 5), dtype=torch.float32)
    for b in (float(sc["B"]), B):
        s1, f1 = simulate(*_args(sc), b, num_sas=4, stop_start_after=stop)
        s2, f2, it = ev_ops.event_loop(*_args(sc), b, num_sas=4,
                                       stop_start_after=stop)
        assert torch.equal(s1, s2) and torch.equal(f1, f2)
        assert it.dtype == torch.int32 and int(it[3]) == 0
        assert 1 <= int(it.max()) <= 3 * 32 + 4 + 16
