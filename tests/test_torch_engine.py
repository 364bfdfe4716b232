"""The PyTorch port's batched contention engine against the JAX engine
(per stream) and the float64 NumPy oracle.

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

from repro.sim.engine import simulate_jax
from repro_torch.sim.engine import INF, simulate, simulate_np

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
