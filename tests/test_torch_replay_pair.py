"""The sharded trainer's replay pieces in the port against the JAX
package: the masked ring write, the double-buffered ring pair, the
per-(device, round) seeds, the byte packing of a sampled batch and the
global sample through the in-process collective.

The same NumPy-drawn batches go into both packages; every comparison is
bit-equal (ring writes move values, they compute nothing).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import replay as JR
from repro_torch.core import replay as R
from repro_torch.core import train as TR

torch.set_num_threads(1)
T, F, G = 4, 3, 2


def _batch(rng, n, fleet=False):
    b = dict(s=rng.standard_normal((n, T, F)).astype(np.float32),
             mask=rng.random((n, T)) < 0.6,
             a=rng.standard_normal((n, T - 1, G)).astype(np.float32),
             r=rng.standard_normal(n).astype(np.float32),
             s2=rng.standard_normal((n, T, F)).astype(np.float32),
             mask2=rng.random((n, T)) < 0.6)
    if fleet:
        b["fleet"] = rng.integers(0, 3, n)
    return b


def _jax_ring(cap, fleet=False):
    buf = JR.replay_init(cap, T, F, G)
    if fleet:
        buf["fleet"] = jnp.zeros((cap,), jnp.int32)
    return buf


def _ring(cap, fleet=False):
    buf = R.replay_init(cap, T, F, G, "cpu")
    if fleet:
        buf["fleet"] = torch.zeros((cap,), dtype=torch.int64)
    return buf


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _assert_ring(buf, jbuf):
    assert buf["ptr"] == int(jbuf["ptr"]) and buf["size"] == int(jbuf["size"])
    assert set(R.replay_fields(buf)) == set(JR.replay_fields(jbuf))
    for k in R.replay_fields(buf):
        np.testing.assert_array_equal(buf[k].numpy(), np.asarray(jbuf[k]),
                                      err_msg=k)


@pytest.mark.parametrize("n", [0, 2, 5])
def test_replay_add_masked_partial_and_empty(n):
    rng = np.random.default_rng(n)
    b = _batch(rng, 5)
    buf = R.replay_add_masked(_ring(8), _t(b), n)
    jbuf = JR.replay_add_masked(_jax_ring(8), {k: jnp.asarray(v)
                                               for k, v in b.items()},
                                jnp.int32(n))
    _assert_ring(buf, jbuf)
    assert buf["ptr"] == buf["size"] == n
    assert not buf["r"][n:].any()
    with pytest.raises(ValueError, match="outside"):
        R.replay_add_masked(_ring(8), _t(b), 6)


def test_replay_add_masked_wraps_like_jax():
    """Three writes of 5 into a ring of 8: the second and third wrap."""
    rng = np.random.default_rng(1)
    buf, jbuf = _ring(8), _jax_ring(8)
    for n in (5, 3, 5):
        b = _batch(rng, 5)
        R.replay_add_masked(buf, _t(b), n)
        jbuf = JR.replay_add_masked(jbuf, {k: jnp.asarray(v)
                                           for k, v in b.items()},
                                    jnp.int32(n))
        _assert_ring(buf, jbuf)


@pytest.mark.parametrize("fleet", [False, True])
def test_replay_pair_matches_jax_over_four_rounds(fleet):
    """The pair on the same batches as JAX's ``replay_pair_step``: read
    and write rings, ``pending`` and ``pending_n`` bit-equal after every
    round (20 writes into a ring of 8: it wraps twice), and the read
    ring bit-equal to one ring fed the batches in order."""
    cap, rnd = 8, 5
    rng = np.random.default_rng(2)
    pair = R.replay_pair_init(_ring(cap, fleet), rnd)
    jpair = JR.replay_pair_init(_jax_ring(cap, fleet), rnd)
    single = _ring(cap, fleet)
    assert pair["pending_n"] == 0
    for _ in range(4):
        b = _batch(rng, rnd, fleet)
        R.replay_pair_step(pair, _t(b))
        jpair = JR.replay_pair_step(jpair, {k: jnp.asarray(v)
                                            for k, v in b.items()})
        R.replay_add(single, _t(b))
        for ring in ("read", "write"):
            _assert_ring(pair[ring], jpair[ring])
        for k in pair["pending"]:
            np.testing.assert_array_equal(pair["pending"][k].numpy(),
                                          np.asarray(jpair["pending"][k]))
        assert pair["pending_n"] == int(jpair["pending_n"]) == rnd
        for k in R.replay_fields(single):
            assert torch.equal(pair["read"][k], single[k]), k
    assert pair["read"]["size"] == cap


def test_shard_round_keys_shape_distinct_and_resumable():
    keys = TR.round_keys(0, 0, 6)
    dk = TR.shard_round_keys(keys, 3)
    assert dk.shape == (3, 6) and dk.dtype == np.uint64
    rows = {int(k) for k in dk.reshape(-1)}
    assert len(rows) == 18 and not rows & set(keys)
    # resume: a pure function of (seed, round, device), at any device
    # count
    np.testing.assert_array_equal(
        dk[:, 4:], TR.shard_round_keys(TR.round_keys(0, 4, 2), 3))
    np.testing.assert_array_equal(dk[:2], TR.shard_round_keys(keys, 2))
    gens = [torch.Generator().manual_seed(int(k)) for k in dk[:, 0]]
    draws = [torch.randint(0, 1 << 30, (4,), generator=g) for g in gens]
    assert not torch.equal(draws[0], draws[1])


def test_pack_rows_round_trip_keeps_bools_and_alignment():
    rng = np.random.default_rng(3)
    parts = [torch.as_tensor(rng.integers(0, 9, (3,))),          # int64
             torch.as_tensor(rng.standard_normal((3, 5)).astype(np.float32)),
             torch.as_tensor(rng.standard_normal(7).astype(np.float32)),
             torch.as_tensor(rng.random((3, 5)) < 0.5)]
    packed = R.pack_rows(parts)
    assert packed.dtype == torch.uint8 and packed.numel() % 8 == 0
    stacked = torch.stack([packed, packed.clone()])      # a gathered pair
    for row in stacked:
        for got, want in zip(R.unpack_rows(row, parts), parts):
            assert got.dtype == want.dtype and torch.equal(got, want)
    with pytest.raises(ValueError, match="must not grow"):
        R.pack_rows(parts[::-1])


def test_global_sample_is_single_ring_oracle_sample():
    """``replay_sample_global`` through the oracle's collective is a
    sample of one ring fed every device's round batches in device-major
    round order: local slot ``s`` of device ``d`` holds the oracle's
    slot ``(s // n * D + d) * n + s % n`` (n the per-round write, cap a
    multiple of n), and every field (the bool masks too) matches JAX's
    ``replay_sample_global`` under a named ``vmap`` axis on the same
    indices."""
    Dn, cap, n, rounds, per_bs = 2, 12, 4, 5, 5
    rng = np.random.default_rng(4)
    pairs = [R.replay_pair_init(_ring(cap), n) for _ in range(Dn)]
    oracle = _ring(cap * Dn)
    for _ in range(rounds):                 # 20 writes/device > cap: wraps
        batches = [_batch(rng, n) for _ in range(Dn)]
        for p, b in zip(pairs, batches):
            R.replay_pair_step(p, _t(b))
        for b in batches:
            R.replay_add(oracle, _t(b))
    s = np.arange(cap)
    for d, p in enumerate(pairs):
        np.testing.assert_array_equal(
            p["read"]["r"].numpy(),
            oracle["r"].numpy()[(s // n * Dn + d) * n + s % n])
    idx = [torch.as_tensor(rng.integers(0, cap, per_bs)) for _ in range(Dn)]
    got = R.replay_sample_global([p["read"] for p in pairs], idx,
                                 TR.StackedShards(Dn))
    want = np.concatenate([(i.numpy() // n * Dn + d) * n + i.numpy() % n
                           for d, i in enumerate(idx)])
    for k in R.replay_fields(oracle):
        np.testing.assert_array_equal(got[k].numpy(), oracle[k].numpy()[want],
                                      err_msg=k)
    assert got["mask"].dtype == torch.bool and got["r"].shape == (Dn * per_bs,)
    # JAX's gather of the same rows: a ring whose randint draws are idx
    stacked = {k: jnp.stack([jnp.asarray(p["read"][k].numpy())
                             for p in pairs])
               for k in R.replay_fields(oracle)}
    jgot = jax.vmap(lambda b, i: jax.tree.map(
        lambda x: jax.lax.all_gather(x, "dev", axis=0, tiled=True),
        JR._gather(b, i)), axis_name="dev")(
        stacked, jnp.stack([jnp.asarray(i.numpy()) for i in idx]))
    for k in R.replay_fields(oracle):
        for d in range(Dn):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(jgot[k][d]), err_msg=k)
