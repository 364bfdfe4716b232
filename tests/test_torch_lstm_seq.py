"""The port's ``lstm_seq`` plain version and actor against the JAX
package's reference scan and Pallas kernel (interpret mode on the CPU,
as ``tests/test_kernels_lstm_seq.py`` runs it).

Inputs are drawn with NumPy from a seed and handed to both packages.
Tolerance atol = rtol = 2e-5, the float32 tolerance of the JAX kernel
tests: the same f32 arithmetic, summed in another order by another
matmul.  The CUDA kernel itself needs the card; ``chip_smoke.py`` holds
it against this plain version there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as P
from repro.kernels.lstm_seq import lstm_seq as jax_lstm_seq
from repro.kernels.lstm_seq import lstm_seq_ref as jax_lstm_seq_ref
from repro_torch.core.policy import Actor, PolicyConfig, actor_params_from_numpy
from repro_torch.kernels.lstm_seq import ops, lstm_seq_ref

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=2e-5)


def _args(T, B, F, H, seed=7):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((T, B, F)).astype(np.float32)
    mask = rng.uniform(size=(T, B)) < 0.8
    wx = (rng.standard_normal((F, 4 * H)) * 0.1).astype(np.float32)
    wh = (rng.standard_normal((H, 4 * H)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((4 * H,)) * 0.1).astype(np.float32)
    return xs, mask, wx, wh, b


def _port(args):
    return ops.lstm_seq(*(torch.as_tensor(a) for a in args)).numpy()


# the shapes of tests/test_kernels_lstm_seq.py
SHAPES = [(5, 4, 16, 64), (97, 16, 16, 256), (3, 130, 23, 128),
          (1, 1, 8, 32), (12, 33, 23, 64)]


@pytest.mark.parametrize("T,B,F,H", SHAPES)
def test_plain_matches_jax_ref(T, B, F, H):
    args = _args(T, B, F, H)
    want = np.asarray(jax_lstm_seq_ref(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(_port(args), want, **TOL)


@pytest.mark.parametrize("T,B,F,H", SHAPES)
def test_plain_matches_jax_pallas_kernel(T, B, F, H):
    args = _args(T, B, F, H, seed=11)
    want = np.asarray(jax_lstm_seq(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(_port(args), want, **TOL)


def tail_mask(kind, T, B, rows=4):
    """The kernel's tail cases: the rows of a tile (``rows`` consecutive
    rows) ending at different steps; a fully masked tile; rows unmasked
    again after a masked gap."""
    t = np.arange(T)[:, None]
    mask = np.ones((T, B), bool)
    if kind == "ends":
        mask = t < np.maximum(T - (np.arange(B) % 5) * (T // 5), 1)[None, :]
    elif kind == "dead_tile":
        lo = rows if B > rows else 0
        mask[:, lo:lo + rows] = False
    elif kind == "gap":
        gap = (t >= T // 3) & (t < 2 * T // 3)
        mask[:, ::2] = ~np.broadcast_to(gap, (T, B))[:, ::2]
    return mask


TAIL_SHAPES = [(12, 9, 16, 32), (20, 33, 23, 64), (15, 1, 8, 32)]


@pytest.mark.parametrize("kind", ["ends", "dead_tile", "gap"])
@pytest.mark.parametrize("T,B,F,H", TAIL_SHAPES)
def test_plain_matches_jax_on_tail_masks(T, B, F, H, kind):
    xs, _, wx, wh, b = _args(T, B, F, H, seed=13)
    args = (xs, tail_mask(kind, T, B), wx, wh, b)
    got = _port(args)
    jargs = [jnp.asarray(a) for a in args]
    for want in (jax_lstm_seq_ref(*jargs), jax_lstm_seq(*jargs)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    dead = ~args[1].any(0)
    np.testing.assert_array_equal(got[:, dead], 0.0)   # never-live rows
    last = T - 1 - np.argmax(args[1][::-1], axis=0)     # held after the end
    for r in np.flatnonzero(~dead):
        np.testing.assert_array_equal(got[last[r]:, r],
                                      np.broadcast_to(got[last[r], r],
                                                      (T - last[r], H)))


def test_masked_steps_hold_the_carry():
    """A fully masked step emits the held h; an all-false row stays 0."""
    xs, _, wx, wh, b = _args(6, 3, 8, 32)
    mask = np.array([[1, 0, 0], [0, 0, 1], [1, 0, 1], [0, 0, 0],
                     [1, 0, 1], [1, 0, 0]], bool)
    hs = _port((xs, mask, wx, wh, b))
    np.testing.assert_array_equal(hs[1, 0], hs[0, 0])
    np.testing.assert_array_equal(hs[3], hs[2])
    np.testing.assert_array_equal(hs[:, 1], 0.0)


def test_cpu_tensors_never_launch_the_kernel():
    before = ops.LAUNCHES
    _port(_args(4, 2, 8, 32))
    Actor(PolicyConfig(feat_dim=8, act_dim=3, hidden=32), device="cpu")(
        torch.zeros((2, 5, 8)), torch.ones((2, 5), dtype=torch.bool))
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("use_pallas", [False, True])
def test_actor_matches_jax_actor_apply(use_pallas):
    """Weights carried from the JAX actor; ragged masked tails."""
    F, G, H, T, B = 16, 7, 64, 9, 6
    cfg = P.PolicyConfig(feat_dim=F, act_dim=G, hidden=H,
                         use_pallas=use_pallas)
    params = P.init_actor(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((B, T, F)).astype(np.float32)
    lens = rng.integers(1, T + 1, size=B)
    mask = np.arange(T)[None, :] < lens[:, None]
    want = np.asarray(jax.vmap(P.actor_apply, in_axes=(None, None, 0, 0))(
        params, cfg, jnp.asarray(feats), jnp.asarray(mask)))
    tree = jax.tree.map(np.asarray, params)
    actor = actor_params_from_numpy(tree, device="cpu")
    assert actor.cfg == PolicyConfig(feat_dim=F, act_dim=G, hidden=H)
    got = actor(torch.as_tensor(feats), torch.as_tensor(mask)).numpy()
    assert got.shape == (B, T - 1, G)
    np.testing.assert_allclose(got, want, **TOL)


def test_actor_rejects_wrong_shapes():
    actor = Actor(PolicyConfig(feat_dim=8, act_dim=3, hidden=32),
                  device="cpu")
    tree = {"lstm": {"wx": np.zeros((8, 128)), "wh": np.zeros((32, 128)),
                     "b": np.zeros((128,))},
            "fc1": {"w": np.zeros((32, 16)), "b": np.zeros((16,))},
            "fc2": {"w": np.zeros((16, 4)), "b": np.zeros((4,))}}
    with pytest.raises(ValueError, match=r"\['fc2'\]"):
        actor.load_numpy(tree)

