"""The port's optimizers and LR schedules (``repro_torch.optim``)
against ``repro.optim`` on the same NumPy-drawn gradients.

Tolerances: the schedules within one float32 ulp (2**-23) of the value
plus one of ``peak``: the same float32 arithmetic, but XLA's and
PyTorch's float32 cosine round differently in the last place, and the
schedule scales cos by (peak - floor) / 2;
``global_norm`` / ``clip_by_norm`` within 1e-6 relative
(float32 sums in another order); three updates of AdamW (float32 and
bfloat16 moments) and Adafactor within 1e-6 of each element's magnitude
plus 1e-6 of its leaf's largest (float32 arithmetic in another order of
fusion).
bfloat16 moments within one bf16 ulp (2**-8 relative): each is one
rounding of float32 values that agree to 1e-6, which lands on the
other side of a rounding boundary now and then (2 of 34,816 elements
in the third update), and each of the three updates starts from the
reference's parameters and moments, since an element whose moment is
one ulp off moves by ~1e-3 of lr in the next update.  The
reference's quadratic-convergence cases (``tests/test_optim.py``) run
on the port alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as J
from repro_torch import optim as T
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)
ULP = 2.0 ** -23


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


def _close_trees(got, want, rtol=1e-6):
    """Each element within ``rtol`` of its magnitude plus ``rtol`` of
    its leaf's largest magnitude."""
    g_leaves = tree_leaves(got)
    w_leaves = jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * float(np.abs(w).max()))


@pytest.mark.parametrize("kind", ["cosine", "wsd"])
@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 100, 10_000),
                                               (1.0, 10, 100),
                                               (3e-3, 1, 60),
                                               (2.0, 0, 37)])
def test_schedules_match_jax(kind, peak, warmup, total):
    steps = list(range(0, total + 5)) + [total * 3]
    fn = {"cosine": (T.cosine_lr, J.cosine_lr),
          "wsd": (T.wsd_lr, J.wsd_lr)}[kind]
    for s in steps:
        got = fn[0](s, peak=peak, warmup=warmup, total=total)
        want = fn[1](s, peak=peak, warmup=warmup, total=total)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=ULP,
                                   atol=ULP * peak)
    for s in (0, 5, warmup, total // 2, total - 1):
        got = T.make_schedule(kind, peak=peak, warmup=max(1, warmup),
                              total=total)(s)
        want = J.make_schedule(kind, peak=peak, warmup=max(1, warmup),
                               total=total)(s)
        np.testing.assert_allclose(float(got), float(want), rtol=ULP,
                                   atol=ULP * peak)


def _tree(rng, dtype=np.float32):
    """A parameter-like tree: a factored 2-D leaf, a stacked 3-D leaf
    (layers first, as the LM's), a vector and a short matrix."""
    return {"embed": rng.standard_normal((160, 128)).astype(dtype),
            "stack": {"w": (rng.standard_normal((2, 128, 136)) * 0.1
                            ).astype(dtype),
                      "scale": np.ones((2, 64), dtype)},
            "b": rng.standard_normal((7,)).astype(dtype)}


def _both(tree, dtype=torch.float32):
    return (jax.tree.map(jnp.asarray, tree),
            {k: _both(v, dtype)[1] if isinstance(v, dict)
             else torch.as_tensor(np.array(v)).to(dtype)
             for k, v in tree.items()})


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(0)
    jt, tt = _both(_tree(rng))
    np.testing.assert_allclose(float(T.global_norm(tt)),
                               float(J.global_norm(jt)), rtol=1e-6)
    for max_norm in (1.0, 1e3):
        got, gn = T.clip_by_norm(tt, max_norm)
        want, wn = J.clip_by_norm(jt, max_norm)
        np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
        _close_trees(got, want)


@pytest.mark.parametrize("name", ["adamw-f32", "adamw-bf16", "adafactor",
                                  "adamw-decay"])
def test_three_updates_match_jax(name):
    rng = np.random.default_rng(1)
    if name == "adafactor":
        jopt, topt = J.adafactor(), T.adafactor()
    elif name == "adamw-decay":
        jopt, topt = J.adamw(), T.adamw()
    else:
        bf = name.endswith("bf16")
        jopt = J.adamw(weight_decay=0.0,
                       moment_dtype=jnp.bfloat16 if bf else jnp.float32)
        topt = T.adamw(weight_decay=0.0,
                       moment_dtype=torch.bfloat16 if bf else torch.float32)
    jp, tp = _both(_tree(rng))
    js, ts = jopt.init(jp), topt.init(tp)
    _close_trees(ts, js, rtol=0)
    for step in range(3):
        g = jax.tree.map(lambda x: x * (1.0 + step), _tree(rng))
        jg, tg = _both(g)
        lr = 1e-2 * (step + 1)
        jp, js, jn = jopt.update(jg, js, jp, jnp.asarray(step),
                                 jnp.asarray(lr, jnp.float32))
        tp, ts, tn = topt.update(tg, ts, tp, step,
                                 torch.tensor(lr, dtype=torch.float32))
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _close_trees(tp, jp)
        if name != "adamw-bf16":
            _close_trees(ts, js)
            continue
        _close_trees(ts, js, rtol=2.0 ** -8)
        # a moment one bf16 ulp off moves the next update of its element
        # by ~1e-3 of lr: each update starts from the reference's state
        tp = _both(jax.tree.map(np.asarray, jp))[1]
        ts = jax.tree.map(lambda x: torch.as_tensor(
            np.asarray(x, np.float32)).to(torch.bfloat16), js)


def test_adafactor_factors_as_the_reference():
    """A leaf is factored when its last two dims are both >= 128: the
    state's leaves and shapes equal the reference's."""
    rng = np.random.default_rng(2)
    jp, tp = _both(_tree(rng))
    js, ts = J.adafactor().init(jp), T.adafactor().init(tp)
    assert set(ts["embed"]) == {"v_row", "v_col"}
    assert set(ts["stack"]["w"]) == {"v_row", "v_col"}
    assert set(ts["b"]) == {"v"} and set(ts["stack"]["scale"]) == {"v"}
    assert [tuple(x.shape) for x in tree_leaves(ts)] == \
        [tuple(x.shape) for x in jax.tree.leaves(js)]


def test_adamw_updates_a_bf16_parameter_in_float32():
    """A bf16 parameter with bf16 moments: the update is computed in
    float32 and cast back, as the reference's."""
    rng = np.random.default_rng(3)
    p = rng.standard_normal((32, 16)).astype(np.float32)
    g = rng.standard_normal((32, 16)).astype(np.float32)
    jp = {"w": jnp.asarray(p, jnp.bfloat16)}
    tp = {"w": torch.as_tensor(p).to(torch.bfloat16)}
    jopt = J.adamw(moment_dtype=jnp.bfloat16)
    topt = T.make_optimizer("adamw", moment_dtype="bfloat16")
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        jp, js, _ = jopt.update({"w": jnp.asarray(g, jnp.bfloat16)}, js, jp,
                                jnp.asarray(step), jnp.asarray(3e-2))
        tp, ts, _ = topt.update({"w": torch.as_tensor(g).to(torch.bfloat16)},
                                ts, tp, step, 3e-2)
        assert tp["w"].dtype == torch.bfloat16
        assert ts["m"]["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(tp["w"].float().numpy(),
                                      _np(jp["w"]))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_donated_update_writes_in_place_with_the_same_values(name):
    """The update writes each leaf into the parameter and state tensors
    it was given, as the reference's driver donates them, and the values
    are the reference's (within 1e-6 relative)."""
    rng = np.random.default_rng(4)
    jopt, opt = {"adamw": (J.adamw(), T.adamw()),
                 "adafactor": (J.adafactor(), T.adafactor())}[name]
    jp, p = _both(_tree(rng))
    jg, g = _both(_tree(rng))
    js, st = jopt.init(jp), opt.init(p)
    old_p, old_s = tree_leaves(p), tree_leaves(st)
    got_p, got_s, got_n = opt.update(g, st, p, 2, 1e-2)
    want_p, want_s, want_n = jopt.update(jg, js, jp, jnp.asarray(2),
                                         jnp.asarray(1e-2, jnp.float32))
    assert all(a is b for a, b in zip(tree_leaves(got_p), old_p))
    assert all(a is b for a, b in zip(tree_leaves(got_s), old_s))
    np.testing.assert_allclose(float(got_n), float(want_n), rtol=1e-6)
    _close_trees(got_p, want_p)
    _close_trees(got_s, want_s)


def test_make_optimizer_dispatch():
    assert T.make_optimizer("adafactor").name == "adafactor"
    assert T.make_optimizer("adamw").name == "adamw"
    st = T.make_optimizer("adamw", moment_dtype="bfloat16").init(
        {"w": torch.zeros(3)})
    assert st["m"]["w"].dtype == torch.bfloat16


# ---------------------------------------------------- the reference's cases
def _quadratic_converges(opt, steps=200, lr=0.05):
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor([1.5])}
    state = opt.init(params)
    for t in range(steps):
        g = {k: 2 * v for k, v in params.items()}
        params, state, _ = opt.update(g, state, params, t, lr)
    return float(sum(torch.sum(v ** 2) for v in params.values()))


def test_adamw_converges_quadratic():
    assert _quadratic_converges(T.adamw(weight_decay=0.0)) < 1e-3


def test_adafactor_converges_quadratic():
    assert _quadratic_converges(T.adafactor()) < 1e-2


def test_adamw_bf16_moments_still_converge():
    o = T.adamw(weight_decay=0.0, moment_dtype=torch.bfloat16)
    assert _quadratic_converges(o) < 1e-2


def test_adafactor_factored_state_is_small():
    state = T.adafactor(min_dim=4).init({"w": torch.zeros((256, 512))})
    assert sum(x.numel() for x in tree_leaves(state)) == 256 + 512


def test_clip_by_norm():
    clipped, norm = T.clip_by_norm({"a": torch.tensor([3.0, 4.0])}, 1.0)
    assert float(norm) == pytest.approx(5.0)
    assert float(T.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


def test_cosine_schedule_shape():
    lrs = [float(T.cosine_lr(s, peak=1.0, warmup=10, total=100))
           for s in range(100)]
    assert lrs[0] > 0                            # nonzero at step 0
    assert max(lrs) == pytest.approx(1.0, rel=0.05)
    assert lrs[-1] < 0.2 and lrs[-1] >= 0.099    # decays to the floor


def test_wsd_schedule_plateau_then_decay():
    lrs = [float(T.wsd_lr(s, peak=1.0, warmup=10, total=100))
           for s in range(100)]
    assert all(abs(v - 1.0) < 1e-6 for v in lrs[20:85])   # stable leg
    assert lrs[-1] < 0.05                                # sharp decay leg


def test_make_schedule_dispatch():
    assert float(T.make_schedule("wsd", peak=2.0)(500)) == pytest.approx(2.0)
    assert float(T.make_schedule("cosine", peak=2.0)(0)) < 2.0
