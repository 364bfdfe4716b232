"""The port's SSD (``repro_torch.kernels.ssd_chunk``) against the JAX
package's oracles and its Pallas route (``ops.ssd_forward``, the
intra-chunk kernel in interpret mode on the CPU, as
``tests/test_kernels.py`` runs it).

Inputs are drawn with NumPy from a seed and handed to both packages, in
two draws:
- "kernels": as ``tests/test_kernels.py`` draws them
  (dt = softplus(N(0,1)) * 0.5, A = -exp(0.3 N(0,1))), so decays stay
  far above exp(-60) across a chunk;
- "model": the model's own range (A = -linspace(1, 16, H) as
  ``ssm_init`` sets it, dt = softplus(N(0,1) + 1)), which drives the
  cumulative decay past the -60 clip within a chunk.

Tolerances (float32 throughout), with atol scaled by the largest
|want| (at least 1):
- the port against the same JAX algorithm (the same chunking): 2e-5,
  float32 sums in another order (~1e-6 seen).  In the "model" draw
  1e-4: there the cumulative decay within a chunk reaches |cum| ~ 3e3,
  and cum_i - cum_j carries the cumsum's rounding, |cum| * 2**-24 ~
  2e-4 in the exponent, which depends on the order XLA and PyTorch sum
  in (3e-6 of the largest |y| seen);
- a chunked route against the sequential scan: atol = 5e-4, rtol =
  1e-3, as ``tests/test_kernels.py`` holds the JAX routes to each other
  (the chunked form sums the same terms in another grouping).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunk import ops as jops
from repro.kernels.ssd_chunk import ref as jref
from repro.kernels.ssd_chunk.ssd_chunk import ssd_intra_pallas
from repro_torch.kernels.ssd_chunk import ops, ref

torch.set_num_threads(1)
SAME = {"kernels": 2e-5, "model": 1e-4}
SCAN = dict(atol=5e-4, rtol=1e-3)
# (B, T, H, P, N, chunk): tests/test_kernels.py's shapes, T = 100 padded
SHAPES = [(2, 64, 4, 16, 32, 16), (1, 128, 8, 64, 128, 64),
          (2, 100, 2, 32, 64, 32)]


def _draw(B, T, H, P, N, kind="kernels", seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f(B, T, H, P) * 0.5
    if kind == "kernels":
        dt = np.logaddexp(f(B, T, H), 0.0).astype(np.float32) * 0.5
        A = -np.exp(f(H) * 0.3)
    else:
        dt = np.logaddexp(f(B, T, H) + 1.0, 0.0).astype(np.float32)
        A = -np.linspace(1.0, 16.0, H, dtype=np.float32)
    Bm, Cm = f(B, T, N) * 0.3, f(B, T, N) * 0.3
    return [np.asarray(a, np.float32) for a in (x, dt, A, Bm, Cm)]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(arrs):
    return [torch.as_tensor(a) for a in arrs]


def _same(got, want, kind="kernels"):
    """The port against the same JAX algorithm (module docstring)."""
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    tol = SAME[kind]
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


def _intra_inputs(BC, C, N, H, P, kind, seed=1):
    """Kernel-level inputs, cum as an inclusive cumsum of dt * A."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    cm, bm = f(BC, C, N) * 0.3, f(BC, C, N) * 0.3
    xdt = f(BC, H, C, P) * 0.25
    if kind == "kernels":
        la = -np.logaddexp(f(BC, H, C), 0.0) * 0.5 * np.exp(f(H) * 0.3
                                                            )[None, :, None]
    else:
        la = -np.logaddexp(f(BC, H, C) + 1.0, 0.0) * np.linspace(
            1.0, 16.0, H)[None, :, None]
    cum = np.cumsum(la, axis=-1).astype(np.float32)
    return [np.asarray(a, np.float32) for a in (cm, bm, xdt, cum)]


@pytest.mark.parametrize("kind", ["kernels", "model"])
@pytest.mark.parametrize("BC,C,N,H,P", [(4, 16, 32, 4, 16),
                                        (2, 64, 128, 3, 64),
                                        (3, 32, 16, 5, 32)])
def test_ssd_intra_ref_matches_the_pallas_kernel(BC, C, N, H, P, kind):
    arrs = _intra_inputs(BC, C, N, H, P, kind)
    if kind == "model":
        assert arrs[3].min() < -60.0          # the clip is reached
    want = ssd_intra_pallas(*_j(arrs), interpret=True)
    got = ref.ssd_intra_ref(*_t(arrs))
    assert got.shape == (BC, H, C, P) and got.dtype == torch.float32
    _same(got, want, kind)


def test_ssd_intra_on_cpu_is_the_plain_version():
    arrs = _t(_intra_inputs(2, 16, 8, 3, 16, "kernels"))
    before = ops.LAUNCHES
    torch.testing.assert_close(ops.ssd_intra(*arrs), ref.ssd_intra_ref(*arrs),
                               atol=0, rtol=0)
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("kind", ["kernels", "model"])
@pytest.mark.parametrize("B,T,H,P,N,chunk", SHAPES)
def test_ssd_forward_matches_jax(B, T, H, P, N, chunk, kind):
    arrs = _draw(B, T, H, P, N, kind)
    y, S = ops.ssd_forward(*_t(arrs), chunk=chunk)
    assert y.shape == (B, T, H, P) and S.shape == (B, H, N, P)
    jy, jS = jops.ssd_forward(*_j(arrs), chunk=chunk)     # Pallas, interpret
    _same(y, jy, kind)
    _same(S, jS, kind)
    sy, sS = jref.ssd_scan_ref(*_j(arrs))
    np.testing.assert_allclose(y.numpy(), np.asarray(sy), **SCAN)
    np.testing.assert_allclose(S.numpy(), np.asarray(sS), **SCAN)
    if T % chunk == 0:
        cy, cS = jref.ssd_chunked_ref(*_j(arrs), chunk=chunk)
        _same(y, cy, kind)
        _same(S, cS, kind)


@pytest.mark.parametrize("B,T,H,P,N,chunk", [s for s in SHAPES
                                             if s[1] % s[5] == 0])
def test_ssd_chunked_ref_matches_jax(B, T, H, P, N, chunk):
    arrs = _draw(B, T, H, P, N, "model", seed=2)
    y, S = ref.ssd_chunked_ref(*_t(arrs), chunk=chunk)
    jy, jS = jref.ssd_chunked_ref(*_j(arrs), chunk=chunk)
    _same(y, jy, "model")
    _same(S, jS, "model")


@pytest.mark.parametrize("kind", ["kernels", "model"])
def test_ssd_scan_ref_matches_jax(kind):
    arrs = _draw(2, 40, 3, 16, 32, kind, seed=3)
    init = np.random.default_rng(4).standard_normal(
        (2, 3, 32, 16)).astype(np.float32)
    y, S = ref.ssd_scan_ref(*_t(arrs), init_state=torch.as_tensor(init))
    jy, jS = jref.ssd_scan_ref(*_j(arrs), init_state=jnp.asarray(init))
    _same(y, jy, kind)
    _same(S, jS, kind)


def test_ssd_decode_step_matches_jax():
    """Token by token from a random state: equal to JAX at every step,
    and together equal to the scan."""
    B, T, H, P, N = 2, 8, 4, 16, 32
    x, dt, A, Bm, Cm = _draw(B, T, H, P, N, "kernels", seed=5)
    state = np.random.default_rng(6).standard_normal(
        (B, H, N, P)).astype(np.float32)
    js, ts = jnp.asarray(state), torch.as_tensor(state)
    for t in range(T):
        args = (x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t])
        js, jy = jref.ssd_decode_step(js, *_j(args))
        ts, y = ref.ssd_decode_step(ts, *_t(args))
        _same(y, jy)
        _same(ts, js)
    sy, sS = jref.ssd_scan_ref(*_j((x, dt, A, Bm, Cm)),
                               init_state=jnp.asarray(state))
    np.testing.assert_allclose(ts.numpy(), np.asarray(sS), **SCAN)


@pytest.mark.parametrize("chunk,h", [(16, 32), (16, 37)])
def test_ssd_state_carry_across_calls(chunk, h):
    """A prefill of the first h tokens, then a second call from its
    final state, equals one call over all T (port and JAX); h = 37 pads
    the first call."""
    B, T, H, P, N = 1, 64, 2, 16, 32
    x, dt, A, Bm, Cm = _t(_draw(B, T, H, P, N, "kernels", seed=7))
    y_full, S_full = ops.ssd_forward(x, dt, A, Bm, Cm, chunk=chunk)
    y1, S1 = ops.ssd_forward(x[:, :h], dt[:, :h], A, Bm[:, :h], Cm[:, :h],
                             chunk=chunk)
    y2, S2 = ops.ssd_forward(x[:, h:], dt[:, h:], A, Bm[:, h:], Cm[:, h:],
                             init_state=S1, chunk=chunk)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), **SCAN)
    np.testing.assert_allclose(S2.numpy(), S_full.numpy(), **SCAN)
    jx, jdt, jA, jB, jC = (jnp.asarray(a.numpy()) for a in (x, dt, A, Bm, Cm))
    _, jS1 = jops.ssd_forward(jx[:, :h], jdt[:, :h], jA, jB[:, :h],
                              jC[:, :h], chunk=chunk)
    jy2, jS2 = jops.ssd_forward(jx[:, h:], jdt[:, h:], jA, jB[:, h:],
                                jC[:, h:], init_state=jS1, chunk=chunk)
    _same(y2, jy2)
    _same(S2, jS2)


def test_ssd_err_flags_a_dropped_tile():
    """The kernel's check passes the plain version against itself and
    fails on an output whose first column tile is dropped."""
    cm, bm, xdt, cum = _t(_intra_inputs(2, 64, 32, 3, 16, "kernels"))
    want = ref.ssd_intra_ref(cm, bm, xdt, cum)
    assert ref.ssd_err(want, want)[1] == 0.0
    bad = ref.ssd_intra_ref(cm, bm, xdt.clone().index_fill_(2, torch.arange(
        16), 0.0), cum)
    assert ref.ssd_err(bad, want)[1] > 10.0
