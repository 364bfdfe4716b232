"""The port's plain attention versions against the JAX package's oracles
and Pallas kernels (interpret mode on the CPU, as
``tests/test_kernels.py`` runs them).

Inputs are drawn with NumPy from a seed and handed to both packages.
Tolerances:

- float32: atol = rtol = 2e-5 (the same float32 arithmetic, summed in
  another order by another matmul);
- bfloat16 outputs: atol = rtol = 1.6e-2 (two bf16 ulps at |x| < 1: the
  outputs are rounded to bf16 once, and an f32 sum in another order may
  land on the other side of a rounding boundary); the bf16
  ``attention_naive`` computes scores and softmax in bf16 itself and
  gets atol = rtol = 4e-2.

Decode lengths are drawn in [1, S]: at length 0 the reference and the
TPU kernel disagree (the mean of V against zeros), and the model path
never asks for it.  The CUDA kernels need the card; ``chip_smoke.py``
and ``tests/test_torch_kernels_gpu.py`` hold them against these plain
versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_gqa import decode_attention as jax_decode_pallas
from repro.kernels.decode_gqa import ref as jdec
from repro.kernels.flash_attention import flash_attention as jax_flash_pallas
from repro.kernels.flash_attention import ref as jattn
from repro_torch.kernels.attn_tolerance import attn_err
from repro_torch.kernels.decode_gqa import ops as dec_ops
from repro_torch.kernels.decode_gqa import ref as dec
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as attn

torch.set_num_threads(1)
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=1.6e-2, rtol=1.6e-2)}
NAIVE_BF16_TOL = dict(atol=4e-2, rtol=4e-2)

# (B, Hq, Hkv, S, D, causal, window): GQA and MHA, causal, sliding
# window, non-causal, odd S, and an S over the port's 512-row query
# block (a ragged last block)
PREFILL = [(2, 4, 2, 37, 16, True, 0), (1, 4, 4, 130, 32, True, 0),
           (2, 4, 1, 64, 16, True, 16), (1, 2, 2, 75, 16, False, 0),
           (1, 6, 2, 97, 8, True, 30), (2, 4, 2, 40, 16, False, 9),
           (1, 2, 1, 600, 8, True, 0)]
DECODE = [(3, 4, 2, 50, 16), (2, 4, 4, 129, 32), (2, 8, 1, 33, 8),
          (4, 4, 2, 600, 16)]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t2np(x):
    return x.float().numpy()


def _prefill_inputs(B, Hq, Hkv, S, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D))]
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrs],
            [torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrs])


def _decode_inputs(B, Hq, Hkv, S, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, 1, D), (B, Hkv, S, D), (B, Hkv, S, D))]
    length = rng.integers(1, S + 1, size=B).astype(np.int32)
    length[0] = S                          # one full row, the rest ragged
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
            + [jnp.asarray(length)],
            [torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrs]
            + [torch.as_tensor(length)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,D,causal,window", PREFILL)
def test_attention_chunked_matches_jax(B, Hq, Hkv, S, D, causal, window,
                                       dtype):
    j, t = _prefill_inputs(B, Hq, Hkv, S, D, dtype)
    want = jattn.attention_chunked(*j, causal=causal, window=window,
                                   block_q=32)
    got = attn.attention_chunked(*t, causal=causal, window=window)
    assert got.dtype == t[0].dtype and got.shape == t[0].shape
    np.testing.assert_allclose(_t2np(got), _np(want), **TOL[dtype])
    # the wrapper takes the plain version for CPU tensors, no launch
    before = fa_ops.LAUNCHES
    np.testing.assert_array_equal(
        _t2np(fa_ops.flash_attention(*t, causal=causal, window=window)),
        _t2np(attn.attention_chunked(*t, causal=causal, window=window)))
    assert fa_ops.LAUNCHES == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,D,causal,window", PREFILL)
def test_attention_naive_matches_jax(B, Hq, Hkv, S, D, causal, window,
                                     dtype):
    j, t = _prefill_inputs(B, Hq, Hkv, S, D, dtype, seed=1)
    want = jattn.attention_naive(*j, causal=causal, window=window)
    got = attn.attention_naive(*t, causal=causal, window=window)
    tol = TOL[dtype] if dtype == "float32" else NAIVE_BF16_TOL
    np.testing.assert_allclose(_t2np(got), _np(want), **tol)


# The reference wrapper pads S with zero keys and only causal masking
# hides them, so non-causal inputs with a ragged S are left out here;
# so is the long case, slow through the interpreter.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,D,causal,window",
                         [c for c in PREFILL if c[5] and c[3] <= 512])
def test_attention_chunked_matches_jax_pallas_kernel(B, Hq, Hkv, S, D,
                                                     causal, window, dtype):
    j, t = _prefill_inputs(B, Hq, Hkv, S, D, dtype, seed=2)
    want = jax_flash_pallas(*j, causal=causal, window=window,
                            block_q=32, block_k=32, interpret=True)
    got = attn.attention_chunked(*t, causal=causal, window=window)
    np.testing.assert_allclose(_t2np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", DECODE)
def test_decode_attention_matches_jax(B, Hq, Hkv, S, D, dtype):
    j, t = _decode_inputs(B, Hq, Hkv, S, D, dtype)
    want = jdec.decode_attention_ref(*j)
    got = dec.decode_attention_ref(*t)
    assert got.dtype == t[0].dtype and got.shape == t[0].shape
    np.testing.assert_allclose(_t2np(got), _np(want), **TOL[dtype])
    np.testing.assert_allclose(_t2np(dec.decode_attention_naive(*t)),
                               _np(jdec.decode_attention_naive(*j)),
                               **TOL[dtype])
    before = dec_ops.LAUNCHES
    np.testing.assert_array_equal(_t2np(dec_ops.decode_attention(*t)),
                                  _t2np(got))
    assert dec_ops.LAUNCHES == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", DECODE)
def test_decode_attention_matches_jax_pallas_kernel(B, Hq, Hkv, S, D, dtype):
    j, t = _decode_inputs(B, Hq, Hkv, S, D, dtype, seed=3)
    want = jax_decode_pallas(*j, block_k=32, interpret=True)
    got = dec.decode_attention_ref(*t)
    np.testing.assert_allclose(_t2np(got), _np(want), **TOL[dtype])


def test_decode_is_prefill_row():
    """The last row of causal prefill attention is decode attention of
    the last query against the whole sequence."""
    _, (q, k, v) = _prefill_inputs(2, 4, 2, 45, 16, "float32", seed=4)
    full = attn.attention_chunked(q, k, v, causal=True)
    last = dec.decode_attention_ref(q[:, :, -1:], k, v,
                                    torch.tensor([45, 45]))
    np.testing.assert_allclose(_t2np(last), _t2np(full[:, :, -1:]),
                               **TOL["float32"])


# (B, Hq, Hkv, Sq, Sk, D): non-causal calls with other key counts, as
# Whisper's cross-attention (queries from the tokens, keys from the
# encoder frames): more keys, a ragged Sk over the 512-row block, fewer
# keys, GQA
CROSS = [(2, 4, 4, 5, 40, 16), (1, 6, 6, 77, 600, 16), (2, 4, 2, 33, 7, 8),
         (1, 8, 2, 3, 150, 32)]


def _cross_inputs(B, Hq, Hkv, Sq, Sk, D, dtype, seed=7):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))]
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrs],
            [torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrs])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D", CROSS)
def test_attention_chunked_takes_other_key_counts(B, Hq, Hkv, Sq, Sk, D,
                                                  dtype):
    """Non-causal Sq != Sk against the JAX package's oracles (its model
    calls ``attention_chunked`` so for cross-attention), and the
    wrapper's plain version for CPU tensors, with no launch."""
    j, t = _cross_inputs(B, Hq, Hkv, Sq, Sk, D, dtype)
    want = jattn.attention_chunked(*j, causal=False, block_q=32)
    got = attn.attention_chunked(*t, causal=False)
    assert got.dtype == t[0].dtype and got.shape == t[0].shape
    np.testing.assert_allclose(_t2np(got), _np(want), **TOL[dtype])
    tol = TOL[dtype] if dtype == "float32" else NAIVE_BF16_TOL
    np.testing.assert_allclose(_t2np(attn.attention_naive(*t, causal=False)),
                               _np(jattn.attention_naive(*j, causal=False)),
                               **tol)
    before = fa_ops.LAUNCHES
    np.testing.assert_array_equal(
        _t2np(fa_ops.flash_attention(*t, causal=False)), _t2np(got))
    assert fa_ops.LAUNCHES == before


def test_causal_with_other_key_counts_is_refused():
    """The plain versions disagree on causal Sq != Sk (``attention_naive``
    aligns the ends, ``attention_chunked`` the starts) and the model
    never asks for it: the wrapper raises on the CPU as on the card."""
    _, (q, k, v) = _cross_inputs(1, 2, 2, 6, 9, 16, "float32")
    na = attn.attention_naive(q, k, v, causal=True)
    ch = attn.attention_chunked(q, k, v, causal=True)
    assert not torch.allclose(na, ch, atol=1e-3)
    with pytest.raises(ValueError, match="Sq=6, Sk=9"):
        fa_ops.flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="must be"):
        fa_ops.flash_attention(q, k, v[:, :, :-1], causal=False)


def test_wrappers_reject_other_devices():
    _, (q, k, v) = _prefill_inputs(1, 2, 1, 8, 16, "float32")
    with pytest.raises(ValueError, match="unsupported device"):
        fa_ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        dec_ops.decode_attention(q[:, :, :1].to("meta"), k.to("meta"),
                                 v.to("meta"), torch.ones(1, device="meta"))


# The card's check (``attn_err <= 1``) on stand-ins for a kernel at the
# chip's decode shapes with B cut to 1-2: the float32-p plain version
# (what the kernel computes) passes against the bf16-p reference, and a
# version that drops the last key, or an 8-key chunk mid-row, fails.
@pytest.mark.parametrize("B,Hq,Hkv,S,D,L", [(1, 16, 8, 2176, 128, 2112),
                                            (2, 16, 8, 64, 128, 40)])
def test_attention_tolerance_passes_rounding_and_catches_dropped_keys(
        B, Hq, Hkv, S, D, L):
    _, (q, k, v, _) = _decode_inputs(B, Hq, Hkv, S, D, "bfloat16", seed=5)
    length = torch.full((B,), L, dtype=torch.int32)
    want = dec.decode_attention_ref(q, k, v, length)
    assert attn_err(dec.decode_attention_naive(q, k, v, length), want)[1] \
        <= 1.0
    assert attn_err(dec.decode_attention_ref(q, k, v, length - 1),
                    want)[1] > 1.0
    a = L // 2
    cut = [torch.cat([x[:, :, :a], x[:, :, a + 8:]], dim=2) for x in (k, v)]
    assert attn_err(dec.decode_attention_ref(q, *cut, length - 8),
                    want)[1] > 1.0


def test_attention_tolerance_catches_a_dropped_diagonal_key():
    """Prefill rows that skip their own (last visible) key fail."""
    _, (q, k, v) = _prefill_inputs(1, 2, 1, 512, 128, "bfloat16", seed=6)
    want = attn.attention_chunked(q, k, v, causal=True)
    # query i + 1 against keys 0..i: every row but the first loses its
    # diagonal key
    short = attn.attention_chunked(q[:, :, 1:].contiguous(), k[:, :, :-1],
                                   v[:, :, :-1], causal=True)
    assert attn_err(want, want)[1] == 0.0
    assert attn_err(short, want[:, :, 1:])[1] > 1.0
