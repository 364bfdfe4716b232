"""The decode kernel's split-and-merge arithmetic on the CPU.

``decode_gqa`` cuts each sequence's cache into runs of ``rows``
positions, keeps a float32 softmax state per run and merges the runs
with a log-sum-exp rescale.  ``decode_attention_split_ref`` does the
same in plain PyTorch; here it is held against the JAX package's
``decode_attention_ref`` and its Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it), with the kernels' tolerance
``attn_err`` (bf16: one ulp plus 1.5e-2 of the row's RMS, which covers
the reference's bf16 rounding of p where the split keeps it in float32;
float32: 1e-4).  ``split_plan`` must cover [0, S) exactly once.

Inputs are drawn with NumPy from a seed and handed to both packages.
Lengths are at least 1 against JAX (at length 0 the reference returns
the mean of V, the kernels zeros).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_gqa import decode_attention as jax_decode_pallas
from repro.kernels.decode_gqa import ref as jdec
from repro_torch.kernels.attn_tolerance import attn_err
from repro_torch.kernels.decode_gqa import ops as dec_ops
from repro_torch.kernels.decode_gqa import ref as dec

torch.set_num_threads(1)
H100_SMS = 132

# (B, Hq, Hkv, S, D, rows, lengths): ragged lengths that leave whole runs
# empty, length 1, length = S, one-row runs, group 16, D = 64
CASES = [
    (4, 4, 2, 600, 16, 64, [600, 5, 130, 64]),
    (2, 8, 4, 300, 64, 64, [1, 300]),
    (3, 4, 1, 33, 8, 1, [33, 1, 17]),
    (2, 16, 1, 200, 32, 64, [200, 65]),
    (1, 16, 16, 129, 64, 128, [129]),
    (2, 2, 2, 96, 16, None, [3, 96]),
]


def _inputs(B, Hq, Hkv, S, D, lengths, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, 1, D), (B, Hkv, S, D), (B, Hkv, S, D))]
    length = np.asarray(lengths, np.int32)
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
            + [jnp.asarray(length)],
            [torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrs]
            + [torch.as_tensor(length)])


def _to_torch(x, dtype):
    return torch.as_tensor(np.array(jnp.asarray(x, jnp.float32))).to(
        getattr(torch, dtype))


def _rows(B, Hkv, S, rows):
    return rows if rows is not None else \
        dec_ops.split_plan(B, Hkv, S, H100_SMS)[1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,D,rows,lengths", CASES)
def test_split_merge_matches_jax_ref(B, Hq, Hkv, S, D, rows, lengths, dtype):
    j, t = _inputs(B, Hq, Hkv, S, D, lengths, dtype)
    got = dec.decode_attention_split_ref(*t, _rows(B, Hkv, S, rows))
    want = _to_torch(jdec.decode_attention_ref(*j), dtype)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert attn_err(got, want)[1] <= 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,D,rows,lengths", CASES)
def test_split_merge_matches_jax_pallas_kernel(B, Hq, Hkv, S, D, rows,
                                               lengths, dtype):
    j, t = _inputs(B, Hq, Hkv, S, D, lengths, dtype, seed=1)
    got = dec.decode_attention_split_ref(*t, _rows(B, Hkv, S, rows))
    want = _to_torch(jax_decode_pallas(*j, block_k=32, interpret=True), dtype)
    assert attn_err(got, want)[1] <= 1.0


def test_split_merge_of_an_empty_row_is_zeros():
    """Length 0 gives zeros, as in the kernels (the reference gives the
    mean of V), and leaves the other rows as they were."""
    _, t = _inputs(2, 4, 2, 70, 16, [0, 70], "float32", seed=2)
    got = dec.decode_attention_split_ref(*t, 32)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    want = dec.decode_attention_ref(*t)
    assert attn_err(got[1:], want[1:])[1] <= 1.0


@pytest.mark.parametrize("rows", [1, 7, 64, 1000])
def test_split_merge_does_not_depend_on_the_run_length(rows):
    """Any cut of the cache gives the unsplit softmax, to float32
    rounding."""
    _, t = _inputs(3, 8, 2, 333, 32, [333, 1, 200], "float32", seed=3)
    got = dec.decode_attention_split_ref(*t, rows)
    want = dec.decode_attention_naive(*t)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=2e-5)


@pytest.mark.parametrize("B", [1, 4, 16, 128])
@pytest.mark.parametrize("Hkv", [1, 8, 32])
@pytest.mark.parametrize("S", [1, 63, 65, 512, 2176, 32768])
def test_split_plan_covers_the_cache_once(B, Hkv, S):
    n_split, rows = dec_ops.split_plan(B, Hkv, S, H100_SMS)
    assert rows % dec_ops.ROW_QUANTUM == 0 and rows <= dec_ops.MAX_ROWS
    covered = np.zeros(S, np.int64)
    for i in range(n_split):
        covered[i * rows:min((i + 1) * rows, S)] += 1
    assert (covered == 1).all()
    assert (n_split - 1) * rows < S     # no run starts past the cache


def test_split_plan_fills_the_card_at_the_decode_shape():
    """internlm2-1.8b decode (B, Hkv, S) = (4, 8, 2176): at least two
    blocks per SM, all resident at once (one wave of BLOCKS_PER_SM), runs
    of at most 256 rows; a 32768-slot cache is cut into runs of
    MAX_ROWS."""
    n_split, rows = dec_ops.split_plan(4, 8, 2176, H100_SMS)
    blocks = n_split * 8 * 4
    assert 2 * H100_SMS <= blocks <= dec_ops.BLOCKS_PER_SM * H100_SMS
    assert rows <= 256
    assert dec_ops.split_plan(4, 8, 32768, H100_SMS) == (32, 1024)
    assert dec_ops.split_plan(16, 8, 512, H100_SMS)[0] >= 2
