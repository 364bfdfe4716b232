"""The port's CUDA kernels against their plain versions on the card.

Needs a CUDA card (and ``nvcc`` to build the kernels): every test
carries the ``gpu`` marker and skips without one.  No JAX here, so the
file runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances: ``lstm_seq`` atol = rtol = 1e-4 (float32 sums in another
order over up to 97 recurrent steps); the attention kernels each element
within ``repro_torch.kernels.attn_tolerance`` (one bf16 ulp plus 1.5e-2
of the row's RMS in bfloat16, 1e-4 of both in float32).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.attn_tolerance import attn_err
from repro_torch.kernels.decode_gqa import ops as dec_ops
from repro_torch.kernels.decode_gqa import ref as dec_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.lstm_seq import lstm_seq_ref, ops

torch.set_num_threads(1)


def _args(T, B, F, H, seed=7):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((T, B, F)).astype(np.float32)
    mask = rng.uniform(size=(T, B)) < 0.8
    wx = (rng.standard_normal((F, 4 * H)) * 0.1).astype(np.float32)
    wh = (rng.standard_normal((H, 4 * H)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((4 * H,)) * 0.1).astype(np.float32)
    return [torch.as_tensor(a).cuda() for a in (xs, mask, wx, wh, b)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("T,B,F,H", [(97, 32, 16, 256), (97, 1, 16, 256),
                                     (97, 32, 16, 64), (12, 33, 23, 64)])
def test_lstm_seq_kernel_matches_plain(card, T, B, F, H):
    args = _args(T, B, F, H)
    before = ops.LAUNCHES
    with torch.no_grad():
        got = ops.lstm_seq(*args)
        want = lstm_seq_ref(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_lstm_seq_kernel_rejects_what_it_does_not_take(card):
    xs, mask, wx, wh, b = _args(5, 4, 8, 64)
    with torch.no_grad():
        with pytest.raises(TypeError, match="float32"):
            ops.lstm_seq(xs.double(), mask, wx, wh, b)
        with pytest.raises(ValueError, match="on cpu"):
            ops.lstm_seq(xs, mask, wx.cpu(), wh, b)
        with pytest.raises(ValueError, match="contiguous"):
            ops.lstm_seq(xs.transpose(0, 1), mask.t(), wx, wh, b)
        x2, m2, wx2, wh2, b2 = _args(5, 4, 8, 48)
        with pytest.raises(ValueError, match="H=48"):
            ops.lstm_seq(x2, m2, wx2, wh2, b2)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.lstm_seq(xs, mask, wx.requires_grad_(), wh, b)


def _randn(shape, dtype, rng):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)
                           ).to(dtype).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hkv,S,D,causal,window,dtype", [
    (2, 16, 8, 512, 128, True, 0, torch.bfloat16),
    (1, 8, 8, 300, 64, True, 0, torch.float32),
    (1, 4, 2, 777, 128, True, 128, torch.bfloat16),
    (2, 4, 1, 130, 64, False, 0, torch.float32),
    (1, 4, 2, 200, 64, False, 50, torch.bfloat16)])
def test_flash_attention_kernel_matches_plain(card, B, Hq, Hkv, S, D, causal,
                                              window, dtype):
    rng = np.random.default_rng(3)
    q = _randn((B, Hq, S, D), dtype, rng)
    k, v = (_randn((B, Hkv, S, D), dtype, rng) for _ in range(2))
    before = fa_ops.LAUNCHES
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    want = fa_ref.attention_chunked(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before + 1
    assert got.dtype == dtype
    assert attn_err(got, want)[1] <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hkv,S,D,dtype", [
    (8, 16, 8, 1024, 128, torch.bfloat16),
    (3, 4, 4, 100, 64, torch.float32),
    (2, 32, 2, 333, 64, torch.bfloat16),
    (2, 8, 1, 999, 128, torch.float32),
    (16, 16, 8, 64, 128, torch.bfloat16)])
def test_decode_gqa_kernel_matches_plain(card, B, Hq, Hkv, S, D, dtype):
    rng = np.random.default_rng(4)
    q = _randn((B, Hq, 1, D), dtype, rng)
    k, v = (_randn((B, Hkv, S, D), dtype, rng) for _ in range(2))
    length = torch.as_tensor(rng.integers(1, S + 1, size=B).astype(np.int32)
                             ).cuda()
    before = dec_ops.LAUNCHES
    got = dec_ops.decode_attention(q, k, v, length)
    want = dec_ref.decode_attention_ref(q, k, v, length)
    torch.cuda.synchronize()
    assert dec_ops.LAUNCHES == before + 1
    assert attn_err(got, want)[1] <= 1.0


@pytest.mark.gpu
def test_attention_kernels_reject_what_they_do_not_take(card):
    rng = np.random.default_rng(5)
    q = _randn((1, 4, 16, 32), torch.bfloat16, rng)
    k = _randn((1, 2, 16, 32), torch.bfloat16, rng)
    with pytest.raises(ValueError, match="D=32"):
        fa_ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="D=32"):
        dec_ops.decode_attention(q[:, :, :1].contiguous(), k, k,
                                 torch.ones(1, dtype=torch.int32).cuda())
    q = _randn((1, 4, 16, 64), torch.float16, rng)
    with pytest.raises(TypeError, match="bfloat16"):
        fa_ops.flash_attention(q, q, q)


@pytest.mark.gpu
def test_attention_kernels_reject_misaligned_views(card):
    """A contiguous view that starts off a 16-byte boundary raises
    instead of faulting in the kernel's vector loads."""
    rng = np.random.default_rng(6)
    buf = _randn((1 + 4 * 16 * 64,), torch.bfloat16, rng)
    q = buf[1:].view(1, 4, 16, 64)          # 2 bytes past the start
    assert q.is_contiguous() and q.data_ptr() % 16
    k = _randn((1, 2, 16, 64), torch.bfloat16, rng)
    before = (fa_ops.LAUNCHES, dec_ops.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        fa_ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="16-byte"):
        dec_ops.decode_attention(buf[1:1 + 4 * 64].view(1, 4, 1, 64), k, k,
                                 torch.ones(1, dtype=torch.int32).cuda())
    torch.cuda.synchronize()                # the context is still sound
    assert (fa_ops.LAUNCHES, dec_ops.LAUNCHES) == before
