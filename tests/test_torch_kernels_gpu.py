"""The port's CUDA kernels against their plain versions on the card.

Needs a CUDA card (and ``nvcc`` to build the kernels): every test
carries the ``gpu`` marker and skips without one.  No JAX here, so the
file runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerance atol = rtol = 1e-4: float32 sums in another order over up to
97 recurrent steps.
"""
import numpy as np
import pytest
import torch

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
