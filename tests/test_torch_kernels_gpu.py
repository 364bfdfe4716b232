"""The port's CUDA kernels against their plain versions on the card.

Needs a CUDA card (and ``nvcc`` to build the kernels): every test
carries the ``gpu`` marker and skips without one.  No JAX here, so the
file runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances: ``lstm_seq`` atol = rtol = 1e-4 (float32 sums in another
order over up to 97 recurrent steps); ``lstm_cell`` 1e-5 in float32 and
3e-2 in bfloat16 (the JAX kernel tests' tolerances: one step, float32
sums in another order; the plain version rounds the bf16 gates), its
gradient 1e-5; the attention kernels each element
within ``repro_torch.kernels.attn_tolerance`` (one bf16 ulp plus 1.5e-2
of the row's RMS in bfloat16, 1e-4 of both in float32); ``ssd_chunk``
each element within 1e-4 of its (batch*chunk, head) block's RMS
(``ssd_chunk.ref.ssd_err``: float32 sums over N and C in another
order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.attn_tolerance import attn_err
from repro_torch.kernels.decode_gqa import ops as dec_ops
from repro_torch.kernels.decode_gqa import ref as dec_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.lstm_cell import lstm_cell_ref
from repro_torch.kernels.lstm_cell import ops as cell_ops
from repro_torch.kernels.lstm_seq import lstm_seq_ref, ops
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.kernels.ssd_chunk import ref as ssd_ref

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
                                     (97, 33, 16, 256), (97, 32, 16, 64),
                                     (12, 33, 23, 64), (3, 130, 23, 128),
                                     # the generalist's input width at
                                     # M_max = 8: F = 4 + 2*8 + 8*8
                                     (97, 32, 84, 256), (97, 5, 84, 256)])
def test_lstm_seq_kernel_matches_plain(card, T, B, F, H):
    args = _args(T, B, F, H)
    before = ops.LAUNCHES
    with torch.no_grad():
        got = ops.lstm_seq(*args)
        want = lstm_seq_ref(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def _tail_mask(kind, T, B, rows):
    """The rows of one tile ending at different steps; a fully masked
    tile (the second, or the only one); every other row unmasked again
    after a masked middle third."""
    t = torch.arange(T)[:, None]
    mask = torch.ones((T, B), dtype=torch.bool)
    if kind == "ends":
        mask = t < torch.clamp(T - (torch.arange(B) % 5) * (T // 5),
                               min=1)[None, :]
    elif kind == "dead_tile":
        lo = rows if B > rows else 0
        mask[:, lo:lo + rows] = False
    elif kind == "gap":
        gap = (t >= T // 3) & (t < 2 * T // 3)
        mask[:, ::2] = ~gap.expand(T, B)[:, ::2]
    return mask.cuda()


def _rows(B, F, H):
    lib = ops._lib()
    return ops.seq_plan(B, H, ops.resident_clusters(
        lib, torch.device("cuda", 0), F, H)).rows


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ends", "dead_tile", "gap"])
@pytest.mark.parametrize("T,B,F,H", [(97, 32, 16, 256), (97, 33, 16, 256),
                                     (97, 1, 16, 256), (12, 33, 23, 64),
                                     (40, 70, 16, 128), (97, 32, 84, 256)])
def test_lstm_seq_kernel_tail_masks(card, T, B, F, H, kind):
    xs, _, wx, wh, b = _args(T, B, F, H, seed=15)
    mask = _tail_mask(kind, T, B, _rows(B, F, H))
    with torch.no_grad():
        got = ops.lstm_seq(xs, mask, wx, wh, b)
        want = lstm_seq_ref(xs, mask, wx, wh, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert not got[:, ~mask.any(0)].any()      # never-live rows stay 0


@pytest.mark.gpu
def test_lstm_seq_replays_from_a_cuda_graph(card):
    """The call makes no host sync and plans from shapes only: captured
    once, it replays with new masks written in place (full, tails, all
    false) and matches eager calls and the plain version."""
    T, B, F, H = 97, 32, 16, 256
    xs, mask, wx, wh, b = _args(T, B, F, H, seed=16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.no_grad(), torch.cuda.stream(side):
        ops.lstm_seq(xs, mask, wx, wh, b)             # warm-up, build
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad():
        with torch.cuda.graph(graph):
            out = ops.lstm_seq(xs, mask, wx, wh, b)
        rows = _rows(B, F, H)
        for new in [torch.ones_like(mask)] + [
                _tail_mask(k, T, B, rows) for k in ("ends", "dead_tile",
                                                    "gap")] + [
                torch.zeros_like(mask)]:
            mask.copy_(new)
            graph.replay()
            eager = ops.lstm_seq(xs, mask, wx, wh, b)
            want = lstm_seq_ref(xs, mask, wx, wh, b)
            torch.cuda.synchronize()
            assert torch.equal(out, eager)
            torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-4)


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
    (1, 4, 2, 200, 64, False, 50, torch.bfloat16),
    # the tensor-core (bf16) kernel's paths: S under one 64-row half of
    # a query tile, one row past a 128-row tile, GQA group 4 with a
    # ragged S, a window that ends inside a key tile, D = 64 non-causal
    (1, 4, 2, 37, 128, True, 0, torch.bfloat16),
    (2, 4, 2, 129, 128, True, 0, torch.bfloat16),
    (1, 8, 2, 777, 128, True, 0, torch.bfloat16),
    (1, 4, 2, 700, 128, True, 200, torch.bfloat16),
    (2, 4, 2, 333, 64, False, 0, torch.bfloat16),
    # jamba-v0.1-52b's heads (32 over 8 KV heads, group 4) and
    # internvl2-76b's (64 over 8, group 8: query head h reads KV head
    # h // 8 on the TMA path), D = 128, causal, at short S; group 8 with
    # one KV head and a ragged S; the float32 kernel at group 8
    (2, 32, 8, 256, 128, True, 0, torch.bfloat16),
    (2, 64, 8, 256, 128, True, 0, torch.bfloat16),
    (1, 8, 1, 333, 128, True, 0, torch.bfloat16),
    (1, 16, 2, 200, 128, True, 0, torch.float32)])
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D", [
    # whisper-tiny's cross-attention prefill (4 prompt tokens against
    # 1500 encoder frames), a ragged prompt, D = 128 with GQA, keys
    # fewer than queries, keys inside one tile
    (8, 6, 6, 4, 1500, 64), (2, 6, 6, 77, 1500, 64),
    (2, 8, 2, 130, 1500, 128), (1, 4, 4, 300, 37, 128),
    (3, 4, 2, 200, 129, 64), (1, 2, 1, 64, 5, 64)])
def test_flash_attention_kernel_takes_fewer_or_more_keys(card, B, Hq, Hkv, Sq,
                                                        Sk, D, dtype):
    """Non-causal calls with Sk != Sq (cross-attention): query tiles
    and the output over Sq rows, key tiles and the key mask over Sk."""
    rng = np.random.default_rng(15)
    q = _randn((B, Hq, Sq, D), dtype, rng)
    k, v = (_randn((B, Hkv, Sk, D), dtype, rng) for _ in range(2))
    before = fa_ops.LAUNCHES
    got = fa_ops.flash_attention(q, k, v, causal=False)
    want = fa_ref.attention_chunked(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    assert attn_err(got, want)[1] <= 1.0


@pytest.mark.gpu
def test_flash_attention_kernel_refuses_causal_with_other_key_counts(card):
    """Causal Sq != Sk has no agreed alignment (the plain versions
    disagree): it raises before any launch."""
    rng = np.random.default_rng(16)
    q = _randn((1, 4, 8, 64), torch.bfloat16, rng)
    k = _randn((1, 4, 12, 64), torch.bfloat16, rng)
    before = fa_ops.LAUNCHES
    with pytest.raises(ValueError, match="Sq=8, Sk=12"):
        fa_ops.flash_attention(q, k, k, causal=True)
    with pytest.raises(ValueError, match="Sq=8, Sk=12"):
        fa_ops.flash_attention(q.cpu(), k.cpu(), k.cpu(), causal=True)
    assert fa_ops.LAUNCHES == before


def _grad_err(got, want):
    """Max of |got - want| over its bound: the attention tolerance of
    ``attn_tolerance`` on each gradient row (bf16: one ulp plus 1.5e-2
    of the row's RMS), 1e-4 relative plus 1e-4 of the row's RMS in
    float32."""
    return attn_err(got, want)[1]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,dtype", [
    # internlm2-1.8b's training shape (4 x 2048, 16 over 8 heads of 128),
    # whisper-tiny's encoder (non-causal, D 64, 1500 frames) and its
    # cross-attention, olmoe-1b-7b's group 1, and float32
    (4, 16, 8, 2048, 2048, 128, True, torch.bfloat16),
    (2, 6, 6, 1500, 1500, 64, False, torch.bfloat16),
    (2, 6, 6, 512, 1500, 64, False, torch.bfloat16),
    (2, 16, 16, 512, 512, 128, True, torch.bfloat16),
    (2, 16, 8, 600, 600, 128, True, torch.float32)])
def test_flash_attention_backward_on_the_card(card, B, Hq, Hkv, Sq, Sk, D,
                                              causal, dtype):
    """Under autograd the forward is the kernel (one launch) and the
    backward the plain gradient of ``attention_chunked``: it matches
    autograd through the plain version on the card."""
    rng = np.random.default_rng(21)
    q = _randn((B, Hq, Sq, D), dtype, rng).requires_grad_()
    k, v = (_randn((B, Hkv, Sk, D), dtype, rng).requires_grad_()
            for _ in range(2))
    do = _randn((B, Hq, Sq, D), dtype, rng)
    before = fa_ops.LAUNCHES
    out = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before + 1
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(
        fa_ref.attention_chunked(q, k, v, causal=causal), (q, k, v), do)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before + 1       # no launch in the backward
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert _grad_err(g, w) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("BC,C,N,H,P", [(16, 128, 128, 80, 64),
                                        (8, 128, 16, 128, 64)])
def test_ssd_chunk_backward_on_the_card(card, BC, C, N, H, P):
    """mamba2-2.7b's SSD shape (and jamba's N = 16) under autograd: one
    kernel launch forward, the plain gradient of ``ssd_intra_ref``
    backward, within 1e-4 of autograd through the plain version."""
    args = [a.requires_grad_() for a in _ssd_inputs(BC, C, N, H, P,
                                                     "model")]
    dy = torch.randn(BC, H, C, P, device="cuda")
    before = ssd_ops.LAUNCHES
    y = ssd_ops.ssd_intra(*args)
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES == before + 1
    got = torch.autograd.grad(y, args, dy)
    want = torch.autograd.grad(ssd_ref.ssd_intra_ref(*args), args, dy)
    for g, w in zip(got, want):
        rms = w.pow(2).mean().sqrt()
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * rms)


@pytest.mark.gpu
def test_decode_kernels_still_raise_under_autograd(card):
    rng = np.random.default_rng(22)
    q = _randn((2, 4, 1, 64), torch.bfloat16, rng).requires_grad_()
    k = _randn((2, 2, 32, 64), torch.bfloat16, rng)
    lengths = torch.full((2,), 32, dtype=torch.int32, device="cuda")
    before = dec_ops.LAUNCHES
    with pytest.raises(RuntimeError, match="no backward"):
        dec_ops.decode_attention(q, k, k, lengths)
    assert dec_ops.LAUNCHES == before
    xs, mask, wx, wh, b = _args(4, 2, 16, 64)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.lstm_seq(xs, mask, wx.requires_grad_(), wh, b)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hkv,S,D,causal", [
    (2, 8, 4, 1000, 128, True), (1, 4, 2, 1000, 64, False),
    (1, 4, 1, 300, 128, False)])
def test_flash_attention_kernel_rescales_across_tiles(card, B, Hq, Hkv, S, D,
                                                      causal):
    """q and k at 4x scale: each row's maximum score moves often from
    key tile to key tile, so a wrong rescale of (m, l, acc) shows."""
    rng = np.random.default_rng(12)
    q = _randn((B, Hq, S, D), torch.float32, rng) * 4.0
    k = _randn((B, Hkv, S, D), torch.float32, rng) * 4.0
    v = _randn((B, Hkv, S, D), torch.float32, rng)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    before = fa_ops.LAUNCHES
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    want = fa_ref.attention_chunked(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before + 1
    assert attn_err(got, want)[1] <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hkv,S,D,dtype", [
    (8, 16, 8, 1024, 128, torch.bfloat16),
    (3, 4, 4, 100, 64, torch.float32),
    (2, 32, 2, 333, 64, torch.bfloat16),
    (2, 8, 1, 999, 128, torch.float32),
    (16, 16, 8, 64, 128, torch.bfloat16),
    # jamba-v0.1-52b's and internvl2-76b's decode heads (groups 4 and
    # 8 at D = 128), and group 8 in float32
    (4, 32, 8, 300, 128, torch.bfloat16),
    (4, 64, 8, 300, 128, torch.bfloat16),
    (2, 16, 2, 150, 128, torch.float32)])
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
@pytest.mark.parametrize("B,Hq,Hkv,S,D,dtype", [
    (1, 6, 6, 1500, 64, torch.float32),
    (2, 3, 3, 1500, 64, torch.float32),
    (8, 3, 3, 1500, 64, torch.bfloat16)])
def test_decode_gqa_on_whisper_cross_cache_shards(card, B, Hq, Hkv, S, D,
                                                 dtype):
    """whisper-tiny's cross-attention decode on a mesh: a rank's rows of
    the 1500-frame cache with all 6 heads, or its 3 heads
    (``head_shards.decode_attention_shards``), every frame attended."""
    rng = np.random.default_rng(17)
    q = _randn((B, Hq, 1, D), dtype, rng)
    k, v = (_randn((B, Hkv, S, D), dtype, rng) for _ in range(2))
    length = torch.full((B,), S, dtype=torch.int32, device="cuda")
    before = dec_ops.LAUNCHES
    got = dec_ops.decode_attention(q, k, v, length)
    want = dec_ref.decode_attention_ref(q, k, v, length)
    torch.cuda.synchronize()
    assert dec_ops.LAUNCHES == before + 1
    assert attn_err(got, want)[1] <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hkv,S,D,lengths,dtype", [
    # whole runs of the split empty (short and zero-length rows beside a
    # full one)
    (4, 16, 8, 2176, 128, [2176, 5, 700, 0], torch.bfloat16),
    (3, 8, 2, 3000, 64, [1, 2999, 64], torch.float32),
    (2, 32, 2, 1500, 64, [129, 1500], torch.bfloat16),
    # length 1 in a 32768-slot cache
    (4, 16, 8, 32768, 128, [1, 1, 32768, 2], torch.bfloat16),
    # the batcher's decode shape: 16 slots of 512, lengths up to 96
    (16, 16, 8, 512, 128, None, torch.bfloat16)])
def test_decode_gqa_split_matches_plain(card, B, Hq, Hkv, S, D, lengths,
                                        dtype):
    rng = np.random.default_rng(13)
    q = _randn((B, Hq, 1, D), dtype, rng)
    k, v = (_randn((B, Hkv, S, D), dtype, rng) for _ in range(2))
    if lengths is None:
        lengths = rng.integers(1, 97, size=B)
    length = torch.as_tensor(np.asarray(lengths, np.int32)).cuda()
    before = dec_ops.LAUNCHES
    got = dec_ops.decode_attention(q, k, v, length)
    want = dec_ref.decode_attention_ref(q, k, v, length)
    torch.cuda.synchronize()
    assert dec_ops.LAUNCHES == before + 1
    assert dec_ops.split_plan(B, Hkv, S, torch.cuda.get_device_properties(
        0).multi_processor_count)[0] > 1
    live = length > 0           # length 0: zeros (the plain version: mean)
    assert attn_err(got[live], want[live])[1] <= 1.0
    assert not got[~live].float().abs().any()


@pytest.mark.gpu
def test_decode_gqa_replays_from_a_cuda_graph(card):
    """The call makes no host sync: captured once, it replays with new
    lengths written in place and matches eager calls and the plain
    version."""
    rng = np.random.default_rng(14)
    B, Hq, Hkv, S, D = 4, 16, 8, 2176, 128
    q = _randn((B, Hq, 1, D), torch.bfloat16, rng)
    k, v = (_randn((B, Hkv, S, D), torch.bfloat16, rng) for _ in range(2))
    length = torch.full((B,), 2112, dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dec_ops.decode_attention(q, k, v, length)      # warm-up, build
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dec_ops.decode_attention(q, k, v, length)
    for lengths in ([2112, 2112, 2112, 2112], [1, 300, 2176, 1025],
                    [64, 65, 128, 129]):
        length.copy_(torch.as_tensor(lengths, dtype=torch.int32))
        graph.replay()
        eager = dec_ops.decode_attention(q, k, v, length)
        want = dec_ref.decode_attention_ref(q, k, v, length)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert attn_err(out, want)[1] <= 1.0


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


def _ssd_inputs(BC, C, N, H, P, decay, seed=8):
    """cm, bm, xdt and cum on the card.  decay "kernels" keeps the
    cumulative decay far above exp(-60) over a chunk (an error far below
    the diagonal shows); "model" takes the model's range of A (down to
    -16), which drives cum past the clip."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    cm, bm = f(BC, C, N) * 0.3, f(BC, C, N) * 0.3
    xdt = f(BC, H, C, P) * 0.25
    if decay == "kernels":
        la = -np.logaddexp(f(BC, H, C), 0.0) * 0.5 * np.exp(
            f(H) * 0.3)[None, :, None]
    else:
        la = -np.logaddexp(f(BC, H, C) + 1.0, 0.0) * np.linspace(
            1.0, 16.0, H)[None, :, None]
    cum = np.cumsum(la, axis=-1).astype(np.float32)
    return [torch.as_tensor(a).cuda() for a in (cm, bm, xdt, cum)]


@pytest.mark.gpu
@pytest.mark.parametrize("decay", ["kernels", "model"])
@pytest.mark.parametrize("BC,C,N,H,P", [(64, 128, 128, 80, 64),
                                        (6, 16, 32, 7, 16),
                                        (5, 64, 128, 9, 64),
                                        (3, 32, 64, 5, 32),
                                        (2, 128, 16, 3, 16),
                                        # jamba-v0.1-52b's N = 16 at its
                                        # 128 heads of 64: a few chunks,
                                        # and its prefill's 64, where the
                                        # blocks take 32 heads each
                                        (4, 128, 16, 128, 64),
                                        (64, 128, 16, 128, 64),
                                        # head shards of a (data, model)
                                        # mesh: mamba2's 80 heads on one
                                        # row, its 40 a rank at 2 rows
                                        # and at its prefill's 64, and
                                        # jamba's 64 of 128
                                        (1, 128, 128, 80, 64),
                                        (2, 128, 128, 40, 64),
                                        (64, 128, 128, 40, 64),
                                        (64, 128, 16, 64, 64)])
def test_ssd_chunk_kernel_matches_plain(card, BC, C, N, H, P, decay):
    args = _ssd_inputs(BC, C, N, H, P, decay)
    before = ssd_ops.LAUNCHES
    with torch.no_grad():
        got = ssd_ops.ssd_intra(*args)
        want = ssd_ref.ssd_intra_ref(*args)
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES == before + 1
    assert got.shape == want.shape and got.dtype == torch.float32
    assert ssd_ref.ssd_err(got, want)[1] <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("decay", ["kernels", "model"])
@pytest.mark.parametrize("BC,C,N,H,P", [(3, 128, 4, 9, 64),
                                        (4, 64, 12, 7, 32),
                                        (5, 16, 32, 1, 16),
                                        (2, 16, 12, 1, 64)])
def test_ssd_chunk_kernel_pads_n_and_small_chunks(card, BC, C, N, H, P,
                                                  decay):
    """N below or off the MMA depth of 8 (zero-padded in shared memory),
    the 16-row chunk with one head."""
    args = _ssd_inputs(BC, C, N, H, P, decay, seed=15)
    with torch.no_grad():
        got = ssd_ops.ssd_intra(*args)
        want = ssd_ref.ssd_intra_ref(*args)
    torch.cuda.synchronize()
    assert ssd_ref.ssd_err(got, want)[1] <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("T,chunk", [(100, 32), (256, 128), (48, 16)])
def test_ssd_forward_on_the_card_matches_the_scan(card, T, chunk):
    """ssd_forward (the kernel plus the inter-chunk bmm's) against the
    sequential scan, as tests/test_kernels.py holds the JAX routes."""
    rng = np.random.default_rng(9)
    B, H, P, N = 2, 5, 32, 64
    f = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(
        np.float32)).cuda()
    x = f(B, T, H, P) * 0.5
    dt = torch.nn.functional.softplus(f(B, T, H)) * 0.5
    A = -torch.exp(f(H) * 0.3)
    Bm, Cm = f(B, T, N) * 0.3, f(B, T, N) * 0.3
    before = ssd_ops.LAUNCHES
    with torch.no_grad():
        y, S = ssd_ops.ssd_forward(x, dt, A, Bm, Cm, chunk=chunk)
        ys, Ss = ssd_ref.ssd_scan_ref(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES == before + 1
    torch.testing.assert_close(y, ys, atol=5e-4, rtol=1e-3)
    torch.testing.assert_close(S, Ss, atol=5e-4, rtol=1e-3)


@pytest.mark.gpu
def test_ssd_chunk_kernel_rejects_what_it_does_not_take(card):
    cm, bm, xdt, cum = _ssd_inputs(2, 32, 16, 3, 16, "kernels")
    before = ssd_ops.LAUNCHES
    with torch.no_grad():
        with pytest.raises(TypeError, match="float32"):
            ssd_ops.ssd_intra(cm.double(), bm, xdt, cum)
        with pytest.raises(TypeError, match="float32"):
            ssd_ops.ssd_intra(cm, bm, xdt.bfloat16(), cum)
        with pytest.raises(ValueError, match="on cpu"):
            ssd_ops.ssd_intra(cm, bm.cpu(), xdt, cum)
        with pytest.raises(ValueError, match="contiguous"):
            ssd_ops.ssd_intra(cm, bm, xdt.transpose(2, 3).contiguous()
                              .transpose(2, 3), cum)
        with pytest.raises(ValueError, match="C=48"):
            a = _ssd_inputs(2, 48, 16, 3, 16, "kernels")
            ssd_ops.ssd_intra(*a)
        with pytest.raises(ValueError, match="P=8"):
            a = _ssd_inputs(2, 32, 16, 3, 8, "kernels")
            ssd_ops.ssd_intra(*a)
        with pytest.raises(ValueError, match="N=256"):
            a = _ssd_inputs(2, 32, 256, 3, 16, "kernels")
            ssd_ops.ssd_intra(*a)
        with pytest.raises(ValueError, match="do not agree"):
            ssd_ops.ssd_intra(cm, bm, xdt, cum[:, :2].contiguous())
        buf = torch.zeros(1 + cm.numel(), device="cuda")
        view = buf[1:].view_as(cm)          # 4 bytes past the start
        view.copy_(cm)
        assert view.is_contiguous() and view.data_ptr() % 16
        with pytest.raises(ValueError, match="16-byte"):
            ssd_ops.ssd_intra(view, bm, xdt, cum)
    # under autograd the kernel refuses the same inputs, before a launch
    with pytest.raises(ValueError, match="C=48"):
        a = _ssd_inputs(2, 48, 16, 3, 16, "kernels")
        ssd_ops.ssd_intra(a[0].requires_grad_(), *a[1:])
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES == before


def _cell_args(B, F, H, dtype=torch.float32, seed=9):
    rng = np.random.default_rng(seed)
    a = [rng.standard_normal((B, F)), rng.standard_normal((B, H)),
         rng.standard_normal((B, H)),
         rng.standard_normal((F, 4 * H)) * 0.1,
         rng.standard_normal((H, 4 * H)) * 0.1,
         rng.standard_normal((4 * H,)) * 0.1]
    return [torch.as_tensor(x, dtype=torch.float32).to(dtype).cuda()
            for x in a]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,F,H", [(8, 16, 256), (32, 16, 256),
                                   (32, 23, 256), (4, 16, 64), (97, 16, 256),
                                   (32, 20, 128), (1, 7, 32), (129, 16, 64),
                                   (5, 23, 8), (8, 16, 16),
                                   # H not a multiple of 4 or 8, F = 1,
                                   # B over several 16-row tiles, and a
                                   # K = F + H staged in two chunks
                                   (8, 16, 6), (5, 3, 30), (4, 1, 64),
                                   (70, 16, 256), (70, 23, 30),
                                   (3, 5, 1100),
                                   # the generalist's rollout and update
                                   # steps: actor F = 84, critic F + G = 93
                                   (8, 84, 256), (32, 84, 256),
                                   (32, 93, 256)])
def test_lstm_cell_kernel_matches_plain(card, B, F, H, dtype):
    args = _cell_args(B, F, H, dtype)
    before = cell_ops.LAUNCHES
    with torch.no_grad():
        got = cell_ops.lstm_cell(*args)
        want = lstm_cell_ref(*args)
    torch.cuda.synchronize()
    assert cell_ops.LAUNCHES == before + 1
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_lstm_cell_gradient_on_the_card(card):
    """The Function (kernel forward, plain backward) against autograd of
    the plain version, on the card."""
    arrs = _cell_args(32, 23, 256)
    rng = np.random.default_rng(10)
    wh2, wc2 = (torch.as_tensor(rng.standard_normal((32, 256)),
                                dtype=torch.float32).cuda() for _ in range(2))
    grads = []
    for fn in (cell_ops.lstm_cell, lstm_cell_ref):
        args = [a.clone().requires_grad_() for a in arrs]
        h2, c2 = fn(*args)
        ((h2 * wh2).sum() + (c2 * wc2).sum()).backward()
        grads.append([a.grad for a in args])
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_lstm_cell_kernel_rejects_what_it_does_not_take(card):
    x, h, c, wx, wh, b = _cell_args(4, 8, 32)
    before = cell_ops.LAUNCHES
    with torch.no_grad():
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            cell_ops.lstm_cell(x.double(), h.double(), c.double(),
                               wx.double(), wh.double(), b.double())
        with pytest.raises(TypeError, match="one type"):
            cell_ops.lstm_cell(x, h, c, wx.bfloat16(), wh, b)
        with pytest.raises(ValueError, match="on cpu"):
            cell_ops.lstm_cell(x, h, c, wx.cpu(), wh, b)
        with pytest.raises(ValueError, match="contiguous"):
            cell_ops.lstm_cell(x, h, c, wx, wh.t().contiguous().t(), b)
        with pytest.raises(ValueError, match="wh has shape"):
            cell_ops.lstm_cell(x, h, c, wx, wh[:, :64].contiguous(), b)
    torch.cuda.synchronize()
    assert cell_ops.LAUNCHES == before


# ---------------------------------------------------------------------------
# the legacy per-period runners and the segment engine on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("use_pallas", [False, True])
def test_legacy_policy_period_on_the_card_matches_the_cpu(card, use_pallas):
    """One ``run_episode`` through ``make_policy_period`` on the card
    (``lstm_cell`` T times a period, or ``lstm_seq`` once) and on the CPU
    (plain versions): ``counted`` equal, ``hits`` within 1% of it, the
    transitions within 1e-4 (float32 sums in another order)."""
    from repro_torch.core import policy as P
    from repro_torch.core.rollout import make_policy_period, run_episode
    from repro_torch.sim.env import EnvConfig, SchedulingEnv
    from repro_torch.workloads import build_registry
    ecfg = EnvConfig(periods=6, max_rq=32, max_jobs=16)
    reg = build_registry("light", mas="paper6")
    out = {}
    for dev in ("cpu", "cuda"):
        env = SchedulingEnv(reg, ecfg, device=dev)
        pcfg = P.PolicyConfig(feat_dim=env.feat_dim, act_dim=env.act_dim,
                              hidden=64, use_pallas=use_pallas)
        params = P.init_actor(torch.Generator().manual_seed(0), pcfg, dev)
        ops_mod = ops if use_pallas else cell_ops
        before = ops_mod.LAUNCHES
        out[dev] = run_episode(env, make_policy_period(env, pcfg),
                               np.random.default_rng(3), params=params,
                               collect=True)
        torch.cuda.synchronize()
        want = (0 if dev == "cpu" else
                ecfg.periods * (1 if use_pallas else env.seq_len))
        assert ops_mod.LAUNCHES - before == want, dev
    (mc, tc), (mg, tg) = out["cpu"], out["cuda"]
    assert mc["counted"] == mg["counted"] > 0
    assert abs(mc["hits"] - mg["hits"]) <= 0.01 * mc["counted"]
    for a, b in zip(tc, tg):
        for k in ("mask", "mask2"):
            np.testing.assert_array_equal(a[k], b[k])
        for k in ("s", "a", "r", "s2"):
            np.testing.assert_allclose(b[k], a[k], atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("S,n,M", [(4, 12, 4), (32, 96, 6), (1, 96, 6)])
def test_segment_engine_on_the_card_matches_simulate(card, S, n, M):
    """``simulate_segments`` on the card equals ``simulate`` there (max
    and min are exact, every other operation the same), and holds to
    the CPU's ``simulate`` within rtol 1e-5 / atol 1e-3 us."""
    from repro_torch.sim.engine import INF, simulate, simulate_segments
    rng = np.random.default_rng(n + M)
    # a valid prefix a row, so every dependency is a valid slot
    valid = np.arange(n) < rng.integers(1, n + 1, (S, 1))
    dep = np.where(rng.uniform(size=(S, n)) < 0.6, np.arange(n) - 1, -1)
    args = [valid, rng.integers(0, M, (S, n)),
            rng.uniform(-1, 1, (S, n)).astype(np.float32),
            rng.uniform(0.5, 200.0, (S, n)).astype(np.float32),
            rng.uniform(0.5, 16.0, (S, n)).astype(np.float32), dep,
            (rng.uniform(0, 100, (S, n)) * (dep < 0)).astype(np.float32),
            rng.uniform(0, 50, (S, M)).astype(np.float32)]
    cpu = [torch.as_tensor(a) for a in args]
    gpu = [a.cuda() for a in cpu]
    sg, fg = simulate_segments(*gpu, 8.0, num_sas=M)
    s1, f1 = simulate(*gpu, 8.0, num_sas=M)
    sc, fc = simulate(*cpu, 8.0, num_sas=M)
    torch.testing.assert_close(sg, s1, rtol=0, atol=0)
    torch.testing.assert_close(fg, f1, rtol=0, atol=0)
    assert bool((fg[torch.as_tensor(valid).cuda()] < INF / 2).all())
    torch.testing.assert_close(sg.cpu(), sc, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(fg.cpu(), fc, rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------------------------
# telemetry primitives on the card: no sync, the CPU's counts
# ---------------------------------------------------------------------------
def _tele_values(case, rng):
    """(values, weights, edges) of one case; values shaped (S, N) for the
    per-stream histograms of the serving queue."""
    from repro_torch.telemetry import metrics as M
    if case == "sla":
        return rng.uniform(0.0, 1.0, (1, 64)), None, M.SLA_EDGES
    if case == "reward_weighted":
        w = rng.uniform(-2.0, 3.0, (1, 97))       # fractional, negative
        return rng.normal(0.0, 2.0, (1, 97)), w, M.REWARD_EDGES
    if case == "edges_and_nonfinite":
        v = np.array([[0.0, -0.0, 1.0, 0.5, np.nan, np.inf, -np.inf,
                       0.2, 0.99, 2.0, -1e-45, 1e-45]])      # subnormals
        return v, None, (0.0, 0.2, 0.5, 0.99, 1.0)
    # the serving tick: one depth a stream, edges at eighths of 64 jobs
    return (rng.integers(0, 65, (32, 1)), None,
            [64 * f for f in (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875)])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["sla", "reward_weighted",
                                  "edges_and_nonfinite", "depth_rows"])
def test_telemetry_primitives_on_the_card_are_sync_free(card, case):
    """hist_init / hist_add / hist_merge / counter_add / round_telemetry
    on CUDA tensors under ``set_sync_debug_mode("error")`` (a host sync
    raises), equal to the same calls on the CPU."""
    from repro_torch.telemetry import metrics as M
    rng = np.random.default_rng(11)
    vals, w, edges = _tele_values(case, rng)
    S = vals.shape[0]
    host = dict(v=torch.as_tensor(vals, dtype=torch.float32),
                w=None if w is None else torch.as_tensor(w,
                                                         dtype=torch.float32),
                sla=torch.as_tensor(rng.uniform(0, 1, 8),
                                    dtype=torch.float32),
                rew=torch.as_tensor(rng.normal(0, 2, (8, 10)),
                                    dtype=torch.float32),
                com=torch.as_tensor(rng.integers(0, 90, (8, 10))))
    dev = {k: None if v is None else v.cuda() for k, v in host.items()}
    torch.cuda.synchronize()

    def run(t, device):
        h = M.hist_init(edges, device, shape=(S,) if S > 1 else ())
        v = t["v"] if S > 1 else t["v"].reshape(-1)
        wt = None if t["w"] is None else t["w"].reshape(-1)
        h = M.hist_merge(M.hist_add(h, v, wt), M.hist_add(h, v, wt))
        c = M.counter_add(M.counter_add(M.counter_init(device=device), 3),
                          t["com"].sum())
        g = M.gauge_set(M.gauge_init(device=device), t["sla"][0])
        r = M.round_telemetry(t["sla"], t["rew"], t["com"], 480, 4000)
        return dict(counts=h["counts"], c=c, g=g, **r)
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run(dev, "cuda")
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    want = run(host, "cpu")
    for k, v in want.items():
        assert got[k].device.type == "cuda", k
        assert torch.equal(got[k].cpu(), v), k


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,tp", [(16, 8, 16), (16, 8, 4), (4, 2, 4),
                                       (16, 2, 4), (8, 2, 2), (6, 2, 3)])
def test_head_shard_kernels_take_each_q_heads_kv_head(card, Hq, Hkv, tp,
                                                       dtype):
    """A model-axis rank's q heads against the kv heads the shard wrappers
    hand them (``head_shards.kv_heads_for``): replicated kv where Hkv does
    not divide the model axis, so global q head j reads kv head j // G;
    ``flash_attention`` and ``decode_attention`` against the plain
    versions on the kv heads indexed by hand."""
    from repro_torch.kernels import head_shards as HS
    B, S, D, G = 2, 96, 64, Hq // Hkv
    split = Hkv % tp == 0
    hq, hkv = Hq // tp, (Hkv // tp if split else Hkv)
    g = torch.Generator(device="cuda").manual_seed(3)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)
    length = torch.tensor([S, S - 17], dtype=torch.int32, device="cuda")
    for r in range(tp):
        j0, k0 = r * hq, (r * hkv if split else 0)
        q, k, v, qd = rnd(B, hq, S, D), rnd(B, hkv, S, D), rnd(B, hkv, S, D), \
            rnd(B, hq, 1, D)
        ks, group = HS.kv_heads_for(k, j0, hq, G, k0)
        vs, _ = HS.kv_heads_for(v, j0, hq, G, k0)
        idx = (torch.arange(j0, j0 + hq, device="cuda") // G) - k0
        got = fa_ops.flash_attention(q, ks, vs, causal=True)
        want = fa_ref.attention_chunked(q, k[:, idx], v[:, idx], causal=True)
        assert attn_err(got, want)[1] <= 1.0, (r, group)
        got = dec_ops.decode_attention(qd, ks, vs, length)
        want = dec_ref.decode_attention_ref(qd, k[:, idx], v[:, idx], length)
        assert attn_err(got, want)[1] <= 1.0, (r, group)


# The kernels as operators (``torch.ops.repro_torch.*``,
# ``kernels/_library.py``): on CUDA tensors the wrapper's result is bit
# for bit its CUDA route's called directly (the launch path as it was
# before the operator), and each call is one launch; on fake CUDA
# tensors (the dry run) the fake route launches and allocates nothing.
def _operator_cases():
    g = torch.Generator(device="cuda").manual_seed(11)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    bf = torch.bfloat16
    q, k, v = rnd(2, 16, 256, 128, dtype=bf), rnd(2, 8, 256, 128, dtype=bf), \
        rnd(2, 8, 256, 128, dtype=bf)
    qd = rnd(4, 16, 1, 128, dtype=bf)
    kd, vd = rnd(4, 8, 300, 128, dtype=bf), rnd(4, 8, 300, 128, dtype=bf)
    length = torch.tensor([300, 1, 77, 256], dtype=torch.int32,
                          device="cuda")
    cell = (rnd(8, 16), rnd(8, 256), rnd(8, 256), rnd(16, 1024) * 0.1,
            rnd(256, 1024) * 0.1, rnd(1024) * 0.1)
    seq = _args(97, 32, 16, 256)
    ssd = (rnd(4, 64, 32), rnd(4, 64, 32), rnd(4, 9, 64, 16),
           -torch.cumsum(rnd(4, 9, 64).abs() * 0.1, dim=-1))
    return {
        "flash_attention": (fa_ops, lambda: fa_ops.flash_attention(q, k, v),
                            lambda: fa_ops._cuda(q, k, v, True, 0)),
        "decode_gqa": (dec_ops,
                       lambda: dec_ops.decode_attention(qd, kd, vd, length),
                       lambda: dec_ops._cuda(qd, kd, vd, length)),
        "lstm_cell": (cell_ops, lambda: cell_ops.lstm_cell(*cell),
                      lambda: cell_ops._cuda(*cell)),
        "lstm_seq": (ops, lambda: ops.lstm_seq(*seq),
                     lambda: ops._cuda(*seq)),
        "ssd_chunk": (ssd_ops, lambda: ssd_ops.ssd_intra(*ssd),
                      lambda: ssd_ops._cuda(*ssd)),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["flash_attention", "decode_gqa",
                                  "lstm_cell", "lstm_seq", "ssd_chunk"])
def test_operator_is_its_cuda_route_bit_for_bit(card, name):
    mod, call, direct = _operator_cases()[name]
    with torch.no_grad():
        before = mod.LAUNCHES
        got = call()
        assert mod.LAUNCHES == before + 1
        want = direct()
    torch.cuda.synchronize()
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_fake_cuda_tensors_launch_and_allocate_nothing(card):
    from torch._subclasses.fake_tensor import FakeTensorMode
    mods = (fa_ops, dec_ops, cell_ops, ops, ssd_ops)
    before = [m.LAUNCHES for m in mods]
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated()
    with FakeTensorMode(), torch.no_grad():
        def e(*shape, dtype=torch.bfloat16):
            return torch.empty(shape, dtype=dtype, device="cuda")
        f32 = torch.float32
        outs = [fa_ops.flash_attention(e(4, 16, 4096, 128), e(4, 8, 4096, 128),
                                       e(4, 8, 4096, 128)),
                dec_ops.decode_attention(e(128, 16, 1, 128),
                                         e(128, 8, 32768, 128),
                                         e(128, 8, 32768, 128),
                                         e(128, dtype=torch.int32)),
                cell_ops.lstm_cell(e(4096, 16, dtype=f32),
                                   *(e(4096, 256, dtype=f32),) * 2,
                                   e(16, 1024, dtype=f32),
                                   e(256, 1024, dtype=f32),
                                   e(1024, dtype=f32))[0],
                ops.lstm_seq(e(97, 32, 16, dtype=f32),
                             e(97, 32, dtype=torch.bool),
                             e(16, 1024, dtype=f32), e(256, 1024, dtype=f32),
                             e(1024, dtype=f32)),
                ssd_ops.ssd_intra(e(512, 128, 128, dtype=f32),
                                  e(512, 128, 128, dtype=f32),
                                  e(512, 80, 128, 64, dtype=f32),
                                  e(512, 80, 128, dtype=f32))]
        shapes = [tuple(o.shape) for o in outs]
    assert shapes == [(4, 16, 4096, 128), (128, 16, 1, 128), (4096, 256),
                      (97, 32, 256), (512, 80, 128, 64)]
    assert [m.LAUNCHES for m in mods] == before
    assert torch.cuda.memory_allocated() == alloc


@pytest.mark.gpu
def test_each_launch_records_its_shape(card):
    """A launch adds one to ``LAUNCHES`` and its shape to ``SHAPES``;
    the plain version on CPU tensors adds neither."""
    g = torch.Generator(device="cuda").manual_seed(4)
    q = torch.randn((2, 4, 40, 64), generator=g, device="cuda")
    k = torch.randn((2, 2, 40, 64), generator=g, device="cuda")
    cm = torch.randn((3, 16, 8), generator=g, device="cuda")
    xdt = torch.randn((3, 5, 16, 16), generator=g, device="cuda")
    cum = torch.cumsum(-torch.rand((3, 5, 16), generator=g, device="cuda"),
                       dim=-1)
    length = torch.tensor([40, 7], dtype=torch.int32, device="cuda")
    calls = [(fa_ops, lambda: fa_ops.flash_attention(q, k, k, causal=True),
              (2, 4, 2, 40, 40, 64, True, 0, "float32")),
             (dec_ops, lambda: dec_ops.decode_attention(
                 q[:, :, :1].contiguous(), k, k, length),
              (2, 4, 2, 40, 64, "float32")),
             (ssd_ops, lambda: ssd_ops.ssd_intra(cm, cm, xdt, cum),
              (3, 16, 8, 5, 16))]
    for mod, call, key in calls:
        n, shapes = mod.LAUNCHES, set(mod.SHAPES)
        mod.SHAPES.clear()
        try:
            call()
            assert mod.LAUNCHES == n + 1 and mod.SHAPES == {key}
        finally:
            mod.LAUNCHES, mod.SHAPES = n, shapes
    n, shapes = fa_ops.LAUNCHES, set(fa_ops.SHAPES)
    fa_ops.flash_attention(q.cpu(), k.cpu(), k.cpu(), causal=True)
    assert fa_ops.LAUNCHES == n and fa_ops.SHAPES == shapes
