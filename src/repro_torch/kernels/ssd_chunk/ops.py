"""Wrapper of the SSD intra-chunk kernel (``csrc/ssd_chunk.cu``) and the
public SSD forward built on it, as ``repro.kernels.ssd_chunk.ops``.

``ssd_intra`` takes the plain version (``ref.ssd_intra_ref``) only when
its tensors lie on the CPU.  For CUDA tensors it launches the kernel or
raises; there is no fallback.  The kernel is built at first use by
:mod:`repro_torch.kernels._build`.  The intra-chunk term is the operator
``torch.ops.repro_torch.ssd_intra`` (``kernels/_library.py``): the plain
version on the CPU, the kernel on the card, a fake route that gives the
output's shape for ``FakeTensorMode``, and its cost formulas
(:func:`flops`, :func:`bytes_moved`).  ``LAUNCHES`` counts kernel
launches (and nothing else), so a run can show that its main path went
through the kernel; ``SHAPES`` collects each launch's (BC, C, N, H, P).
``ssd_intra`` is differentiable (:class:`SSDIntra`): the
forward is the kernel (or the plain version), the backward plain
PyTorch, ``ref.ssd_intra_vjp``, the gradient of ``ssd_intra_ref``
recomputed a batch of chunks at a time; there is no backward kernel.

``ssd_forward`` pads T to the chunk with dt = 0 (an identity state
update), runs the intra-chunk term through ``ssd_intra`` on the
flattened (batch x chunks) axis and the linear inter-chunk state
recurrence in plain PyTorch: two batched matmuls and a loop over the
chunks, without ever building a (b, k, j, h, n, p) tensor.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, _library
from repro_torch.kernels.ssd_chunk.ref import (CLIP, ssd_intra_ref,
                                               ssd_intra_vjp)

LAUNCHES = 0
SHAPES: set = set()
CHUNKS = (16, 32, 64, 128)
HEAD_DIMS = (16, 32, 64)
MAX_STATE = 128
MIN_GROUP = 8           # heads per block at least: S is shared by them
BLOCKS_PER_SM = 2       # the grid aims at this many blocks per SM
_LIB = None


def head_group(BC: int, H: int, n_sm: int) -> int:
    """Heads per block: the kernel computes S once per (chunk, group of
    heads), so groups are large (``MIN_GROUP`` at least) and just
    numerous enough that the ``BC * ceil(H / group)`` blocks give each
    of the ``n_sm`` SMs about ``BLOCKS_PER_SM``.  A function of the
    shapes only."""
    groups = max(1, round(BLOCKS_PER_SM * n_sm / max(1, BC)))
    return max(MIN_GROUP, -(-H // groups))


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("ssd_chunk")
        lib.ssd_chunk_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.ssd_chunk_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(cm, bm, xdt, cum):
    if cm.ndim != 3 or xdt.ndim != 4 or cum.ndim != 3:
        raise ValueError("ssd_intra: cm/bm must be (BC, C, N), xdt "
                         "(BC, H, C, P) and cum (BC, H, C)")
    BC, C, N = cm.shape
    H, P = xdt.shape[1], xdt.shape[3]
    if tuple(bm.shape) != (BC, C, N) or tuple(xdt.shape) != (BC, H, C, P) \
            or tuple(cum.shape) != (BC, H, C):
        raise ValueError(f"ssd_intra: shapes cm {tuple(cm.shape)}, bm "
                         f"{tuple(bm.shape)}, xdt {tuple(xdt.shape)}, cum "
                         f"{tuple(cum.shape)} do not agree")
    if C not in CHUNKS:
        raise ValueError(f"ssd_intra kernel takes C in {CHUNKS}, got C={C}")
    if P not in HEAD_DIMS:
        raise ValueError(f"ssd_intra kernel takes P in {HEAD_DIMS}, got "
                         f"P={P}")
    if not 0 < N <= MAX_STATE or N % 4:
        raise ValueError(f"ssd_intra kernel takes N a multiple of 4 up to "
                         f"{MAX_STATE}, got N={N}")
    if BC > 2 ** 31 - 1 or H > 65535 * MIN_GROUP:
        raise ValueError(f"ssd_intra kernel takes BC < 2**31 and "
                         f"H <= {65535 * MIN_GROUP}, got BC={BC}, H={H}")
    for name, x in (("cm", cm), ("bm", bm), ("xdt", xdt), ("cum", cum)):
        if x.dtype != torch.float32:
            raise TypeError(f"ssd_intra kernel takes float32, {name} is "
                            f"{x.dtype}")
        if x.device != cm.device:
            raise ValueError(f"ssd_intra: {name} is on {x.device}, cm on "
                             f"{cm.device}")
        if not x.is_contiguous():
            raise ValueError(f"ssd_intra: {name} is not contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"ssd_intra: {name} does not start on a "
                             f"16-byte boundary (the kernel reads 16-byte "
                             f"vectors)")
    return BC, C, N, H, P


def _cuda(cm, bm, xdt, cum):
    global LAUNCHES
    BC, C, N, H, P = _check(cm, bm, xdt, cum)
    lib = _lib()
    y = torch.empty_like(xdt)
    if BC == 0 or H == 0:
        return y
    hg = head_group(BC, H, torch.cuda.get_device_properties(
        cm.device).multi_processor_count)
    with torch.cuda.device(cm.device):
        stream = torch.cuda.current_stream(cm.device).cuda_stream
        err = lib.ssd_chunk_launch(
            cm.data_ptr(), bm.data_ptr(), xdt.data_ptr(), cum.data_ptr(),
            y.data_ptr(), BC, C, N, H, P, hg, stream)
    _build.raise_on_error(lib, "ssd_chunk", err)
    LAUNCHES += 1
    SHAPES.add((BC, C, N, H, P))
    return y


def _fake(cm, bm, xdt, cum):
    return torch.empty_like(xdt, dtype=torch.float32)


def flops(cm_shape, bm_shape, xdt_shape, cum_shape, out_shape=None) -> int:
    """``S = C B^T`` once a chunk (``2 BC C^2 N``) and ``(S * L) @ xdt``
    a head (``2 BC H C^2 P``), both over whole C x C blocks."""
    BC, C, N = cm_shape
    H, P = xdt_shape[1], xdt_shape[3]
    return 2 * BC * C * C * N + 2 * BC * H * C * C * P


def bytes_moved(cm, bm, xdt, cum) -> int:
    """cm, bm, xdt and cum read once, y (xdt's shape) written once."""
    return _library.nbytes(cm, bm, xdt, cum, xdt)


_op = _library.define(
    "ssd_intra", "(Tensor cm, Tensor bm, Tensor xdt, Tensor cum) -> Tensor",
    cpu=ssd_intra_ref, cuda=_cuda, fake=_fake, flops=flops,
    bytes_=bytes_moved)


def _forward(cm, bm, xdt, cum):
    if cm.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_intra: unsupported device {cm.device}")
    return _op(cm, bm, xdt, cum)


class SSDIntra(torch.autograd.Function):
    """The intra-chunk term with the kernel (or plain) forward and the
    plain backward :func:`ssd_intra_vjp`."""

    @staticmethod
    def forward(ctx, cm, bm, xdt, cum):
        ctx.save_for_backward(cm, bm, xdt, cum)
        return _forward(cm, bm, xdt, cum)

    @staticmethod
    def backward(ctx, dy):
        grads = ssd_intra_vjp(*ctx.saved_tensors, dy)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def ssd_intra(cm, bm, xdt, cum):
    """cm/bm (BC,C,N), xdt (BC,H,C,P), cum (BC,H,C) -> y (BC,H,C,P),
    differentiable in all four.

    CPU tensors go through :func:`ssd_intra_ref`; CUDA tensors through
    the kernel, which takes contiguous float32 inputs with C in
    {16, 32, 64, 128}, P in {16, 32, 64} and N a multiple of 4 up to 128.
    """
    return SSDIntra.apply(cm, bm, xdt, cum)


def ssd_forward(x, dt, A, Bm, Cm, init_state=None, *, chunk: int = 128):
    """x (B,T,H,P), dt (B,T,H), A (H,), Bm/Cm (B,T,N), float32.

    Returns (y (B,T,H,P), final_state (B,H,N,P)).  T is padded to the
    chunk (dt = 0 on the padding: an identity state update).
    """
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-T) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    Tp = T + pad
    nc = Tp // chunk
    BC = B * nc

    la = (dt * A[None, None, :]).reshape(B, nc, chunk, H)
    cum = torch.cumsum(la, dim=2)                           # (B,nc,C,H)
    xdt = (x * dt[..., None]).reshape(B, nc, chunk, H, P)
    Bc = Bm.reshape(BC, chunk, N)
    Cc = Cm.reshape(BC, chunk, N)

    # ---- intra-chunk through the kernel (batch x chunks flattened) ----
    y_intra = ssd_intra(
        Cc.contiguous(), Bc.contiguous(),
        xdt.permute(0, 1, 3, 2, 4).reshape(BC, H, chunk, P).contiguous(),
        cum.permute(0, 1, 3, 2).reshape(BC, H, chunk).contiguous())
    y_intra = y_intra.reshape(B, nc, H, chunk, P).permute(0, 1, 3, 2, 4)

    # ---- inter-chunk state recurrence (linear, batched matmuls) ----
    # chunk_state[b,k,h,n,p] = sum_j Bc[b,k,j,n] decay_out[b,k,j,h]
    #                                * xdt[b,k,j,h,p]
    decay_out = torch.exp(torch.clamp(cum[:, :, -1:, :] - cum, -CLIP, 0.0))
    xw = (xdt * decay_out[..., None]).reshape(BC, chunk, H * P)
    chunk_state = torch.bmm(Bc.transpose(1, 2), xw)         # (BC,N,H*P)
    chunk_state = chunk_state.reshape(B, nc, N, H, P)
    total = torch.exp(torch.clamp(cum[:, :, -1, :], min=-CLIP))  # (B,nc,H)
    # states entering each chunk, kept as (B,nc,N,H,P) for the next bmm
    S = (torch.zeros((B, N, H, P), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.permute(0, 2, 1, 3))
    Sin = torch.empty((B, nc, N, H, P), dtype=torch.float32,
                      device=x.device)
    for k in range(nc):
        Sin[:, k] = S
        S = S * total[:, k, None, :, None] + chunk_state[:, k]
    # y_inter[b,k,i,h,p] = decay_in[b,k,i,h] * sum_n Cc[b,k,i,n]
    #                                              * Sin[b,k,h,n,p]
    decay_in = torch.exp(torch.clamp(cum, min=-CLIP))       # (B,nc,C,H)
    y_inter = torch.bmm(Cc, Sin.reshape(BC, N, H * P))      # (BC,C,H*P)
    y_inter = y_inter.reshape(B, nc, chunk, H, P) * decay_in[..., None]
    y = (y_intra + y_inter).reshape(B, Tp, H, P)
    return y[:, :T], S.permute(0, 2, 1, 3)
