"""Wrapper of the prefill attention kernel (``csrc/flash_attention.cu``).

``flash_attention`` takes the plain version (``ref.attention_chunked``)
only when its tensors lie on the CPU.  For CUDA tensors it launches the
kernel or raises; there is no fallback.  The kernel is built at first
use by :mod:`repro_torch.kernels._build`.

It is differentiable (:class:`FlashAttention`): the forward is the
kernel (or, on the CPU, the plain version), the backward plain PyTorch,
``ref.attention_chunked_vjp``: the gradient of ``attention_chunked``,
the function the reference differentiates, recomputed one query block
at a time.  There is no backward kernel.

The forward is the operator ``torch.ops.repro_torch.flash_attention``
(``kernels/_library.py``): the plain version on the CPU, the kernel on
the card, a fake route that gives the output's shape for
``FakeTensorMode``, and its cost formulas (:func:`flops`,
:func:`bytes_moved`).

``LAUNCHES`` counts kernel launches (and nothing else), so a run can
show that its main path went through the kernel; ``SHAPES`` collects
each launch's (B, Hq, Hkv, Sq, Sk, D, causal, window, dtype name), so it
can show which shapes those were.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _library
from repro_torch.kernels.flash_attention.ref import (attention_chunked,
                                                     attention_chunked_vjp)

LAUNCHES = 0
SHAPES: set = set()
HEAD_DIMS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attention")
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int]
        lib.flash_attention_smem_bytes.restype = ctypes.c_size_t
        _LIB = lib
    return _LIB


def _check_shapes(q, k, v, causal):
    """(B, Hq, Hkv, Sq, Sk, D), or raise.  Keys may be more or fewer than
    queries only without the causal mask: the reference model never asks
    for causal Sq != Sk, and its two plain versions place the diagonal
    differently there (``attention_naive`` aligns the ends,
    ``attention_chunked`` the starts)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q, k, v must be (B, H, S, D)")
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Hkv, Sk, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, Hkv, Sk, D) with q "
                         f"{tuple(q.shape)}")
    if causal and Sq != Sk:
        raise ValueError(f"flash_attention: causal attention takes as many "
                         f"keys as queries, got Sq={Sq}, Sk={Sk}")
    return B, Hq, Hkv, Sq, Sk, D


def _check(q, k, v, causal):
    B, Hq, Hkv, Sq, Sk, D = _check_shapes(q, k, v, causal)
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: Hq={Hq} is not a multiple of "
                         f"Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes D in {HEAD_DIMS}, "
                         f"got D={D}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype not in DTYPES:
            raise TypeError(f"flash_attention kernel takes float32 or "
                            f"bfloat16, {name} is {x.dtype}")
        if x.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {x.dtype}, q is "
                            f"{q.dtype}")
        if x.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {x.device}, q "
                             f"on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} does not start on a "
                             f"16-byte boundary (the kernel reads 16-byte "
                             f"vectors)")
    if Hq > 65535 or B > 65535:
        raise ValueError(f"flash_attention kernel takes Hq, B <= 65535, got "
                         f"Hq={Hq}, B={B}")
    return B, Hq, Hkv, Sq, Sk, D


def _cpu(q, k, v, causal, window):
    _check_shapes(q, k, v, causal)
    return attention_chunked(q, k, v, causal=causal, window=window)


def _cuda(q, k, v, causal, window):
    global LAUNCHES
    B, Hq, Hkv, Sq, Sk, D = _check(q, k, v, causal)
    lib = _lib()
    smem = lib.flash_attention_smem_bytes(D)
    limit = getattr(torch.cuda.get_device_properties(q.device),
                    "shared_memory_per_block_optin", None)
    if limit is not None and smem > limit:
        raise ValueError(f"flash_attention: D={D} needs {smem} B of shared "
                         f"memory per block, the card allows {limit}")
    o = torch.empty_like(q)
    if B == 0 or Sq == 0 or Hq == 0:
        return o
    if Sk == 0:
        raise ValueError("flash_attention: no keys (Sk = 0)")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Hq,
            Hkv, Sq, Sk, D, int(q.dtype == torch.bfloat16),
            int(bool(causal)), int(window), stream)
    _build.raise_on_error(lib, "flash_attention", err)
    LAUNCHES += 1
    SHAPES.add((B, Hq, Hkv, Sq, Sk, D, bool(causal), int(window),
                str(q.dtype)[6:]))
    return o


def _fake(q, k, v, causal, window):
    _check_shapes(q, k, v, causal)
    return torch.empty_like(q)


def visible_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the function computes: all ``Sq * Sk`` without
    the causal mask; with it, query i sees ``min(i + 1, window)`` keys
    (``window`` 0: all ``i + 1``)."""
    if not causal:
        return Sq * Sk
    w = window if 0 < window < Sq else Sq
    return w * (w + 1) // 2 + (Sq - w) * w


def flops(q_shape, k_shape, v_shape, causal, window, out_shape=None) -> int:
    """``Q K^T`` and ``P V`` over the visible pairs: ``4 B Hq D`` a pair
    (the causal triangle ``Sq (Sq + 1) / 2`` with the mask)."""
    B, Hq, Sq, D = q_shape
    return 4 * B * Hq * D * visible_pairs(Sq, k_shape[2], causal, window)


def bytes_moved(q, k, v, causal, window) -> int:
    """q, k and v read once, the output (q's shape) written once."""
    return _library.nbytes(q, k, v, q)


_op = _library.define(
    "flash_attention",
    "(Tensor q, Tensor k, Tensor v, bool causal, int window) -> Tensor",
    cpu=_cpu, cuda=_cuda, fake=_fake, flops=flops, bytes_=bytes_moved)


def _forward(q, k, v, causal, window):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _op(q, k, v, bool(causal), int(window))


class FlashAttention(torch.autograd.Function):
    """Attention with the kernel (or plain) forward and the plain
    backward :func:`attention_chunked_vjp`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_chunked_vjp(q, k, v, do, causal=ctx.causal,
                                           window=ctx.window)
        need = ctx.needs_input_grad
        return (dq if need[0] else None, dk if need[1] else None,
                dv if need[2] else None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B,Hq,Sq,D), k/v (B,Hkv,Sk,D) -> (B,Hq,Sq,D) in q's dtype; Sk
    may differ from Sq only when ``causal`` is false (cross-attention).
    Differentiable in q, k and v.

    CPU tensors go through :func:`attention_chunked`; CUDA tensors
    through the kernel, which takes contiguous float32 or bfloat16
    inputs with ``D in {64, 128}``.
    """
    return FlashAttention.apply(q, k, v, causal, window)
