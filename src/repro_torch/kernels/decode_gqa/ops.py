"""Wrapper of the one-token decode attention kernel
(``csrc/decode_gqa.cu``).

``decode_attention`` takes the plain version
(``ref.decode_attention_ref``) only when its tensors lie on the CPU.
For CUDA tensors it launches the kernel or raises; there is no
fallback.  The kernel is built at first use by
:mod:`repro_torch.kernels._build`.

The kernel splits each sequence's cache into ``n_split`` runs of
``rows`` positions (one block per run, KV head and batch row) and
merges the runs' partial softmax states.  :func:`split_plan` chooses
the split from the static shapes and the card's SM count alone, never
from the values of ``length``, so a call makes no host sync and can be
captured in a CUDA graph.

The call is the operator ``torch.ops.repro_torch.decode_attention``
(``kernels/_library.py``): the plain version on the CPU, the kernel on
the card, a fake route that gives the output's shape for
``FakeTensorMode``, and its cost formulas (:func:`flops`,
:func:`bytes_moved`).

``LAUNCHES`` counts kernel launches (and nothing else), so a run can
show that its main path went through the kernel; ``SHAPES`` collects
each launch's (B, Hq, Hkv, S, D, dtype name), so it can show which
shapes those were.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _library
from repro_torch.kernels.decode_gqa.ref import decode_attention_ref

LAUNCHES = 0
SHAPES: set = set()
HEAD_DIMS = (64, 128)
GROUPS = (1, 2, 4, 8, 16)
DTYPES = (torch.float32, torch.bfloat16)
ROW_QUANTUM = 16        # a run's length is a multiple of this
MAX_ROWS = 1024         # longer caches get more runs, not longer ones
BLOCKS_PER_SM = 3       # split blocks per SM the plan aims at
_LIB = None


def split_plan(B: int, Hkv: int, S: int, n_sm: int) -> tuple[int, int]:
    """(n_split, rows): the cache's S positions cut into ``n_split`` runs
    of ``rows`` (a multiple of ``ROW_QUANTUM``, at most ``MAX_ROWS``),
    as many as keep the ``n_split * Hkv * B`` blocks within
    ``BLOCKS_PER_SM`` on each of the ``n_sm`` SMs (all resident at once:
    the kernel fits four), and more only where a run would pass
    ``MAX_ROWS``.  Run i covers
    [i * rows, min((i + 1) * rows, S)); together they cover [0, S) once.
    A function of the shapes only."""
    if S <= 0:
        return 1, ROW_QUANTUM
    want = max(1, BLOCKS_PER_SM * n_sm // max(1, B * Hkv))
    rows = -(-S // want)
    rows = min(-(-rows // ROW_QUANTUM) * ROW_QUANTUM, MAX_ROWS)
    return -(-S // rows), rows


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("decode_gqa")
        lib.decode_gqa_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.decode_gqa_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(q, k, v, length):
    if q.ndim != 4 or q.shape[2] != 1:
        raise ValueError(f"decode_attention: q must be (B, Hq, 1, D), got "
                         f"{tuple(q.shape)}")
    B, Hq, _, D = q.shape
    if k.ndim != 4 or k.shape[0] != B or k.shape[3] != D \
            or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"decode_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, Hkv, S, D) with q "
                         f"{tuple(q.shape)}")
    Hkv, S = k.shape[1], k.shape[2]
    if tuple(length.shape) != (B,):
        raise ValueError(f"decode_attention: length has shape "
                         f"{tuple(length.shape)}, expected ({B},)")
    if Hkv == 0 or Hq % Hkv or Hq // Hkv not in GROUPS:
        raise ValueError(f"decode_attention kernel takes Hq/Hkv in "
                         f"{GROUPS}, got Hq={Hq}, Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel takes D in {HEAD_DIMS}, "
                         f"got D={D}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype not in DTYPES:
            raise TypeError(f"decode_attention kernel takes float32 or "
                            f"bfloat16, {name} is {x.dtype}")
        if x.dtype != q.dtype:
            raise TypeError(f"decode_attention: {name} is {x.dtype}, q is "
                            f"{q.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"decode_attention: {name} is not contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} does not start on a "
                             f"16-byte boundary (the kernel reads 16-byte "
                             f"vectors)")
    for name, x in (("k", k), ("v", v), ("length", length)):
        if x.device != q.device:
            raise ValueError(f"decode_attention: {name} is on {x.device}, q "
                             f"on {q.device}")
    if B > 65535 or Hkv > 65535:
        raise ValueError(f"decode_attention kernel takes B, Hkv <= 65535, "
                         f"got B={B}, Hkv={Hkv}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError("decode_attention kernel has no backward; call "
                           "it under torch.no_grad()")
    return B, Hq, Hkv, S, D


def _cuda(q, k, v, length):
    global LAUNCHES
    B, Hq, Hkv, S, D = _check(q, k, v, length)
    lib = _lib()
    length = length.to(torch.int32).contiguous()
    o = torch.empty_like(q)
    if B == 0 or Hq == 0:
        return o
    n_split, rows = split_plan(B, Hkv, S, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    # partial (acc[D], m, l) of every (batch row, query head, run)
    part = torch.empty((B * Hq * n_split * (D + 2),), dtype=torch.float32,
                       device=q.device) if n_split > 1 else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_gqa_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
            o.data_ptr(), None if part is None else part.data_ptr(),
            B, Hq, Hkv, S, D, int(q.dtype == torch.bfloat16), rows, n_split,
            stream)
    _build.raise_on_error(lib, "decode_gqa", err)
    LAUNCHES += 1
    SHAPES.add((B, Hq, Hkv, S, D, str(q.dtype)[6:]))
    return o


def _fake(q, k, v, length):
    return torch.empty_like(q)


def flops(q_shape, k_shape, v_shape, length_shape, out_shape=None) -> int:
    """``q K^T`` and ``p V`` over the whole cache, ``4 B Hq S D``: the
    work at full length (the lengths are data; a shorter row does
    less)."""
    B, Hq, _, D = q_shape
    return 4 * B * Hq * k_shape[2] * D


def bytes_moved(q, k, v, length) -> int:
    """q, the whole k and v cache and the lengths read once, the output
    written once (at full length)."""
    return _library.nbytes(q, k, v, length, q)


_op = _library.define(
    "decode_attention",
    "(Tensor q, Tensor k, Tensor v, Tensor length) -> Tensor",
    cpu=decode_attention_ref, cuda=_cuda, fake=_fake, flops=flops,
    bytes_=bytes_moved)


def decode_attention(q, k, v, length):
    """q (B,Hq,1,D), k/v (B,Hkv,S,D), length (B,) ints -> (B,Hq,1,D).

    CPU tensors go through :func:`decode_attention_ref`; CUDA tensors
    through the kernel, which takes contiguous float32 or bfloat16
    inputs with ``D in {64, 128}`` and ``Hq/Hkv in {1, 2, 4, 8, 16}``.
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return _op(q, k, v, length)
