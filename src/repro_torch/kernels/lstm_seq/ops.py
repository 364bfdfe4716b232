"""Wrapper of the fused-sequence LSTM kernel (``csrc/lstm_seq.cu``).

``lstm_seq`` takes the plain version (``ref.lstm_seq_ref``) only when
its tensors lie on the CPU.  For CUDA tensors it launches the kernel or
raises; there is no fallback.  The CUDA source is built at first use
by :mod:`repro_torch.kernels._build` (``nvcc``, ``sm_90a``, a shared
library with a plain C interface loaded through ``ctypes``).

``LAUNCHES`` counts kernel launches (and nothing else), so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lstm_seq.ref import lstm_seq_ref

LAUNCHES = 0
UNITS_PER_CTA = 32
MAX_CLUSTER = 8          # portable thread-block cluster size
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("lstm_seq")
        lib.lstm_seq_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.lstm_seq_launch.restype = ctypes.c_int
        lib.lstm_seq_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.lstm_seq_smem_bytes.restype = ctypes.c_size_t
        _LIB = lib
    return _LIB


def _check(xs, mask, wx, wh, b):
    T, B, F = xs.shape
    H = wh.shape[0]
    shapes = {"mask": (mask.shape, (T, B)), "wx": (wx.shape, (F, 4 * H)),
              "wh": (wh.shape, (H, 4 * H)), "b": (b.shape, (4 * H,))}
    for name, (got, want) in shapes.items():
        if tuple(got) != want:
            raise ValueError(f"lstm_seq: {name} has shape {tuple(got)}, "
                             f"expected {want}")
    for name, x in (("xs", xs), ("wx", wx), ("wh", wh), ("b", b)):
        if x.dtype != torch.float32:
            raise TypeError(f"lstm_seq kernel takes float32, {name} is "
                            f"{x.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"lstm_seq: mask must be bool, is {mask.dtype}")
    for name, x in (("xs", xs), ("mask", mask), ("wx", wx), ("wh", wh),
                    ("b", b)):
        if x.device != xs.device:
            raise ValueError(f"lstm_seq: {name} is on {x.device}, xs on "
                             f"{xs.device}")
        if not x.is_contiguous():
            raise ValueError(f"lstm_seq: {name} is not contiguous")
    if H % UNITS_PER_CTA or not 0 < H // UNITS_PER_CTA <= MAX_CLUSTER:
        raise ValueError(f"lstm_seq kernel takes H = 32k with 1 <= k <= 8, "
                         f"got H={H}")
    if B > 65535 * 4:
        raise ValueError(f"lstm_seq kernel takes B <= {65535 * 4}, got {B}")
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (xs, wx, wh, b)):
        raise RuntimeError("lstm_seq kernel has no backward yet; call it "
                           "under torch.no_grad()")
    return T, B, F, H


def lstm_seq(xs, mask, wx, wh, b):
    """Fused-sequence LSTM. xs (T,B,F), mask (T,B) bool, wx (F,4H),
    wh (H,4H), b (4H,) -> hs (T,B,H).

    CPU tensors go through :func:`lstm_seq_ref`; CUDA tensors through
    the kernel, which takes contiguous float32 inputs and
    ``H in {32, 64, ..., 256}``.
    """
    global LAUNCHES
    if xs.device.type == "cpu":
        return lstm_seq_ref(xs, mask, wx, wh, b)
    if xs.device.type != "cuda":
        raise ValueError(f"lstm_seq: unsupported device {xs.device}")
    T, B, F, H = _check(xs, mask, wx, wh, b)
    lib = _lib()
    smem = lib.lstm_seq_smem_bytes(F, H)
    limit = getattr(torch.cuda.get_device_properties(xs.device),
                    "shared_memory_per_block_optin", None)
    if limit is not None and smem > limit:
        raise ValueError(f"lstm_seq: F={F}, H={H} needs {smem} B of shared "
                         f"memory per block, the card allows {limit}")
    hs = torch.empty((T, B, H), dtype=torch.float32, device=xs.device)
    if T == 0 or B == 0:
        return hs
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = lib.lstm_seq_launch(
            xs.data_ptr(), mask.data_ptr(), wx.data_ptr(), wh.data_ptr(),
            b.data_ptr(), hs.data_ptr(), T, B, F, H, stream)
    _build.raise_on_error(lib, "lstm_seq", err)
    LAUNCHES += 1
    return hs
