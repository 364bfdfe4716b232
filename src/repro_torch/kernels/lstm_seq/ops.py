"""Wrapper of the fused-sequence LSTM kernel (``csrc/lstm_seq.cu``).

``lstm_seq`` takes the plain version (``ref.lstm_seq_ref``) only when
its tensors lie on the CPU.  For CUDA tensors it launches the kernel or
raises; there is no fallback.  The CUDA source is compiled with
``nvcc`` for ``sm_90a`` into ``build/kernels/`` at first use, as a
shared library with a plain C interface loaded through ``ctypes``.

``LAUNCHES`` counts kernel launches (and nothing else), so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch.kernels.lstm_seq.ref import lstm_seq_ref

LAUNCHES = 0

_PKG = Path(__file__).resolve().parents[2]          # src/repro_torch
SOURCE = _PKG / "csrc" / "lstm_seq.cu"
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
UNITS_PER_CTA = 32
MAX_CLUSTER = 8          # portable thread-block cluster size
_LIB = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        if cand.exists():
            path = str(cand)
    if path is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build lstm_seq")
    return path


def build() -> Path:
    """Compile the kernel (once per source content) and return the
    library's path.  The name carries a hash of the source and flags,
    and the file is written under a temporary name and renamed, so
    concurrent builders never load a half-written library."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"liblstm_seq_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                       check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build {SOURCE}:\n{e.stderr}") \
            from None
    os.replace(tmp, out)
    return out


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.lstm_seq_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.lstm_seq_launch.restype = ctypes.c_int
        lib.lstm_seq_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.lstm_seq_smem_bytes.restype = ctypes.c_size_t
        lib.lstm_seq_error_string.argtypes = [ctypes.c_int]
        lib.lstm_seq_error_string.restype = ctypes.c_char_p
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
    if err != 0:
        raise RuntimeError(f"lstm_seq launch failed: "
                           f"{lib.lstm_seq_error_string(err).decode()} "
                           f"(cudaError {err})")
    LAUNCHES += 1
    return hs
