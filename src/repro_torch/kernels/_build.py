"""Build and load the hand-written CUDA kernels.

Each kernel source under ``src/repro_torch/csrc/`` is compiled on its
own with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, at first use, into ``build/kernels/`` at the root of the
checkout, and loaded with ``ctypes``.  The library's name carries a hash
of the source and the flags, so an edited source is rebuilt and never
confused with an older build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]            # src/repro_torch
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        if cand.exists():
            path = str(cand)
    if path is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build the CUDA "
                           "kernels")
    return path


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (once per source content) into
    ``lib<name>_<hash>.so`` and return its path.  The file is written
    under a temporary name and renamed, so concurrent builders never
    load a half-written library."""
    source = CSRC / f"{name}.cu"
    tag = hashlib.sha256(source.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                       check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build {source}:\n{e.stderr}") \
            from None
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build if needed and load ``lib<name>``.  Every library exports
    ``<name>_error_string(int) -> const char*``; its argument and result
    types are set here, the kernel entry points' by the caller."""
    lib = ctypes.CDLL(str(build(name)))
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def raise_on_error(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {err})")
