"""Wrapper of the fused-sequence LSTM kernel (``csrc/lstm_seq.cu``).

``lstm_seq`` takes the plain version (``ref.lstm_seq_ref``) only when
its tensors lie on the CPU.  For CUDA tensors it launches the kernel or
raises; there is no fallback.  The CUDA source is built at first use
by :mod:`repro_torch.kernels._build` (``nvcc``, ``sm_90a``, a shared
library with a plain C interface loaded through ``ctypes``).

The kernel runs clusters of ``H / units`` CTAs, each cluster over tiles
of ``rows`` batch rows.  :func:`seq_plan` chooses ``(units, rows,
clusters)`` from the shapes and the number of clusters the card holds
at once (``cudaOccupancyMaxActiveClusters``, asked once per device and
shape), never from the mask, so a call makes no host sync and can be
captured in a CUDA graph.

The call is the operator ``torch.ops.repro_torch.lstm_seq``
(``kernels/_library.py``): the plain version on the CPU, the kernel on
the card, a fake route that gives the output's shape for
``FakeTensorMode``, and its cost formulas (:func:`flops`,
:func:`bytes_moved`).

``LAUNCHES`` counts kernel launches (and nothing else), so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build, _library
from repro_torch.kernels.lstm_seq.ref import lstm_seq_ref

LAUNCHES = 0
H_STEP, MAX_H = 32, 256  # the kernel takes H = 32k, 1 <= k <= 8
MAX_CLUSTER = 16         # CTAs in a cluster (the H100's non-portable size)
# hidden units per CTA -> the largest row tile built for it (the CUDA
# source's LSTM_SEQ_CASES)
MAX_ROWS = {16: 8, 32: 4}
# the plan's estimate of a step: STEP_OVERHEAD + rows * units * H / 32
# (its product: one SM's FMA issue cycles), about ns on an H100: within
# 12% of 11 of the 12 plans' measured steps at (97, 32, 16, 256), and
# it picks the fastest (scripts/lstm_seq_variants.py)
STEP_OVERHEAD = 800
_LIB = None
_RESIDENT: dict = {}


@dataclasses.dataclass(frozen=True)
class SeqPlan:
    units: int           # hidden units per CTA
    cluster: int         # CTAs per cluster, H / units
    rows: int            # batch rows per tile
    clusters: int        # clusters launched; each walks over tiles

    def tile_rows(self, B: int) -> list[list[int]]:
        """The batch rows each cluster computes, in the kernel's order:
        cluster i takes tiles i, i + clusters, ... of ``rows`` rows."""
        tiles = -(-B // self.rows)
        return [[b for tile in range(i, tiles, self.clusters)
                 for b in range(tile * self.rows,
                                min((tile + 1) * self.rows, B))]
                for i in range(self.clusters)]


def seq_plan(B: int, H: int, max_active_clusters: dict[int, int]) -> SeqPlan:
    """The launch for ``B`` rows at hidden size ``H``.

    ``max_active_clusters`` maps a cluster size to the number of such
    clusters the card holds at once (absent or 0: none).  For each
    ``units`` in ``MAX_ROWS`` whose cluster ``H / units`` is at most
    ``MAX_CLUSTER`` and resident, and each row tile up to its maximum,
    the plan launches ``min(tiles, resident)`` clusters, so every
    cluster runs in one wave, and takes the least estimated time:
    ``ceil(tiles / clusters)`` tiles in a row, each a step of
    ``STEP_OVERHEAD + rows * units * H / 32``.  Ties go to fewer rows
    per tile, then to smaller clusters.  A function of the shapes and
    the card only."""
    B = max(B, 1)
    best = None
    for units, max_rows in MAX_ROWS.items():
        C = H // units
        if H % units or not 1 <= C <= MAX_CLUSTER:
            continue
        resident = max_active_clusters.get(C, 0)
        if resident < 1:
            continue
        for rows in range(1, max_rows + 1):
            tiles = -(-B // rows)
            clusters = min(tiles, resident)
            cost = -(-tiles // clusters) * (STEP_OVERHEAD
                                             + rows * units * H / 32)
            key = (cost, rows, C)
            if best is None or key < best[0]:
                best = (key, SeqPlan(units, C, rows, clusters))
    if best is None:
        raise ValueError(f"lstm_seq: no cluster of H / units CTAs "
                         f"(units in {tuple(MAX_ROWS)}) fits on the card "
                         f"at H={H}: resident {max_active_clusters}")
    return best[1]


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("lstm_seq")
        lib.lstm_seq_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.lstm_seq_launch.restype = ctypes.c_int
        lib.lstm_seq_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.lstm_seq_smem_bytes.restype = ctypes.c_size_t
        lib.lstm_seq_max_active_clusters.argtypes = [ctypes.c_int] * 4
        lib.lstm_seq_max_active_clusters.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _smem_limit(device):
    return getattr(torch.cuda.get_device_properties(device),
                   "shared_memory_per_block_optin", None)


def resident_clusters(lib, device, F: int, H: int) -> dict[int, int]:
    """{cluster size: clusters the card holds at once} for each ``units``
    option, asked of the CUDA runtime with the option's largest row tile
    (the most shared memory and registers: a lower bound for the
    others); cached per (device, F, H)."""
    key = (device.index, F, H)
    if key not in _RESIDENT:
        limit = _smem_limit(device)
        out = {}
        for units, rows in MAX_ROWS.items():
            C = H // units
            if H % units or not 1 <= C <= MAX_CLUSTER:
                continue
            if limit is not None and \
                    lib.lstm_seq_smem_bytes(units, rows, F, H) > limit:
                continue
            n = lib.lstm_seq_max_active_clusters(units, rows, F, H)
            if n < 0:
                _build.raise_on_error(lib, "lstm_seq", -n)
            out[C] = n
        _RESIDENT[key] = out
    return _RESIDENT[key]


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
    if H % H_STEP or not 0 < H <= MAX_H:
        raise ValueError(f"lstm_seq kernel takes H = 32k with 1 <= k <= 8, "
                         f"got H={H}")
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (xs, wx, wh, b)):
        raise RuntimeError("lstm_seq kernel has no backward yet; call it "
                           "under torch.no_grad()")
    return T, B, F, H


def launch(lib, plan: SeqPlan, xs, mask, wx, wh, b, hs) -> None:
    """One launch of the kernel under ``plan`` on the current stream;
    raises on a launch error.  Does not count in ``LAUNCHES``."""
    T, B, F = xs.shape
    H = wh.shape[0]
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = lib.lstm_seq_launch(
            xs.data_ptr(), mask.data_ptr(), wx.data_ptr(), wh.data_ptr(),
            b.data_ptr(), hs.data_ptr(), T, B, F, H, plan.units, plan.rows,
            plan.clusters, stream)
    _build.raise_on_error(lib, "lstm_seq", err)


def _cuda(xs, mask, wx, wh, b):
    global LAUNCHES
    T, B, F, H = _check(xs, mask, wx, wh, b)
    lib = _lib()
    with torch.cuda.device(xs.device):
        resident = resident_clusters(lib, xs.device, F, H)
    if not resident:
        smem = lib.lstm_seq_smem_bytes(16, 1, F, H)
        raise ValueError(f"lstm_seq: F={F}, H={H} needs {smem} B of shared "
                         f"memory per block, the card allows "
                         f"{_smem_limit(xs.device)}")
    plan = seq_plan(B, H, resident)
    hs = torch.empty((T, B, H), dtype=torch.float32, device=xs.device)
    if T == 0 or B == 0:
        return hs
    launch(lib, plan, xs, mask, wx, wh, b, hs)
    LAUNCHES += 1
    return hs


def _fake(xs, mask, wx, wh, b):
    T, B, _ = xs.shape
    return xs.new_empty((T, B, wh.shape[0]), dtype=torch.float32)


def flops(xs_shape, mask_shape, wx_shape, wh_shape, b_shape,
          out_shape=None) -> int:
    """T steps of the gate products: ``2 T B (F + H) 4H`` (every step,
    as if no row were masked)."""
    T, B, F = xs_shape
    H = wh_shape[0]
    return 2 * T * B * (F + H) * 4 * H


def bytes_moved(xs, mask, wx, wh, b) -> int:
    """Every input read once, hs (T, B, H) float32 written once."""
    T, B, _ = xs.shape
    return _library.nbytes(xs, mask, wx, wh, b) + T * B * wh.shape[0] * 4


_op = _library.define(
    "lstm_seq",
    "(Tensor xs, Tensor mask, Tensor wx, Tensor wh, Tensor b) -> Tensor",
    cpu=lstm_seq_ref, cuda=_cuda, fake=_fake, flops=flops,
    bytes_=bytes_moved)


def lstm_seq(xs, mask, wx, wh, b):
    """Fused-sequence LSTM. xs (T,B,F), mask (T,B) bool, wx (F,4H),
    wh (H,4H), b (4H,) -> hs (T,B,H).

    CPU tensors go through :func:`lstm_seq_ref`; CUDA tensors through
    the kernel, which takes contiguous float32 inputs and
    ``H in {32, 64, ..., 256}``.
    """
    if xs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lstm_seq: unsupported device {xs.device}")
    return _op(xs, mask, wx, wh, b)
