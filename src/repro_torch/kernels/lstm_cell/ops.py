"""Wrapper of the fused LSTM cell kernel (``csrc/lstm_cell.cu``).

``lstm_cell`` is an ``autograd.Function``.  Its forward takes the plain
version (``ref.lstm_cell_ref``) only when its tensors lie on the CPU;
for CUDA tensors it launches the kernel or raises: there is no
fallback.  The CUDA source is built at first use by
:mod:`repro_torch.kernels._build` (``nvcc``, ``sm_90a``, a shared
library with a plain C interface loaded through ``ctypes``).

The backward is plain PyTorch on either device (the TPU kernel has no
backward either: JAX differentiates the XLA scan).  It *recomputes* the
gates from the saved inputs, one ``x @ wx + h @ wh + b`` per step,
rather than saving the four gate activations: the step's inputs are
saved anyway, so memory stays at the carries.  Its sums are float32
(float64 for float64 inputs), its gradients come back in each input's
type.

The forward is the operator ``torch.ops.repro_torch.lstm_cell``
(``kernels/_library.py``): the plain version on the CPU, the kernel on
the card, a fake route that gives the outputs' shapes for
``FakeTensorMode``, and its cost formulas (:func:`flops`,
:func:`bytes_moved`).

``LAUNCHES`` counts kernel launches (and nothing else), so a run can
show that its main path went through the kernel; ``SHAPES`` collects
each launch's (B, F, H), so it can show which shapes those were.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _library
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref

LAUNCHES = 0
SHAPES: set = set()
ROWS = 16                # batch rows per block (grid.y = ceil(B / ROWS))
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("lstm_cell")
        lib.lstm_cell_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.lstm_cell_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(x, h, c, wx, wh, b):
    B, F = x.shape
    H = h.shape[-1]
    want = {"h": (B, H), "c": (B, H), "wx": (F, 4 * H), "wh": (H, 4 * H),
            "b": (4 * H,)}
    for name, t in (("h", h), ("c", c), ("wx", wx), ("wh", wh), ("b", b)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"lstm_cell: {name} has shape {tuple(t.shape)},"
                             f" expected {want[name]}")
    if x.dtype not in DTYPES:
        raise TypeError(f"lstm_cell kernel takes float32 or bfloat16, x is "
                        f"{x.dtype}")
    for name, t in (("x", x), ("h", h), ("c", c), ("wx", wx), ("wh", wh),
                    ("b", b)):
        if t.dtype != x.dtype:
            raise TypeError(f"lstm_cell: {name} is {t.dtype}, x is "
                            f"{x.dtype}; the kernel takes one type")
        if t.device != x.device:
            raise ValueError(f"lstm_cell: {name} is on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"lstm_cell: {name} is not contiguous")
    if min(B, F, H) < 1:
        raise ValueError(f"lstm_cell kernel takes B, F, H >= 1, got "
                         f"B={B} F={F} H={H}")
    if -(-B // ROWS) > 65535:
        raise ValueError(f"lstm_cell kernel takes B <= {65535 * ROWS}, "
                         f"got {B}")
    return B, F, H


def _cuda(x, h, c, wx, wh, b):
    global LAUNCHES
    B, F, H = _check(x, h, c, wx, wh, b)
    h2 = torch.empty_like(h)
    c2 = torch.empty_like(c)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lstm_cell_launch(
            x.data_ptr(), h.data_ptr(), c.data_ptr(), wx.data_ptr(),
            wh.data_ptr(), b.data_ptr(), h2.data_ptr(), c2.data_ptr(),
            B, F, H, DTYPES[x.dtype], stream)
    _build.raise_on_error(lib, "lstm_cell", err)
    LAUNCHES += 1
    SHAPES.add((B, F, H))
    return h2, c2


def _fake(x, h, c, wx, wh, b):
    return torch.empty_like(h), torch.empty_like(c)


def flops(x_shape, h_shape, c_shape, wx_shape, wh_shape, b_shape,
          out_shape=None) -> int:
    """The gate products ``x @ wx + h @ wh``: ``2 B (F + H) 4H``."""
    (B, F), H = x_shape, h_shape[-1]
    return 2 * B * (F + H) * 4 * H


def bytes_moved(x, h, c, wx, wh, b) -> int:
    """Every input read once, h2 and c2 written once."""
    return _library.nbytes(x, h, c, wx, wh, b, h, c)


_op = _library.define(
    "lstm_cell",
    "(Tensor x, Tensor h, Tensor c, Tensor wx, Tensor wh, Tensor b) "
    "-> (Tensor, Tensor)",
    cpu=lstm_cell_ref, cuda=_cuda, fake=_fake, flops=flops,
    bytes_=bytes_moved)


def _forward(x, h, c, wx, wh, b):
    """The cell without autograd: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lstm_cell: unsupported device {x.device}")
    return _op(x, h, c, wx, wh, b)


class LSTMCell(torch.autograd.Function):
    """One LSTM step with the kernel (or plain) forward and a plain
    backward that recomputes the gates."""

    @staticmethod
    def forward(ctx, x, h, c, wx, wh, b):
        ctx.save_for_backward(x, h, c, wx, wh, b)
        return _forward(x, h, c, wx, wh, b)

    @staticmethod
    def backward(ctx, dh2, dc2):
        x, h, c, wx, wh, b = ctx.saved_tensors
        ct = torch.promote_types(x.dtype, torch.float32)
        x_, h_, c_, wx_, wh_, b_ = (t.to(ct) for t in (x, h, c, wx, wh, b))
        dh2, dc2 = dh2.to(ct), dc2.to(ct)
        gates = x_ @ wx_ + h_ @ wh_ + b_
        ai, af, ag, ao = torch.split(gates, h.shape[-1], dim=-1)
        i, f, o = torch.sigmoid(ai), torch.sigmoid(af), torch.sigmoid(ao)
        g = torch.tanh(ag)
        tc = torch.tanh(f * c_ + i * g)
        dc = dc2 + dh2 * o * (1.0 - tc * tc)
        dgates = torch.cat([dc * g * i * (1.0 - i),
                            dc * c_ * f * (1.0 - f),
                            dc * i * (1.0 - g * g),
                            dh2 * tc * o * (1.0 - o)], dim=-1)
        need = ctx.needs_input_grad
        grads = (dgates @ wx_.t() if need[0] else None,
                 dgates @ wh_.t() if need[1] else None,
                 dc * f if need[2] else None,
                 x_.t() @ dgates if need[3] else None,
                 h_.t() @ dgates if need[4] else None,
                 dgates.sum(0) if need[5] else None)
        return tuple(None if gr is None else gr.to(t.dtype)
                     for gr, t in zip(grads, (x, h, c, wx, wh, b)))


def lstm_cell(x, h, c, wx, wh, b):
    """Fused LSTM step.  x (B,F), h (B,H), c (B,H), wx (F,4H), wh (H,4H),
    b (4H,) -> (h2, c2), each (B,H), differentiable.

    CPU tensors go through :func:`lstm_cell_ref`; CUDA tensors through
    the kernel, which takes contiguous float32 or bfloat16 inputs of one
    type and any B, F, H >= 1.
    """
    return LSTMCell.apply(x, h, c, wx, wh, b)
