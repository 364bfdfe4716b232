"""Wrapper of the event-loop kernel (``csrc/event_loop.cu``): the
contention engine's whole event loop in one launch, one warp a stream.

``sim/engine.py::simulate`` sends every call on CUDA tensors here; the
kernel takes ``n <= MAX_N`` slots on ``1 <= M <= MAX_M`` SAs and raises
a ValueError naming those limits for any other shape (an empty batch,
``S = 0`` or ``n = 0``, gives empty outputs without a launch).  CPU
tensors and the segment engine run the plain version, ``ref.loop``.
The CUDA source is built at first use by :mod:`repro_torch.kernels._build`
(``nvcc``, ``sm_90a``, a shared library with a plain C interface loaded
through ``ctypes``).

The call is the operator ``torch.ops.repro_torch.event_loop``
(``kernels/_library.py``): the plain version on the CPU, the kernel on
the card, a fake route that checks the inputs as the card's does and
gives the outputs' shapes for ``FakeTensorMode``, and its cost formulas
(:func:`flops`, :func:`bytes_moved`).  Inputs go in as the engine's
callers pass them (bool ``valid``, int64 ``assign`` and ``dep``, float32
times and bandwidths, ``B`` a float or an ``(S,)`` tensor): the wrapper
converts or copies only what is of another type or not contiguous, so
the serving tick's call is one launch.

``LAUNCHES`` counts kernel launches (and nothing else), so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, _library
from repro_torch.kernels.event_loop.ref import INF, event_loop_ref

LAUNCHES = 0
MAX_N = 256              # slots a stream: 8 in each lane of a warp
MAX_M = 32               # SAs: one bit each in a warp-wide mask
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("event_loop")
        lib.event_loop_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_float] + [ctypes.c_int] * 3
            + [ctypes.c_float] + [ctypes.c_void_p] * 4)
        lib.event_loop_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


_TYPES = dict(valid=torch.bool, assign=torch.int64, prio=torch.float32,
              cost=torch.float32, bw=torch.float32, dep=torch.int64,
              ready=torch.float32, sa_free=torch.float32)


def _check(valid, assign, prio, cost, bw, dep, ready, sa_free, b_stream,
           num_sas):
    if valid.dim() != 2:
        raise ValueError(f"event_loop: valid has shape {tuple(valid.shape)},"
                         f" expected (S, n)")
    S, n = valid.shape
    if not (n <= MAX_N and 1 <= num_sas <= MAX_M):
        raise ValueError(f"event_loop kernel takes n <= {MAX_N} slots on "
                         f"1 <= M <= {MAX_M} SAs, got S={S} n={n} "
                         f"M={num_sas}")
    named = dict(valid=valid, assign=assign, prio=prio, cost=cost, bw=bw,
                 dep=dep, ready=ready, sa_free=sa_free)
    for name, t in named.items():
        want = (S, num_sas) if name == "sa_free" else (S, n)
        if tuple(t.shape) != want:
            raise ValueError(f"event_loop: {name} has shape "
                             f"{tuple(t.shape)}, expected {want}")
        if t.dtype != _TYPES[name]:
            raise TypeError(f"event_loop: {name} is {t.dtype}, the kernel "
                            f"takes {_TYPES[name]}")
    if b_stream is not None:
        if tuple(b_stream.shape) != (S,) or b_stream.dtype != torch.float32:
            raise ValueError(f"event_loop: b_stream is {b_stream.dtype} "
                             f"{tuple(b_stream.shape)}, expected float32 "
                             f"({S},)")
        named["b_stream"] = b_stream
    for name, t in named.items():
        if t.device != valid.device:
            raise ValueError(f"event_loop: {name} is on {t.device}, valid "
                             f"on {valid.device}")
        if not t.is_contiguous():
            raise ValueError(f"event_loop: {name} is not contiguous")
    return S, n


def _cuda(valid, assign, prio, cost, bw, dep, ready, sa_free, b_stream,
          b_all, num_sas, stop):
    global LAUNCHES
    S, n = _check(valid, assign, prio, cost, bw, dep, ready, sa_free,
                  b_stream, num_sas)
    start = torch.empty((S, n), dtype=torch.float32, device=valid.device)
    finish = torch.empty_like(start)
    if S * n == 0:
        return start, finish, torch.zeros((S,), dtype=torch.int32,
                                          device=valid.device)
    iters = torch.empty((S,), dtype=torch.int32, device=valid.device)
    lib = _lib()
    with torch.cuda.device(valid.device):
        stream = torch.cuda.current_stream(valid.device).cuda_stream
        err = lib.event_loop_launch(
            valid.data_ptr(), assign.data_ptr(), prio.data_ptr(),
            cost.data_ptr(), bw.data_ptr(), dep.data_ptr(), ready.data_ptr(),
            sa_free.data_ptr(),
            None if b_stream is None else b_stream.data_ptr(), b_all, S, n,
            num_sas, stop, start.data_ptr(), finish.data_ptr(),
            iters.data_ptr(), stream)
    _build.raise_on_error(lib, "event_loop", err)
    LAUNCHES += 1
    return start, finish, iters


def _fake(valid, assign, prio, cost, bw, dep, ready, sa_free, b_stream,
          b_all, num_sas, stop):
    S, n = _check(valid, assign, prio, cost, bw, dep, ready, sa_free,
                  b_stream, num_sas)
    start = prio.new_empty((S, n), dtype=torch.float32)
    return (start, torch.empty_like(start),
            prio.new_empty((S,), dtype=torch.int32))


def flops(valid_shape, *args, out_shape=None) -> int:
    """None counted: the loop selects and compares; its few float
    operations a slot and iteration depend on the data and are no model
    arithmetic."""
    return 0


def bytes_moved(valid, assign, prio, cost, bw, dep, ready, sa_free,
                b_stream, b_all, num_sas, stop) -> int:
    """Every input read once; start and finish (S, n) float32 and iters
    (S,) int32 written once."""
    S, n = valid.shape
    ins = [valid, assign, prio, cost, bw, dep, ready, sa_free]
    if b_stream is not None:
        ins.append(b_stream)
    return _library.nbytes(*ins) + S * n * 8 + S * 4


_op = _library.define(
    "event_loop",
    "(Tensor valid, Tensor assign, Tensor prio, Tensor cost, Tensor bw, "
    "Tensor dep, Tensor ready, Tensor sa_free, Tensor? b_stream, "
    "float b_all, int num_sas, float stop) -> (Tensor, Tensor, Tensor)",
    cpu=event_loop_ref, cuda=_cuda, fake=_fake, flops=flops,
    bytes_=bytes_moved)


def event_loop(valid, assign, prio, cost, bw, dep, ready, sa_free, B, *,
               num_sas: int, stop_start_after: float | None = None):
    """The engine's event loop with ``engine.simulate``'s arguments ->
    ``(start, finish, iters)``: ``start``, ``finish`` ``(S, n)`` float32
    as ``simulate`` returns them, ``iters`` ``(S,)`` int32 the
    iterations each stream ran.  CPU tensors run the plain version,
    CUDA tensors the kernel."""
    dev = valid.device
    f32 = torch.float32
    b_stream, b_all = None, 0.0
    if isinstance(B, torch.Tensor) or np.ndim(B) > 0:
        b_stream = torch.as_tensor(B, dtype=f32, device=dev).expand(
            valid.shape[0]).contiguous()
    else:
        b_all = float(B)
    stop = INF if stop_start_after is None else float(stop_start_after)
    args = dict(valid=valid, assign=assign, prio=prio, cost=cost, bw=bw,
                dep=dep, ready=ready, sa_free=sa_free)
    return _op(*(t.to(_TYPES[k]).contiguous() for k, t in args.items()),
               b_stream, b_all, num_sas, stop)
