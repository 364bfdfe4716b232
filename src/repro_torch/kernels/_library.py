"""The hand-written kernels as PyTorch operators, ``torch.ops.repro_torch.*``.

Each kernel wrapper defines one operator here with three routes:

- ``CPU``: the kernel's plain PyTorch version;
- ``CUDA``: the checks, the launch and the launch counter (nothing
  else counts a launch);
- a fake route (``torch.library.register_fake``): the output's shape and
  dtype, computed from the inputs' shapes alone, so that
  ``FakeTensorMode`` traces through a kernel without data, without a
  launch and without reading ``data_ptr()``.

Each operator also carries two cost formulas: its FLOPs, registered with
``torch.utils.flop_counter.register_flop_formula`` (so ``FlopCounterMode``
and the dry run read it), and its bytes, in :data:`BYTES`, read by
``launch/hlo_analysis.py``.  Both count the work of the function the
kernel computes, stated by the formula's docstring, not of a particular
plain version.

The operators are registered with ``torch.library.Library`` (``DEF`` /
``impl`` per dispatch key) rather than ``torch.library.custom_op``: the
decode and training loops are host-bound, and the plain ``Library``
route adds less host time a call.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

NS = "repro_torch"
_LIB = torch.library.Library(NS, "FRAGMENT")
# OpOverloadPacket -> fn(*args) -> bytes the kernel reads and writes
BYTES: dict = {}


def nbytes(*xs) -> int:
    """Bytes of the tensors ``xs`` (each read or written once)."""
    return sum(x.numel() * x.element_size() for x in xs)


def define(name: str, schema: str, *, cpu, cuda, fake, flops, bytes_):
    """Define ``repro_torch::name`` with ``schema`` (its arguments and
    results, as ``"(Tensor q, ...) -> Tensor"``): ``cpu`` and ``cuda``
    are its kernels on those devices, ``fake`` its shape function,
    ``flops(*shapes_and_args, out_shape=...)`` its FLOP count and
    ``bytes_(*args)`` its bytes.  Returns the operator's overload."""
    _LIB.define(name + schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NS}::{name}", fake, lib=_LIB)
    packet = getattr(getattr(torch.ops, NS), name)
    register_flop_formula(packet)(flops)
    BYTES[packet] = bytes_
    return packet.default
