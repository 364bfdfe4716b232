"""Roofline-term extraction from a traced step, the port of
``repro.launch.hlo_analysis``.

The reference reads the partitioned HLO text of a compiled step.  The
port has no HLO: a dispatch trace stands in for it.  :class:`StepCounter`
is a ``TorchDispatchMode`` that sees every operator one rank runs while
the step is traced on fake tensors (``launch/dryrun.py``), and counts:

- FLOPs: ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention) and the kernels' own
  (``kernels/_library.py``); elementwise work is not counted, as
  ``FlopCounterMode`` does not count it;
- bytes accessed: each operator's input plus output bytes; views and
  metadata operators are free, allocations too, and the kernels use
  their bytes formulas;
- collectives: the ``_c10d_functional`` operators DTensor and the
  training code issue (``all_gather_into_tensor``, ``all_reduce``,
  ``reduce_scatter_tensor``, ``all_to_all_single``, ``broadcast``, their
  coalesced forms) and ``_dtensor.shard_dim_alltoall``: each one's
  result bytes and group size, turned into per-chip link bytes with the
  reference's ring factors (:data:`_TRAFFIC_FACTOR`):

    all-gather       (n-1)/n * Z      (Z = gathered result bytes)
    all-reduce       2 (n-1)/n * Z    (reduce-scatter + all-gather)
    reduce-scatter   (n-1)/n * Z * n  (Z = scattered result -> full = Z*n)
    all-to-all       (n-1)/n * Z      (Z = per-chip payload)
    collective-permute  Z

- live memory: every local storage an operator creates, from its
  creation until it is freed, and its peak (``dryrun._mem_stats``).

Only one rank's **local** operators count.  An operator with a
``DTensor`` among its arguments is passed on (``NotImplemented``) to
DTensor, whose local operators then come back through the mode and are
counted; the global-shape operators DTensor's sharding propagation runs
to infer output shapes are not counted.  (``FlopCounterMode`` around
DTensor code counts both the global and the local product.)

The reference's HLO-text helpers (``_shape_bytes``, ``_group_size``,
the regexes) have no counterpart: the operators' tensors carry their
shapes and their process group.

Hardware constants, NVIDIA H100 SXM (80 GB HBM3): 989 TFLOP/s bf16
dense (tensor cores), 3.35 TB/s HBM, and NVLink 4 at 18 links of
26.562 GB/s each way (``nvidia-smi nvlink -s`` on an H100 80GB HBM3,
700 W): 478 GB/s a direction, the per-chip link rate of the collective
term.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

PEAK_FLOPS = 989e12          # bf16 dense per chip
HBM_BW = 3.35e12             # bytes/s per chip
NVLINK_BW = 18 * 26.562e9    # bytes/s per chip, one direction

_TRAFFIC_FACTOR = {
    # per-chip link bytes as a multiple of (result bytes), given group n
    "all-gather": lambda z, n: z * (n - 1) / max(n, 1),
    "all-reduce": lambda z, n: 2.0 * z * (n - 1) / max(n, 1),
    "reduce-scatter": lambda z, n: z * (n - 1),
    "all-to-all": lambda z, n: z * (n - 1) / max(n, 1),
    "collective-permute": lambda z, n: float(z),
}

# the functional collectives, by overload packet name -> the reference's
# kind; broadcast sends each chip the whole payload once, as a permute
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}
# operators that move no bytes: allocation, metadata, waits
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "wait_tensor", "device", "size", "stride",
         "sym_size", "sym_stride", "numel", "sym_numel", "dim",
         "is_contiguous", "storage_offset", "sym_storage_offset", "layout",
         "_local_scalar_dense", "lift_fresh", "detach", "alias"}


@dataclasses.dataclass
class CollectiveStats:
    per_chip_bytes: float
    by_op: dict[str, float]
    counts: dict[str, int]

    def to_dict(self):
        return {"per_chip_bytes": self.per_chip_bytes, "by_op": self.by_op,
                "counts": self.counts}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _group_size(args) -> int:
    """The group size of a functional collective: its ``group_name``
    argument resolved to the process group."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in reversed(args):
        if isinstance(a, str):
            return _resolve_process_group(a).size()
    raise ValueError(f"no group name among {args}")


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding propagation is on the stack: it runs
    operators on global-shape fake tensors to infer output metadata,
    work no rank does."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


class StepCounter(TorchDispatchMode):
    """Counts one rank's local FLOPs, bytes, collectives and live
    storage while a step runs (on fake tensors in the dry run; the
    counts do not read data, so real tensors count the same)."""

    def __init__(self):
        super().__init__()
        from repro_torch.kernels import _library
        from torch.utils.flop_counter import flop_registry
        self._flops_of = flop_registry
        self._bytes_of = _library.BYTES
        self.flops = 0.0
        self.bytes = 0.0
        self.by_op: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.flops_by_op: dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}
        self._refs: dict[int, weakref.ref] = {}

    # ------------------------------------------------------------ memory
    def track(self, t) -> None:
        """Count ``t``'s storage as live from now until it is freed."""
        if not isinstance(t, torch.Tensor) or _is_dtensor(t):
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)

        def gone(_, key=key):
            self.live -= self._storages.pop(key, 0)
            self._refs.pop(key, None)
        self._refs[key] = weakref.ref(st, gone)

    def storage_ids(self, tensors) -> set[int]:
        return {id(t.untyped_storage()) for t in tensors
                if isinstance(t, torch.Tensor) and not _is_dtensor(t)}

    def reset_peak(self) -> None:
        self.peak = self.live

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_sharding_propagation():
            return out
        name = func._overloadpacket.__name__
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            z = sum(_nbytes(t) for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor))
            n = _group_size(list(args) + list(kwargs.values()))
            self.by_op[kind] = (self.by_op.get(kind, 0.0)
                                + _TRAFFIC_FACTOR[kind](z, n))
            self.counts[kind] = self.counts.get(kind, 0) + 1
        else:
            packet = func._overloadpacket
            if packet in self._flops_of:
                f = float(self._flops_of[packet](*args, **kwargs,
                                                 out_val=out))
                self.flops += f
                self.flops_by_op[name] = self.flops_by_op.get(name, 0.0) + f
            if packet in self._bytes_of:
                self.bytes += self._bytes_of[packet](*args, **kwargs)
            elif not func.is_view and name not in _FREE:
                self.bytes += sum(
                    _nbytes(t) for t in tree_leaves((args, kwargs, out))
                    if isinstance(t, torch.Tensor))
        for t in tree_leaves(out):
            self.track(t)
        return out

    def collectives(self) -> CollectiveStats:
        return CollectiveStats(sum(self.by_op.values()), dict(self.by_op),
                               dict(self.counts))

    def cost(self) -> dict:
        return {"flops": self.flops, "bytes accessed": self.bytes}


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, type) and issubclass(t, DTensor)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def roofline_terms(cost: dict, coll: CollectiveStats, num_devices: int,
                   *, flops_are_per_device: bool = True) -> dict:
    """Three roofline terms in seconds (per the assignment's formulas)."""
    flops = float(cost.get("flops", 0.0))
    bytes_ = float(cost.get("bytes accessed", 0.0))
    if not flops_are_per_device:
        flops /= num_devices
        bytes_ /= num_devices
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_ / HBM_BW
    t_coll = coll.per_chip_bytes / NVLINK_BW
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return {
        "flops_per_chip": flops, "bytes_per_chip": bytes_,
        "collective_bytes_per_chip": coll.per_chip_bytes,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "collectives": coll.to_dict(),
    }


def model_flops(cfg, shape, n_params: int, n_active: int | None = None) -> float:
    """6·N·D train / 2·N·D inference FLOPs (N active for MoE)."""
    n = n_active if n_active is not None else n_params
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch     # decode: one token per row
