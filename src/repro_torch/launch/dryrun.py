"""Multi-pod dry run: prove the distribution config is coherent, the
port of ``repro.launch.dryrun``.

For every (architecture x input shape) cell this traces the cell's step
(train, prefill or decode) as rank 0 of the production mesh,

  single-pod  (16, 16)    = 256 ranks   (data, model)     [roofline table]
  multi-pod   (2, 16, 16) = 512 ranks   (pod, data, model)

a ``DeviceMesh`` over a ``"fake"`` process group of that many ranks,
under ``FakeTensorMode``: every parameter, moment, cache and batch leaf
is a DTensor placed by ``models/partition.py``, its local block a fake
tensor, so nothing is allocated, no collective moves a byte and no
kernel launches (the kernels trace through their fake routes,
``kernels/_library.py``).  It records this rank's memory (arguments,
outputs, aliases, the peak of live local storage, fits-in-80-GB),
FLOPs and bytes accessed, and the collectives DTensor issues (kind,
count, link bytes), counted by ``launch/hlo_analysis.py``'s
``StepCounter``; the three roofline terms against the H100's
constants; ``n_params``, ``n_active``, ``model_flops`` and the useful
FLOP ratio.  The RELMAS DDPG update is the extra cell ``--arch relmas``.

A cell whose step fails to trace is recorded ``ok: false`` with its
error and traceback; the exit code is 1 if any cell failed.

The process group is process-global, so one process runs one group of
``max(prod(mesh))`` ranks; run each dry run in a process of its own.
``--device cuda`` (the default) traces fake CUDA tensors on a ``cuda``
mesh and needs a card (it allocates nothing on it); ``--device cpu``
traces fake CPU tensors on a ``cpu`` mesh, anywhere.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
      --shape train_4k [--multi-pod] [--out runs/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
      --smoke --mesh-shape 2x4 --arch internlm2-1.8b
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.configs.registry import (ARCHS, batch_specs, cache_specs,
                                          get_arch, shapes_for)
from repro_torch.launch import hlo_analysis as HA
from repro_torch.models import partition as PT
from repro_torch.models import sharding as shd
from repro_torch.telemetry.console import console_line

HBM_PER_CHIP = 80 * 1024 ** 3     # H100 80GB HBM3


def _parse_overrides(pairs: list[str]) -> dict[str, tuple[str, ...]]:
    out = {}
    for p in pairs or []:
        k, v = p.split("=")
        out[k] = tuple(a for a in v.split("+") if a) if v else ()
    return out


def _flat_with_path(tree) -> list:
    out = []
    PT.map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


def _n_params(params_s) -> tuple[int, int]:
    """(total, expert) param counts; ``_active_params`` discounts idle
    experts."""
    total = expert = 0
    for path, leaf in _flat_with_path(params_s):
        ks = PT._keystr(path)
        n = 1
        for d in leaf.shape:
            n *= d
        total += n
        if len(leaf.shape) >= 3 and any(t in ks for t in
                                        ("w_gate", "w_up", "w_down")):
            expert += n
    return total, expert


def _active_params(cfg, params_s) -> int:
    total, expert = _n_params(params_s)
    if cfg.is_moe and expert:
        frac = cfg.top_k / cfg.n_experts
        return int(total - expert + expert * frac)
    return total


# ---------------------------------------------------------------------------
# fake process group and meshes
# ---------------------------------------------------------------------------
def init_fake_group(world_size: int) -> None:
    """A ``"fake"`` process group of ``world_size`` ranks, this process
    rank 0 (once a process; a second call must ask for no more ranks)."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() < world_size:
            raise RuntimeError(f"the fake process group has "
                               f"{dist.get_world_size()} ranks, a mesh "
                               f"needs {world_size}")
        return
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(f"this torch {torch.__version__} has no fake "
                           f"process group (torch.testing._internal."
                           f"distributed.fake_pg): {e}") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


_CUDA_CONTEXT: list[int] = []


def settle_fake_cuda() -> int:
    """Make ``FakeTensorMode``'s CUDA context now: the first fake CUDA
    tensor of a process makes one real 1-element tensor on the card
    (``fake_tensor.init_gpu_context``), freed at once.  Returns its peak
    bytes and resets the peak, so that ``max_memory_allocated`` from
    here on is what the dry run itself allocates (nothing)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    if not _CUDA_CONTEXT:
        with FakeTensorMode():
            torch.empty(1, device="cuda")
        torch.cuda.synchronize()
        _CUDA_CONTEXT.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
    return _CUDA_CONTEXT[0]


def _mesh_dims(spec: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    dims = tuple(int(x) for x in spec.split("x"))
    axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    return dims, axes


def _mesh_from_shape(spec: str, device: str = "cuda"):
    """'2x4' -> (data, model) mesh; '2x2x4' -> (pod, data, model)."""
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(*_mesh_dims(spec), device)


# ---------------------------------------------------------------------------
# abstract state
# ---------------------------------------------------------------------------
def _fake_mode():
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = detect_fake_mode()
    return mode if mode is not None else FakeTensorMode()


def param_specs(cfg, device: str = "cpu"):
    """The parameter tree of ``LM(cfg).init`` as fake tensors (the
    counterpart of ``jax.eval_shape(model.init, key)``): the real init
    traced, nothing drawn or allocated."""
    from repro_torch.models.model import LM
    with _fake_mode():
        gen = torch.Generator(device=device)
        return LM(cfg, device=device).init(gen).params


def _local(x):
    from torch.distributed.tensor import DTensor
    return x._local_tensor if isinstance(x, DTensor) else x


def _leaves(tree) -> list:
    """The leaves of nested dicts, lists, tuples and dataclasses."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return _leaves([getattr(tree, f.name)
                        for f in dataclasses.fields(tree)])
    return [tree]


def _locals(*trees) -> list:
    """The local tensors of ``trees``' tensor leaves (a DTensor's
    block)."""
    return [_local(x) for x in _leaves(trees)
            if isinstance(x, torch.Tensor)]


@dataclasses.dataclass
class Trace:
    """What one traced step gives: cost, collectives, memory, aux."""
    cost: dict
    coll: HA.CollectiveStats
    mem: dict
    aux: dict


def _distinct_bytes(tensors, only: set | None = None) -> int:
    seen: dict[int, int] = {}
    for t in tensors:
        st = t.untyped_storage()
        if only is None or id(st) in only:
            seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _run(fn, args, aux, held=None) -> Trace:
    """Run ``fn(*args)`` under a :class:`hlo_analysis.StepCounter` with
    the local storage of the arguments and of ``held`` (state ``fn``
    reads without taking it: a serving step's module parameters) live
    from the start, all of it counted as arguments."""
    counter = HA.StepCounter()
    arg_t = _locals(*args, held)
    for t in arg_t:
        counter.track(t)
    arg_ids = counter.storage_ids(arg_t)
    arg_bytes = counter.live
    counter.reset_peak()
    with counter:
        out = fn(*args)
    out_t = _locals(out)
    out_bytes = _distinct_bytes(out_t)
    alias = _distinct_bytes(out_t, only=arg_ids)
    return Trace(counter.cost(), counter.collectives(),
                 _mem_stats(arg_bytes, out_bytes, alias, counter.peak),
                 {**aux, "flops_by_op": counter.flops_by_op})


def _mem_stats(args: int, out: int, alias: int, peak: int) -> dict:
    """The reference's ``memory_analysis`` keys for one rank: the
    arguments' local bytes, the outputs', the outputs that are argument
    storage written in place (``alias``), and ``temp``: the peak of live
    local storage during the step above the arguments and the new
    outputs, so that ``per_chip_total_bytes`` (args + temp + out -
    alias) is the peak."""
    temp = max(0, peak - args - (out - alias))
    total = args + temp + out - alias
    return {"argument_size_in_bytes": args, "output_size_in_bytes": out,
            "temp_size_in_bytes": temp, "alias_size_in_bytes": alias,
            "per_chip_total_bytes": total,
            "fits_80GB_hbm": total <= HBM_PER_CHIP}


def _cost(trace: Trace) -> dict:
    return dict(trace.cost)


def _placed(tree, mesh, pls_tree):
    """``tree``'s leaves as DTensors with placements ``pls_tree`` on a
    mesh of several ranks (each rank keeps its block), as they are on
    a mesh of one."""
    if not shd.is_multi(mesh):
        return tree
    if isinstance(tree, dict):
        return {k: _placed(v, mesh, pls_tree[k]) for k, v in tree.items()}
    return shd.place(tree, mesh, pls_tree)


# ---------------------------------------------------------------------------
# cell tracing
# ---------------------------------------------------------------------------
def trace_cell(arch: str, shape_name: str, mesh, *, smoke: bool = False,
               overrides: dict | None = None, grad_accum: int | None = None,
               device: str = "cuda", extrapolate: bool = False) -> Trace:
    """One (arch, shape, mesh) cell; ``extrapolate``: from traces at 1
    and 2 units (``roofline.extrapolated_trace``), not every layer."""
    if arch == "relmas":
        return _trace_relmas_T(mesh, T=97, device=device)
    cfg = get_arch(arch, smoke=smoke)
    if grad_accum is not None:
        cfg = dataclasses.replace(cfg, grad_accum=grad_accum)
    if extrapolate:
        from repro_torch.launch.roofline import extrapolated_trace
        tr = extrapolated_trace(cfg, shape_name, mesh, overrides=overrides,
                                device=device)
        tr.aux["params_s"] = param_specs(cfg, device)
        return tr
    return trace_cfg_cell(cfg, shape_name, mesh, overrides=overrides,
                          device=device)


def trace_cfg_cell(cfg, shape: str | ShapeSpec, mesh, *,
                   overrides: dict | None = None,
                   device: str = "cuda") -> Trace:
    """Trace one step for an explicit ArchConfig (the roofline cost
    modules pass reduced-layer variants here).  ``shape`` is a shape
    name or a ``ShapeSpec``."""
    from repro_torch.models.model import LM
    from repro_torch.models.steps import (make_decode_step,
                                          make_prefill_step, make_train_step)
    from repro_torch.runtime.elastic import device_put_like
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    multi_pod = "pod" in shd.axis_sizes(mesh)
    rules = shd.make_rules(multi_pod, overrides=overrides)
    with _fake_mode():
        model = LM(cfg, device=device).init(torch.Generator(device=device))
        aux = {"params_s": model.params, "cfg": cfg}
        model.params = device_put_like(model.params, mesh, rules)
        if shape.kind == "decode":
            step = make_decode_step(model, mesh=mesh, rules=rules)
            cache = cache_specs(cfg, shape, device)
            cache = _placed(cache, mesh,
                            PT.cache_shardings(cache, mesh, rules))
            batch = batch_specs(cfg, shape, device)
            return _run(step, (cache, batch), aux, held=model.params)
        batch = batch_specs(cfg, shape, device)
        batch = _placed(batch, mesh, PT.batch_shardings(batch, mesh, rules))
        if shape.kind == "prefill":
            step = make_prefill_step(model, mesh=mesh, rules=rules)
            return _run(step, (batch,), aux, held=model.params)
        step, opt = make_train_step(model, mesh=mesh, rules=rules)
        opt_state = opt.init(model.params)
        return _run(lambda p, o, b: step(p, o, b, 0),
                    (model.params, opt_state, batch), aux)


_DP_GROUPS: dict = {}


def _dp_mean(mesh):
    """The mean over this rank's data-parallel ranks (the ``(pod?,
    data)`` axes), as the reference's partitioner makes it of a mean
    over a sharded batch: one functional all-reduce a tensor."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    sizes = shd.axis_sizes(mesh)
    dp = [a for a in ("pod", "data") if a in sizes]
    n = 1
    for a in dp:
        n *= sizes[a]
    if n == 1:
        return lambda xs: xs[0]
    names = list(sizes)
    ranks = mesh.mesh
    for i, name in reversed(list(enumerate(names))):
        if name not in dp:
            ranks = ranks.select(i, 0)
    key = tuple(ranks.flatten().tolist())
    if key not in _DP_GROUPS:
        _DP_GROUPS[key] = dist.new_group(list(key))
    group = _DP_GROUPS[key]
    return lambda xs: funcol.all_reduce(xs[0], "avg", group)


def _trace_relmas_T(mesh, *, T: int = 97, B: int = 4096,
                    device: str = "cuda") -> Trace:
    """The paper's own DDPG update on the production mesh: the replay
    batch split over (pod?, data), the small policy replicated.  Each
    rank runs ``ddpg_update_shards`` on its rows, the gradients and info
    averaged over its data-parallel group (the local-sample topology),
    which is what XLA's partitioner makes of the reference's cell.  T =
    LSTM sequence length (96 RQ slots + primer in production)."""
    from repro_torch.core import ddpg as D
    from repro_torch.core import policy as Pol
    M = 6                                     # paper MAS: 6 SAs
    pcfg = Pol.PolicyConfig(feat_dim=4 + 2 * M, act_dim=1 + M, hidden=256)
    dcfg = D.DDPGConfig(policy=pcfg)
    sizes = shd.axis_sizes(mesh)
    dp = sizes.get("pod", 1) * sizes.get("data", 1)
    if B % dp:
        raise ValueError(f"relmas: batch {B} does not split over {dp} "
                         f"data-parallel ranks")
    Bl = B // dp
    mean = _dp_mean(mesh)
    with _fake_mode():
        state = D.init_ddpg(torch.Generator(), dcfg, device)
        f32 = dict(dtype=torch.float32, device=device)
        batch = dict(
            s=torch.empty((Bl, T, pcfg.feat_dim), **f32),
            mask=torch.empty((Bl, T), dtype=torch.bool, device=device),
            a=torch.empty((Bl, T - 1, pcfg.act_dim), **f32),
            r=torch.empty((Bl,), **f32),
            s2=torch.empty((Bl, T, pcfg.feat_dim), **f32),
            mask2=torch.empty((Bl, T), dtype=torch.bool, device=device))
        return _run(lambda st, b: D.ddpg_update_shards(st, dcfg, [b], mean),
                    (state, batch), {"params_s": None, "cfg": None})


# ---------------------------------------------------------------------------
def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             smoke: bool = False, overrides: dict | None = None,
             grad_accum: int | None = None, verbose: bool = True,
             mesh_shape: str | None = None, roofline: bool = False,
             device: str = "cuda", extrapolate: bool = False) -> dict:
    from repro_torch.launch.mesh import make_production_mesh
    mesh = (_mesh_from_shape(mesh_shape, device) if mesh_shape
            else make_production_mesh(multi_pod=multi_pod,
                                      device_type=device))
    n_dev = math.prod(mesh.shape)
    rec = dict(arch=arch, shape=shape_name,
               mesh="x".join(map(str, tuple(mesh.shape))),
               devices=n_dev, multi_pod=multi_pod, device=device,
               extrapolated=extrapolate,
               overrides={k: list(v) for k, v in (overrides or {}).items()})
    t0 = time.time()
    try:
        trace = trace_cell(arch, shape_name, mesh, smoke=smoke,
                           overrides=overrides, grad_accum=grad_accum,
                           device=device, extrapolate=extrapolate)
        rec["trace_s"] = round(time.time() - t0, 2)
        rec["mem"] = trace.mem
        cost = _cost(trace)
        rec["cost"] = cost
        # the production step's own terms (exact when every layer is
        # traced; affine in the units with --extrapolate)
        rec["roofline_raw"] = HA.roofline_terms(cost, trace.coll, n_dev)
        if roofline and not smoke:
            from repro_torch.launch.roofline import roofline_cell
            t2 = time.time()
            rec["roofline"] = roofline_cell(arch, shape_name, mesh,
                                            overrides=overrides,
                                            device=device)
            rec["roofline_s"] = round(time.time() - t2, 2)
        if trace.aux.get("cfg") is not None:
            cfg = trace.aux["cfg"]
            total, _ = _n_params(trace.aux["params_s"])
            active = _active_params(cfg, trace.aux["params_s"])
            rec["n_params"] = total
            rec["n_active"] = active
            mf = HA.model_flops(cfg, SHAPES[shape_name], total, active)
            rec["model_flops"] = mf
            flops_chip = rec.get("roofline", {}).get(
                "flops_per_chip", cost.get("flops", 0.0))
            traced_total = flops_chip * n_dev
            rec["useful_flop_ratio"] = (mf / traced_total if traced_total
                                        else 0.0)
        rec["ok"] = True
    except Exception as e:
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    if verbose:
        dom = rec.get("roofline", rec.get("roofline_raw", {})).get(
            "dominant", "-")
        console_line(f"[dryrun] {arch:>16s} x {shape_name:<12s} "
                     f"mesh={rec['mesh']:>8s} "
                     f"ok={rec['ok']} dominant={dom} "
                     f"(trace {rec.get('trace_s', '-')}s)")
        if rec["ok"]:
            console_line("  memory: " + json.dumps(rec["mem"]))
            console_line("  cost: " + json.dumps(rec["cost"]))
        else:
            console_line("  ERROR: " + str(rec["error"]))
    return rec


def _launches() -> dict[str, int]:
    from repro_torch.kernels.decode_gqa import ops as dec
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.lstm_cell import ops as cell
    from repro_torch.kernels.lstm_seq import ops as seq
    from repro_torch.kernels.ssd_chunk import ops as ssd
    return {"lstm_seq": seq.LAUNCHES, "flash_attention": fa.LAUNCHES,
            "decode_gqa": dec.LAUNCHES, "ssd_chunk": ssd.LAUNCHES,
            "lstm_cell": cell.LAUNCHES}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="arch id or 'relmas' (default: all)")
    ap.add_argument("--shape", default=None, help="shape id (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="use reduced configs (CI)")
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--override", action="append", default=[],
                    help="logical=axis[+axis] sharding-rule override")
    ap.add_argument("--mesh-shape", default=None,
                    help="a smaller mesh, e.g. 2x4 or 2x2x2")
    ap.add_argument("--roofline", action="store_true",
                    help="also trace the 1- and 2-unit cost modules for "
                         "the roofline terms (single-pod table)")
    ap.add_argument("--extrapolate", action="store_true",
                    help="trace the production step at 1 and 2 units and "
                         "extrapolate (deep models: llama3-405b)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device (cuda needs a card)")
    ap.add_argument("--out", default=None, help="append JSONL here")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device
    resolve_device(args.device)
    context = settle_fake_cuda() if args.device == "cuda" else 0

    overrides = _parse_overrides(args.override)
    cells: list[tuple[str, str]] = []
    archs = [args.arch] if args.arch else list(ARCHS) + ["relmas"]
    for a in archs:
        if a == "relmas":
            cells.append((a, "train_4k"))
            continue
        shp = ([args.shape] if args.shape
               else shapes_for(get_arch(a, smoke=args.smoke)))
        cells += [(a, s) for s in shp]
    meshes = [False, True] if (args.both_meshes or args.all) else \
        [args.multi_pod]
    world = (math.prod(_mesh_dims(args.mesh_shape)[0]) if args.mesh_shape
             else 512 if any(meshes) else 256)
    init_fake_group(world)

    n_fail = 0
    for arch, shape in cells:
        for mp in meshes:
            rec = run_cell(arch, shape, multi_pod=mp, smoke=args.smoke,
                           overrides=overrides, grad_accum=args.grad_accum,
                           mesh_shape=args.mesh_shape,
                           roofline=args.roofline and not mp,
                           device=args.device, extrapolate=args.extrapolate)
            n_fail += 0 if rec["ok"] else 1
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    alloc = (torch.cuda.max_memory_allocated()
             if args.device == "cuda" else 0)
    console_line(f"[dryrun] done: {len(cells) * len(meshes)} cells, "
                 f"{n_fail} failures; kernel launches "
                 f"{json.dumps(_launches())}; max_memory_allocated {alloc}"
                 + (f" (FakeTensorMode's CUDA context before: {context} B, "
                    f"freed)" if context else ""))
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
