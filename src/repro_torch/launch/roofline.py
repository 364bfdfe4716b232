"""Roofline terms from cost modules, the port of ``repro.launch.roofline``.

The reference compiles *cost modules* because ``HloCostAnalysis`` counts
a ``while`` body once: the production step (scan over layers, q-block
chunked attention, grad-accumulation scan) under-reports its work by the
loop trip counts.  The port's trace counts every operator each time it
runs, so the production step's own trace (``dryrun.trace_cell``) is
already exact; the cost modules are kept because they make a cell with
many layers (llama3-405b's 126) cheap to cost: two traces at 1 and 2
units instead of one at full depth, and every cost is affine in the
unit count,

    total(U) = A + (U - 1) * (B - A)

with U = n_layers (dense / moe / ssm), n_superblocks (jamba), or
enc == dec layers (whisper).  The fixed part (embedding, LM head, loss)
lives in A; the per-unit delta covers a layer's forward and backward,
its optimizer update and its collectives.  Collective traffic is
extrapolated per kind the same way.

Of the reference's cost-module fields only ``n_layers`` (and
``enc_layers``) and ``grad_accum=1`` mean anything here: the port runs
no scan (``scan_unroll``) and its attention is one kernel call, not a
q-block loop (``attn_block_q``), so those two are left as they are.

The RELMAS DDPG cell extrapolates over the LSTM *timestep* count
(T = ready-queue slots) instead of layers.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_arch
from repro_torch.launch import hlo_analysis as HA

_COST_KEYS = ("flops", "bytes accessed")


def _unit_counts(cfg) -> tuple[int, int, int]:
    """(units_total, la, lb): unit granularity for the A/B modules."""
    if cfg.family == "hybrid":
        u = cfg.attn_every
        return cfg.n_layers // u, u, 2 * u
    if cfg.family == "encdec":
        assert cfg.enc_layers == cfg.n_layers, "extrapolation assumes 1:1"
        return cfg.n_layers, 1, 2
    return cfg.n_layers, 1, 2


def _unit_cfg(cfg, n_layers: int):
    kw = dict(n_layers=n_layers)
    if cfg.family == "encdec":
        kw["enc_layers"] = n_layers
    return dataclasses.replace(cfg, **kw)


def _cost_cfg(cfg, n_layers: int):
    return dataclasses.replace(_unit_cfg(cfg, n_layers), grad_accum=1)


def _flat(trace) -> dict:
    """A trace's cost and collectives as one flat dict."""
    out = {k: float(trace.cost.get(k, 0.0)) for k in _COST_KEYS}
    for op, v in trace.coll.by_op.items():
        out[f"coll/{op}"] = v
    return out


def _measure(cfg, shape_name: str, mesh, overrides, device: str):
    """Trace one cost module; return flat cost dict + collectives."""
    from repro_torch.launch.dryrun import trace_cfg_cell
    return _flat(trace_cfg_cell(cfg, shape_name, mesh, overrides=overrides,
                                device=device))


def _affine_total(A: dict, Bv: dict, units: int) -> dict:
    keys = set(A) | set(Bv)
    return {k: A.get(k, 0.0) + (units - 1) * (Bv.get(k, 0.0) - A.get(k, 0.0))
            for k in keys}


def extrapolated_trace(cfg, shape_name: str, mesh, *, overrides=None,
                       device: str = "cuda"):
    """The production step of a deep model without tracing every layer:
    traces of ``cfg`` itself (its ``grad_accum`` kept) at 1 and 2 units,
    every count and memory figure extrapolated affinely to the model's
    units (exact for the counts and the argument bytes; the peak grows
    by a unit's saved activations and state a unit)."""
    from repro_torch.launch.dryrun import Trace, _mem_stats, trace_cfg_cell
    units, la, lb = _unit_counts(cfg)
    A, B = (trace_cfg_cell(_unit_cfg(cfg, n), shape_name, mesh,
                           overrides=overrides, device=device)
            for n in (la, lb))
    lin = lambda a, b: a + (units - 1) * (b - a)    # noqa: E731
    cost = {k: lin(A.cost[k], B.cost[k]) for k in A.cost}
    by_op = _affine_total(A.coll.by_op, B.coll.by_op, units)
    counts = {k: int(v) for k, v in _affine_total(
        A.coll.counts, B.coll.counts, units).items()}
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "per_chip_total_bytes")
    m = {k: int(lin(A.mem[k], B.mem[k])) for k in keys}
    args, out, alias = (m[k] for k in keys[:3])
    mem = _mem_stats(args, out, alias, m["per_chip_total_bytes"])
    mem["extrapolated_from_units"] = [la, lb]
    return Trace(cost, HA.CollectiveStats(sum(by_op.values()), by_op,
                                          counts), mem,
                 {"params_s": None, "cfg": cfg})


def roofline_cell(arch: str, shape_name: str, mesh, *, overrides=None,
                  device: str = "cuda") -> dict:
    """Per-device roofline terms for one (arch, shape, mesh)."""
    if arch == "relmas":
        return _roofline_relmas(mesh, device)
    cfg = get_arch(arch)
    units, la, lb = _unit_counts(cfg)
    A = _measure(_cost_cfg(cfg, la), shape_name, mesh, overrides, device)
    Bv = _measure(_cost_cfg(cfg, lb), shape_name, mesh, overrides, device)
    tot = _affine_total(A, Bv, units)
    return _terms(tot, math.prod(mesh.shape),
                  extras={"units": units, "A": A, "B": Bv})


def _terms(tot: dict, n_dev: int, extras: dict | None = None) -> dict:
    coll_bytes = sum(v for k, v in tot.items() if k.startswith("coll/"))
    t_compute = tot.get("flops", 0.0) / HA.PEAK_FLOPS
    t_memory = tot.get("bytes accessed", 0.0) / HA.HBM_BW
    t_coll = coll_bytes / HA.NVLINK_BW
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    rec = {
        "flops_per_chip": tot.get("flops", 0.0),
        "bytes_per_chip": tot.get("bytes accessed", 0.0),
        "collective_bytes_per_chip": coll_bytes,
        "coll_by_op": {k[5:]: v for k, v in tot.items()
                       if k.startswith("coll/")},
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "devices": n_dev,
    }
    if extras:
        rec.update(extras)
    return rec


def _roofline_relmas(mesh, device: str = "cuda") -> dict:
    """DDPG update cost: extrapolate over LSTM timesteps T."""
    from repro_torch.launch.dryrun import _trace_relmas_T
    res = {T: _flat(_trace_relmas_T(mesh, T=T, device=device))
           for T in (2, 3)}
    T_full = 97                         # 96 RQ slots + primer
    tot = _affine_total(res[2], res[3], T_full - 1)
    return _terms(tot, math.prod(mesh.shape), extras={"units": T_full,
                                                  "A": res[2], "B": res[3]})


def model_flops_entry(arch: str, shape_name: str) -> dict:
    """6ND / 2ND reference FLOPs (global) for the useful-compute ratio."""
    from repro_torch.launch.dryrun import (_active_params, _n_params,
                                           param_specs)
    cfg = get_arch(arch)
    params_s = param_specs(cfg)
    total, _ = _n_params(params_s)
    active = _active_params(cfg, params_s)
    return {"n_params": total, "n_active": active,
            "model_flops": HA.model_flops(cfg, SHAPES[shape_name], total,
                                          active)}
