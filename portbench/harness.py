"""The benchmark's harness: finds a cell's configuration, traffic mix,
limits and per-layer readers by the names in ``BENCHMARK.json``, runs the
configuration's runner once, decides ``correct`` and builds the result
line.

Files, all found by name:

- ``portbench/configs/<config>.json``: the deployment (its ``runner``
  picks ``portbench/runners/<runner>.py``);
- ``portbench/traffic/<traffic>.json``: the traffic mix;
- ``portbench/limits/<cell>.json``: the comparison's limits;
- ``portbench/metrics/<metric>.py``: one reader per per-layer metric,
  ``read(data) -> float | None``.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@dataclasses.dataclass
class Ctx:
    name: str
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    # also judge the control (this device runs its TF32 products)
    control: str | None = None
    # copy the sampled streams' rows for the comparison (off only in a
    # measurement of that copy's cost, which then decides nothing)
    capture: bool = True


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(kind: str, name: str) -> str:
    if not NAME.match(name) or name.startswith("."):
        raise ValueError(f"bad {kind} name {name!r}")
    return name


def bench(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def load_ctx(name: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, root: Path = ROOT) -> Ctx:
    b = bench(root)
    cells = {w["name"]: w for w in b["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[name]
    entry = {c["name"]: c for c in b["configs"]}[cell["config"]]
    config = _json(root / entry["file"])
    traffic = _json(HERE / "traffic" / f"{_named('traffic', cell['traffic'])}.json")
    limits = _json(HERE / "limits" / f"{_named('cell', name)}.json")
    return Ctx(name, cell, config, traffic, limits, seed % 2 ** 64, seconds,
               trace, device, t_start)


def metrics_for(b: dict, key: str, cell: str) -> list:
    return [m for m in b[key] if cell in m.get("workloads", [cell])]


def reader(metric: str):
    path = HERE / "metrics" / f"{_named('metric', metric)}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def runner(config: dict):
    return importlib.import_module(
        f"portbench.runners.{_named('runner', config['runner'])}")


def forbidden_modules(names=None) -> list:
    """Top-level names among ``names`` (default: the loaded modules) that
    the port's run must not load (compared whole: ``repro_torch`` is not
    ``repro``)."""
    tops = {m.split(".")[0] for m in list(sys.modules if names is None
                                          else names)}
    return sorted(tops & set(FORBIDDEN))


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return dict(nvidia_smi=p.stdout.strip().splitlines())
    except (OSError, subprocess.SubprocessError) as e:
        return dict(nvidia_smi=[f"unavailable: {e}"])


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and the numbers compared beside their limits."""
    checks = {}
    ok = True
    for k, lim in limits.items():
        if k == "tol_us":
            continue
        v = float(readings[k])
        checks[k] = dict(value=v, limit=float(lim))
        ok &= v <= lim
    return ok, checks


def run_cell(ctx: Ctx, root: Path = ROOT) -> tuple[dict, dict]:
    """Run the cell once.  Returns the result line's object and the
    runner's raw result."""
    b = bench(root)
    res = runner(ctx.config).run(ctx)
    ok, checks = judge(res["readings"], ctx.limits)
    out = dict(correct=bool(ok), attempted=int(res["attempted"]),
               failed=int(res["failed"]))
    if not ctx.trace:
        units = {m["name"]: m["unit"]
                 for m in metrics_for(b, "end_to_end", ctx.name)}
        out["metrics"] = {k: dict(value=float(res["metrics"][k]), unit=u)
                          for k, u in units.items()}
    else:
        data = res["data"]
        mets = {}
        for m in metrics_for(b, "per_layer", ctx.name):
            v = reader(m["name"])(data)
            if v is not None:
                mets[m["name"]] = dict(value=float(v), unit=m["unit"])
        out["metrics"] = mets
    device = dict(platform="gpu" if ctx.device != "cpu" else "cpu",
                  kind="", count=int(ctx.cell["chips"]),
                  memory_peak_bytes=int(res["memory_peak_bytes"]))
    if ctx.trace and "window" in res["data"]:
        from portbench import yardstick as ys
        data = res["data"]
        lo, hi = data["window"]
        device["busy_s"] = ys.busy_seconds(data["device_events"], lo, hi)
        device["window_s"] = hi - lo
        gaps = ys.idle_gaps(data["device_events"], lo, hi)
        cut = lambda rows: [[n[:120], v] for n, v in rows]
        out["breakdown"] = dict(
            device_ops=cut(ys.device_time_by_name(data["device_events"],
                                                  lo, hi)),
            idle_gaps=cut(ys.gaps_by_host_op(gaps, data["host_events"])))
    out["device"] = device
    out["checks"] = checks
    return out, res


def main(argv, t_start: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    ctx = load_ctx(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda", t_start)
    import torch
    torch.set_num_threads(1)
    chips = int(ctx.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"is_available={torch.cuda.is_available()} "
              f"count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out, res = run_cell(ctx)
    out["device"]["kind"] = torch.cuda.get_device_name(0)
    out["checks"] = out.pop("checks")          # keep it the last key
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    info = dict(card=card(), window_calls=res.get("window_calls"),
                call_s=res.get("call_s"), check_s=res.get("check_s"),
                capture_s=res.get("capture_s"),
                setup_parts=res.get("setup_parts"),
                compared=res["readings"].get("compared"),
                notes=res["readings"].get("notes", [])[:5])
    if ctx.trace:
        info["device_kinds"] = res["data"].get("device_kinds")
    print("portbench: " + json.dumps(info), file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
