"""The harness finds every cell, configuration, traffic mix, limit file
and per-layer reader by its name in ``BENCHMARK.json``, the file keeps
to the benchmark's contract, and the benchmark loads neither JAX nor
the JAX package."""
import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from portbench import harness

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_from_its_files(cell):
    ctx = harness.load_ctx(cell, 1, 1.0, False, "cpu", 0.0)
    assert ctx.config["name"] == ctx.cell["config"]
    assert ctx.traffic["name"] == ctx.cell["traffic"]
    assert set(ctx.limits) >= {"tol_us", "prio_gap", "sa_gap", "sj_off",
                               "job_off", "energy_gap"}
    assert harness.runner(ctx.config).run


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_finds_nothing_in_no_data(metric):
    """A reader with nothing to read returns None, never 0."""
    assert harness.reader(metric)({}) is None


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] == 1
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_runs_load_neither_jax_nor_the_jax_package():
    """A fresh process that imports every module of the benchmark and
    builds a session of each configuration on the CPU holds no module
    whose top-level name is ``jax``, ``jaxlib``, ``flax`` or ``repro``
    (``repro_torch`` is another name)."""
    code = (
        "import sys, json, pkgutil, importlib\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "import portbench\n"
        "for m in pkgutil.walk_packages(portbench.__path__, 'portbench.'):\n"
        "    if '.tests' not in m.name:\n"
        "        importlib.import_module(m.name)\n"
        "from portbench import harness\n"
        "from portbench.runners import relmas\n"
        "for w in harness.bench()['workloads']:\n"
        "    ctx = harness.load_ctx(w['name'], 1, 1.0, True, 'cpu', 0.0)\n"
        "    relmas.Session(ctx.config, 'cpu')\n"
        "    for m in harness.bench()['per_layer']:\n"
        "        harness.reader(m['name'])\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_import_no_jax_and_read_no_reference_benchmarks():
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|repro)\b", re.M)
    reads = re.compile("bench" + r"marks/|BENCH_\w*\.json")
    for path in sorted((ROOT / "portbench").rglob("*.py")):
        text = path.read_text()
        assert not bad.search(text), path
        assert not reads.search(text), path


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.sim.engine", "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(
        ["repro.sim", "jax.numpy", "flax", "jaxlib.xla_client"]) == [
            "flax", "jax", "jaxlib", "repro"]
