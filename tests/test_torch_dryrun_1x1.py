"""Every (arch x shape) cell and relmas on a 1x1 mesh, where the steps
take no DTensor: ``launch/dryrun.py`` ``--device cpu --smoke
--mesh-shape 1x1`` for each cell, in three subprocesses of their own
(run side by side, each with a timeout), every cell ``ok``, no kernel
launched.  The kernels trace through their fake routes here (mamba2's
and jamba's ``ssd_intra``, every attention family's ``flash_attention``
and ``decode_gqa``, relmas's ``lstm_cell``)."""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import registry as reg

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300


def _cells():
    return [(a, s) for a in reg.ARCHS
            for s in reg.shapes_for(reg.get_arch(a, smoke=True))] + \
        [("relmas", "train_4k")]


# three groups of about equal trace time: the SSD families' loops over
# chunks trace longest (mamba2's prefill ~25 s, its train and jamba's
# ~12 s each), relmas's 97 steps ~8 s, the rest 1-3 s a cell
_SLOW = {("mamba2-2.7b", "prefill_32k"): 0,
         ("mamba2-2.7b", "train_4k"): 1, ("jamba-v0.1-52b", "train_4k"): 1,
         ("jamba-v0.1-52b", "prefill_32k"): 2, ("relmas", "train_4k"): 2}
GROUPS = [[c for i, c in enumerate(_cells())
           if _SLOW.get(c, i % 3) == g] for g in range(3)]
DRIVER = """
import json, sys
from repro_torch.launch import dryrun as D
rc = 0
for arch, shape in json.loads(sys.argv[1]):
    rc |= D.main(["--device", "cpu", "--smoke", "--mesh-shape", "1x1",
                  "--arch", arch, "--shape", shape, "--out", sys.argv[2]])
print(json.dumps(D._launches()))
sys.exit(rc)
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_1x1")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    procs = []
    for i, group in enumerate(GROUPS):
        out = str(tmp / f"g{i}.jsonl")
        procs.append((out, subprocess.Popen(
            [sys.executable, "-c", DRIVER, json.dumps(group), out], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    recs, launches = [], []
    for out, proc in procs:
        try:
            stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for _, p in procs:
                p.kill()
            raise
        assert proc.returncode == 0, stdout[-3000:] + stderr[-3000:]
        launches.append(json.loads(stdout.strip().splitlines()[-1]))
        recs += [json.loads(line) for line in open(out)]
    return recs, launches


@pytest.mark.parametrize("arch,shape", _cells(),
                         ids=[f"{a}-{s}" for a, s in _cells()])
def test_cell_on_1x1(records, arch, shape):
    recs, _ = records
    (rec,) = [r for r in recs if (r["arch"], r["shape"]) == (arch, shape)]
    assert rec["ok"], rec.get("error")
    assert (rec["mesh"], rec["devices"]) == ("1x1", 1)
    assert rec["cost"]["flops"] > 0
    assert rec["roofline_raw"]["collective_bytes_per_chip"] == 0
    mem = rec["mem"]
    assert mem["per_chip_total_bytes"] == (
        mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        + mem["output_size_in_bytes"] - mem["alias_size_in_bytes"])


def test_no_kernel_launched(records):
    recs, launches = records
    assert len(recs) == len(_cells())
    assert all(not any(n.values()) for n in launches)
