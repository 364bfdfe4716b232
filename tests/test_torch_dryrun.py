"""The dry run (``python -m repro_torch.launch.dryrun``) on the CPU, in
subprocesses of their own (the fake process group is process-global),
each with a timeout: ``--device cpu --smoke`` on a 2x4 (data, model)
mesh for every arch and shape and relmas, on 2x2x2 (pod, data, model)
for internlm2-1.8b's train cell, and with ``--override expert=data``.

- every family's train / prefill / decode cell is ``ok`` on 2x4 (the
  MoE, SSM, hybrid and whisper-decode cells since ROADMAP A.5), and so
  is olmoe's train cell with ``--override expert=data``;
- internlm2-1.8b ``train_4k`` on 2x2x2 is ``ok`` with ``devices == 8``;
- relmas on 2x4: its collective bytes within 1% of the reference's
  (2,532,400 in the reference's own dry run here: the actor's and the
  critic's gradient bytes, all-reduced over the data axis of 2, and 16
  bytes of info);
- a rank's argument bytes equal the sum of ``partition``'s local shapes
  of its parameters, moments, batch and cache;
- no kernel launches.
"""
import json
import os
import subprocess
import sys

import jax
import pytest
import torch

from repro.core import ddpg as ref_ddpg
from repro.core import policy as ref_policy
from repro_torch.configs import registry as reg
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import partition as PT
from repro_torch.models import sharding as shd
from repro_torch.optim import make_optimizer

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300


def _start(args, out):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
           "cpu", *args, "--out", out]
    return subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc, out):
    try:
        stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    done = [line for line in stdout.splitlines()
            if line.startswith("[dryrun] done")]
    assert done, stdout[-2000:] + stderr[-2000:]
    recs = [json.loads(line) for line in open(out)] \
        if os.path.exists(out) else []
    return proc.returncode, done[-1], recs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    jobs = {"2x4": ["--smoke", "--mesh-shape", "2x4"],
            "2x2x2": ["--smoke", "--mesh-shape", "2x2x2", "--arch",
                      "internlm2-1.8b", "--shape", "train_4k"],
            "override": ["--smoke", "--mesh-shape", "2x4", "--arch",
                         "olmoe-1b-7b", "--shape", "train_4k",
                         "--override", "expert=data"]}
    procs = {k: _start(v, str(tmp / f"{k}.jsonl")) for k, v in jobs.items()}
    return {k: _finish(p, str(tmp / f"{k}.jsonl")) for k, p in procs.items()}


def _cells():
    return [pytest.param(a, s, id=f"{a}-{s}") for a in reg.ARCHS
            for s in reg.shapes_for(reg.get_arch(a, smoke=True))]


def _rec(recs, arch, shape):
    (rec,) = [r for r in recs if (r["arch"], r["shape"]) == (arch, shape)]
    return rec


@pytest.mark.parametrize("arch,shape", _cells())
def test_cell_on_2x4(runs, arch, shape):
    rc, done, recs = runs["2x4"]
    rec = _rec(recs, arch, shape)
    assert (rec["mesh"], rec["devices"]) == ("2x4", 8)
    assert rec["ok"], rec.get("error")
    assert rec["cost"]["flops"] > 0 and rec["n_params"] > 0
    assert rec["mem"]["per_chip_total_bytes"] >= \
        rec["mem"]["argument_size_in_bytes"]


def test_sweep_records_every_cell_and_launches_nothing(runs):
    rc, done, recs = runs["2x4"]
    n = sum(len(reg.shapes_for(reg.get_arch(a, smoke=True)))
            for a in reg.ARCHS) + 1
    assert len(recs) == n
    assert [(r["arch"], r["shape"]) for r in recs if not r["ok"]] == []
    assert rc == 0
    assert done.endswith(
        'kernel launches {"lstm_seq": 0, "flash_attention": 0, '
        '"decode_gqa": 0, "ssd_chunk": 0, "lstm_cell": 0}; '
        'max_memory_allocated 0')


def test_multipod_mesh(runs):
    rc, _, recs = runs["2x2x2"]
    assert rc == 0
    (rec,) = recs
    assert rec["ok"], rec.get("error")
    assert (rec["mesh"], rec["devices"]) == ("2x2x2", 8)
    # the weights' FSDP dims split over (pod, data): a rank holds less
    # of them than on 2x4, whose data axis is 2
    on_2x4 = _rec(runs["2x4"][2], "internlm2-1.8b", "train_4k")
    assert rec["mem"]["argument_size_in_bytes"] < \
        on_2x4["mem"]["argument_size_in_bytes"]


def test_sharding_override_changes_collectives(runs):
    rc, _, recs = runs["override"]
    (rec,) = recs
    assert rec["overrides"] == {"expert": ["data"]}
    assert rec["ok"], rec.get("error")
    assert rc == 0
    # the experts over the data axis move other bytes than over the model
    # axis (the default rules' cell in the 2x4 sweep)
    default = _rec(runs["2x4"][2], "olmoe-1b-7b", "train_4k")
    assert rec["roofline_raw"]["collectives"] != \
        default["roofline_raw"]["collectives"]


def test_relmas_cell_is_the_references(runs):
    pcfg = ref_policy.PolicyConfig(feat_dim=16, act_dim=7, hidden=256)
    state = jax.eval_shape(lambda k: ref_ddpg.init_ddpg(
        k, ref_ddpg.DDPGConfig(policy=pcfg)), jax.random.PRNGKey(0))
    grads = sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(
        (state.actor, state.critic)))
    # the reference's dry run here: collective_bytes_per_chip 2,532,400,
    # the gradients and the four info scalars all-reduced over data = 2
    assert grads + 4 * 4 == 2_532_400
    rec = _rec(runs["2x4"][2], "relmas", "train_4k")
    assert rec["ok"], rec.get("error")
    got = rec["roofline_raw"]["collective_bytes_per_chip"]
    assert abs(got / 2_532_400 - 1) < 0.01
    assert list(rec["roofline_raw"]["collectives"]["by_op"]) == \
        ["all-reduce"]
    # the learner state (four nets, two Adam moment pairs) replicated,
    # the replay batch split over the data axis
    nets = sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(state)
               if x.ndim > 0)
    T, F, G, B = 97, 16, 7, 4096 // 2
    batch = B * (2 * T * F * 4 + 2 * T + (T - 1) * G * 4 + 4)
    assert rec["mem"]["argument_size_in_bytes"] == nets + batch


def _local_bytes(tree, pls, mesh) -> int:
    """Bytes of a rank's blocks of ``tree``'s leaves under ``pls``."""
    if isinstance(tree, dict):
        return sum(_local_bytes(tree[k], pls[k], mesh) for k in tree)
    return _prod(shd.local_shape(tree.shape, pls, mesh)) * \
        tree.element_size()


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= x
    return n


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_argument_bytes_are_partitions_local_shapes(runs, shape):
    cfg = reg.get_arch("internlm2-1.8b", smoke=True)
    mesh = AbstractMesh((2, 4), ("data", "model"))
    rules = shd.make_rules(False)
    spec = SHAPES[shape]
    params = dryrun.param_specs(cfg)
    want = _local_bytes(params, PT.param_shardings(params, mesh, rules),
                        mesh)
    if spec.kind == "decode":
        cache = reg.cache_specs(cfg, spec, "cpu")
        want += _local_bytes(cache, PT.cache_shardings(cache, mesh, rules),
                             mesh)
        want += sum(x.numel() * x.element_size()       # token, pos: whole
                    for x in reg.batch_specs(cfg, spec).values())
    else:
        batch = reg.batch_specs(cfg, spec)
        want += _local_bytes(batch, PT.batch_shardings(batch, mesh, rules),
                             mesh)
    if spec.kind == "train":
        opt = make_optimizer(cfg.optimizer, moment_dtype=cfg.moment_dtype)
        meta = PT.map_with_path(lambda p, x: torch.empty(
            x.shape, dtype=x.dtype, device="meta"), params)
        state = opt.init(meta)
        want += _local_bytes(state, PT.opt_shardings(state, mesh, rules),
                             mesh)
    rec = _rec(runs["2x4"][2], "internlm2-1.8b", shape)
    assert rec["mem"]["argument_size_in_bytes"] == want
