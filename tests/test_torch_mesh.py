"""The LM steps on a (data, model) mesh of gloo ranks on the CPU, against
the port's own unsharded steps (which tests/test_torch_lm_train*.py hold
against ``jax.grad``): internlm2-smoke's train step on (2, 1), (1, 2),
(2, 2) and (1, 4) (the last replicates its 2 kv heads over a model axis
of 4, so a rank's q head reads a kv head it does not own), the prefill
and greedy decode on (1, 2) (kv heads split) and (1, 4) (the cache
split along the sequence); the kv-head mapping of the head-shard
wrappers; the one-rank host mesh; llama3-smoke's step (Adafactor, 2
microbatches split on each rank's rows) on (2, 2).

Tolerances: loss and gnorm within rtol 1e-4 of the unsharded step (float
32 sums split over ranks), every parameter within 2 lr per step taken
plus 1e-5 of its largest value; greedy tokens equal, logits within 2e-5.
The ranks run the port's ``launch.train.mesh_steps_rank`` (never a
test's function: a rank imports its entry by name).
"""
import numpy as np
import pytest
import torch

from repro_torch.ckpt import save_checkpoint
from repro_torch.kernels import head_shards as HS
from repro_torch.launch import rl_train
from repro_torch.launch import train as TRN
from repro_torch.launch.mesh import AbstractMesh, make_host_mesh
from repro_torch.models import (LM, make_decode_step, make_prefill_step,
                                make_train_step)
from repro_torch.models import partition as PT
from repro_torch.models import sharding as shd
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)
ARCH, SEED = "internlm2-1.8b", 0
STEPS, B, S = 3, 4, 32
SERVE = dict(batch=2, seq=16, steps=8, pad_to=32)   # pad_to splits over 4
RANK_TIMEOUT_S = 120
TRAIN_MESHES = [(2, 1), (1, 2), (2, 2), (1, 4)]
SERVE_MESHES = [(1, 2), (1, 4)]


def _reference(arch, batch, directory, serve=True):
    """The unsharded port: STEPS train steps (their parameters saved for
    the ranks), then the prefill and greedy decode with those weights."""
    cfg = TRN.mesh_config(arch, smoke=True)
    model = LM(cfg, device="cpu").init(torch.Generator().manual_seed(SEED))
    step, opt = make_train_step(model, total_steps=100)
    params, state = model.params, opt.init(model.params)
    hist = []
    for i in range(STEPS):
        params, state, m = step(params, state, TRN.train_batch(
            cfg, SEED, i, batch, S, "cpu"), i)
        hist.append({k: float(v) for k, v in m.items()})
    ref = str(directory / "ref")
    save_checkpoint(ref, 0, {"params": params})
    out = dict(hist=hist, ref=ref, arch=arch, batch=batch)
    if serve:
        model.params = params
        tokens = TRN.train_batch(cfg, SEED + 1, 0, SERVE["batch"],
                                 SERVE["seq"], "cpu")["tokens"]
        out["serve"] = TRN.greedy_decode(
            make_prefill_step(model, pad_to=SERVE["pad_to"]),
            make_decode_step(model), tokens, SERVE["steps"])
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return _reference(ARCH, B, tmp_path_factory.mktemp("mesh"))


def _jobs(reference, meshes):
    train = dict(steps=STEPS, batch=reference["batch"], seq=S,
                 total_steps=100, ref=reference["ref"])
    return [dict(arch=reference["arch"], smoke=True, seed=SEED, device="cpu",
                 mesh=m, train=train,
                 serve=SERVE if m in SERVE_MESHES else None)
            for m in meshes]


def _check_train(reference, ranks):
    lrs = sum(h["lr"] for h in reference["hist"])
    for r, res in enumerate(ranks):
        assert res["loaded"] == []
        for got, want in zip(res["train"], reference["hist"]):
            for k in ("loss", "gnorm"):
                assert got[k] == pytest.approx(want[k], rel=1e-4), (r, k)
        for path, v in res["params"].items():
            assert v["max_diff"] <= 2 * lrs + 1e-5 * v["max_ref"], (r, path)


@pytest.fixture(scope="module")
def ranks(reference):
    """Two spawns: 2 ranks for (2, 1) and (1, 2), 4 for (2, 2) and
    (1, 4); every rank's result by mesh."""
    out = {}
    for meshes in (TRAIN_MESHES[:2], TRAIN_MESHES[2:]):
        n = meshes[0][0] * meshes[0][1]
        res = rl_train.spawn_ranks(TRN.mesh_steps_rank, n,
                                   _jobs(reference, meshes), device="cpu",
                                   timeout=RANK_TIMEOUT_S)
        for j, m in enumerate(meshes):
            out[m] = [r[j] for r in res]
    return out


@pytest.mark.parametrize("mesh", TRAIN_MESHES, ids=str)
def test_train_steps_match_the_unsharded_step(reference, ranks, mesh):
    _check_train(reference, ranks[mesh])


def test_adafactor_and_accumulation_on_a_mesh(tmp_path):
    """llama3-smoke (Adafactor, grad_accum 2) on (2, 2): each rank's 4
    rows split into 2 microbatches, the moments placed like their
    parameters; against the unsharded step on 8 rows."""
    reference = _reference("llama3-405b", 8, tmp_path, serve=False)
    res = rl_train.spawn_ranks(TRN.mesh_steps_rank, 4,
                               _jobs(reference, [(2, 2)]), device="cpu",
                               timeout=RANK_TIMEOUT_S)
    _check_train(reference, [r[0] for r in res])
    opt = res[0][0]["opt"]
    assert opt["stack/mixer/wq/v"]["local"] == (2, 32, 4, 8)


@pytest.mark.parametrize("mesh", TRAIN_MESHES, ids=str)
def test_local_blocks_follow_the_rules(ranks, mesh):
    """Each parameter's and moment's block is the shape its placements
    give on the mesh (the rules' divisibility fallback included)."""
    am = AbstractMesh(mesh, ("data", "model"))
    rules = shd.make_rules(False)
    for rep in (ranks[mesh][0]["params"], ranks[mesh][0]["opt"]):
        for path, v in rep.items():
            leaf = path.split("/")
            logical = PT._classify(tuple(leaf), len(v["shape"]),
                                   PT._PARAM_RULES)
            pls = shd.logical_placements(v["shape"], logical, am, rules)
            assert v["local"] == shd.local_shape(v["shape"], pls, am), path
    wk = ranks[mesh][0]["params"]["stack/mixer/wk"]
    assert wk["local"][2] == (1 if mesh[1] == 2 else 2)    # kv 2 on model


@pytest.mark.parametrize("mesh", SERVE_MESHES, ids=str)
def test_prefill_and_decode_match_the_unsharded_steps(reference, ranks,
                                                      mesh):
    got, want = ranks[mesh][0]["serve"], reference["serve"]
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                               atol=2e-5)
    cache = ranks[mesh][0]["cache"]["k"]
    # (L, B, Hkv, Smax, D): kv heads split on (1, 2); on (1, 4) the 2 kv
    # heads fall back and the sequence takes the model axis
    assert cache["local"] == ((2, 2, 1, 32, 16) if mesh == (1, 2)
                              else (2, 2, 2, 8, 16))


@pytest.mark.parametrize("hq_total,hkv,tp", [(4, 2, 4), (16, 8, 16),
                                             (16, 8, 2), (12, 4, 2),
                                             (8, 2, 8), (6, 2, 3)])
def test_kv_heads_for_hands_each_q_head_its_kv_head(hq_total, hkv, tp):
    """Global q head j reads kv head j // G, whether the kv heads are
    split with the q heads or replicated (the fallback)."""
    G = hq_total // hkv
    k = torch.arange(2 * hkv * 3 * 4, dtype=torch.float32).reshape(
        2, hkv, 3, 4)
    hq = hq_total // tp
    split = hkv % tp == 0
    for r in range(tp):
        j0 = r * hq
        k0 = r * (hkv // tp) if split else 0
        kl = k[:, k0:k0 + hkv // tp] if split else k
        sel, group = HS.kv_heads_for(kl, j0, hq, G, k0)
        assert hq % group == 0 and sel.shape[1] == hq // group
        for i in range(hq):
            assert torch.equal(sel[:, i // group], k[:, (j0 + i) // G])


def test_host_mesh_step_is_the_one_device_step():
    """On the one-rank host mesh (no process group) the state stays
    plain tensors and the step is the one-device step, bit for bit."""
    mesh = make_host_mesh("cpu")
    assert isinstance(mesh, AbstractMesh) and not shd.is_multi(mesh)
    cfg = TRN.mesh_config(ARCH, smoke=True)
    out = []
    for kw in ({}, dict(mesh=mesh, rules=shd.make_rules(False))):
        model = LM(cfg, device="cpu").init(torch.Generator().manual_seed(1))
        params = TRN.device_put_like(model.params, mesh,
                                     shd.make_rules(False))
        step, opt = make_train_step(model, total_steps=10, **kw)
        state = opt.init(params)
        params, state, m = step(params, state, TRN.train_batch(
            cfg, 1, 0, 2, 16, "cpu"), 0)
        out.append((float(m["loss"]), tree_leaves(params)))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) and type(b) is torch.Tensor
               for a, b in zip(out[0][1], out[1][1]))
