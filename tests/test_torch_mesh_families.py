"""Every family's LM steps on a (data, model) mesh of gloo ranks on the
CPU, against the port's own unsharded steps (which the
``tests/test_torch_lm_*.py`` files hold against JAX) and against the
JAX package's steps on a mesh of the same shape: the smoke configs of
olmoe-1b-7b and mixtral-8x7b (MoE), mamba2-2.7b (SSM), jamba-v0.1-52b
(hybrid), whisper-tiny (encoder-decoder, with frames) and internvl2-76b
(VLM, with patches) on (2, 1) and (1, 2): train steps, then a prefill
and greedy decode steps with the trained weights, through
``launch.train.mesh_steps_rank``.

- loss and gnorm within rtol 1e-4 of the unsharded step, every
  parameter within 2 lr per step taken plus 1e-5 of its largest value;
  greedy tokens equal, logits within 2e-5 (``test_torch_mesh.py``'s
  tolerances);
- on (2, 1), the train steps' loss and gnorm within rtol 1e-4 of the
  JAX package's steps on a (2, 1) mesh of 2 XLA CPU devices (a
  subprocess, as ``tests/test_torch_elastic.py`` runs it) from the same
  weights (the port's, saved and restored by JAX's ``ckpt``) on the
  same batches; the prefill and greedy decode on the seed's weights
  (no training: the two packages' trained weights part by up to 2 lr
  an element) with tokens equal and logits within atol = rtol = 2e-5
  (``test_torch_lm.py``'s float32 tolerance);
- each rank's parameter and cache blocks have the shapes ``partition``'s
  rules give them;
- the operators the families add (``tests/_mesh_ops.py``): the SSD on head
  shards (``ssd_forward_shards``) equals ``ssd_forward`` on the whole
  tensors, forward and gradient; the MoE FFN on each rank's rows equals
  the unsharded one (``--override expert=data`` too), and the dispatch
  of a block of rows is the whole batch's dispatch of those rows.

The ranks run port functions only: a rank imports its entry by name.
This file imports nothing of JAX; its subprocess does.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.ckpt import save_checkpoint
from repro_torch.kernels.ssd_chunk.ops import ssd_forward
from repro_torch.launch import rl_train
from repro_torch.launch import train as TRN
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import (LM, make_decode_step, make_prefill_step,
                                make_train_step)
from repro_torch.models import partition as PT
from repro_torch.models import sharding as shd
from repro_torch.models.moe import _group_dispatch, capacity, moe_fwd
import _mesh_ops

torch.set_num_threads(1)
ARCHS = ["olmoe-1b-7b", "mixtral-8x7b", "mamba2-2.7b", "jamba-v0.1-52b",
         "whisper-tiny", "internvl2-76b"]
MESHES = [(2, 1), (1, 2)]
SEED, STEPS, B, S = 0, 2, 4, 32
# the VLM's 4 patches, 16 text tokens and 8 steps fit 32 slots
SERVE = dict(batch=2, seq=16, steps=8, pad_to=32)
RANK_TIMEOUT_S = 240
OP_TOL = dict(rtol=1e-5, atol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MESH = (2, 1)
JAX_TIMEOUT_S = 600
# the JAX package's steps on a (2, 1) mesh of 2 XLA CPU devices: argv
# is the directory, the archs, STEPS, SERVE's steps and pad_to; each
# arch's weights (``<arch>/init``) and batches (``<arch>/batches.npz``)
# come from the port; writes ``<arch>/jax.npz``
JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from repro.ckpt import restore_checkpoint
from repro.configs.registry import get_arch
from repro.models import partition as PT
from repro.models import sharding as shd
from repro.models.layers import Ctx
from repro.models.model import build_model
from repro.models.steps import make_decode_step, make_train_step
from repro.runtime.elastic import device_put_like
d, archs = sys.argv[1], sys.argv[2].split(",")
steps, n_dec, pad = (int(a) for a in sys.argv[3:6])
# Auto axes: GSPMD propagates the shardings between the reference's
# constraints (the installed jax's default, explicit axes, refuses the
# embedding's gather on a split table)
mesh = jax.make_mesh((2, 1), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
rules = shd.make_rules(False)
ctx = Ctx(mesh=mesh, rules=rules)
for arch in archs:
    model = build_model(get_arch(arch, smoke=True))
    like = {"params": jax.eval_shape(model.init, jax.random.PRNGKey(0))}
    host, _, _ = restore_checkpoint(os.path.join(d, arch, "init"), like)
    params = device_put_like(host["params"], mesh, rules)
    data = np.load(os.path.join(d, arch, "batches.npz"))

    def batch(prefix):
        b = {k[len(prefix):]: data[k] for k in data.files
             if k.startswith(prefix)}
        return jax.device_put(b, PT.batch_shardings(b, mesh, rules))
    step, opt = make_train_step(model, mesh=mesh, rules=rules,
                                total_steps=100)
    step = jax.jit(step)
    p, s, out = params, opt.init(params), {"loss": [], "gnorm": []}
    for i in range(steps):
        p, s, m = step(p, s, batch(f"train{i}/"), jnp.asarray(i))
        for k in ("loss", "gnorm"):
            out[k].append(float(m[k]))
    prefill = jax.jit(lambda q, b: model.prefill(q, b, ctx, pad_to=pad))
    decode = jax.jit(make_decode_step(model, mesh=mesh, rules=rules))
    b = batch("serve/")
    toks = b["tokens"]
    start = toks.shape[1] + (b["patches"].shape[1] if "patches" in b
                             else 0)
    logits, cache = prefill(params, b)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    out_l, out_t = [np.asarray(logits)], []
    for t in range(n_dec):
        out_t.append(np.asarray(tok))
        pos = jnp.full((toks.shape[0],), start + t, jnp.int32)
        tok, logits, cache = decode(params, cache, {"token": tok[:, None],
                                                    "pos": pos})
        out_l.append(np.asarray(logits))
    out_t.append(np.asarray(tok))
    np.savez(os.path.join(d, arch, "jax.npz"), logits=np.stack(out_l),
             tokens=np.stack(out_t, axis=1), **{k: np.asarray(v)
                                                for k, v in out.items()})
    print("JAX_MESH", arch, flush=True)
"""


def _reference(arch, directory):
    """The unsharded port's STEPS train steps (the parameters after them
    saved for the ranks) and its prefill and greedy decode with those
    weights; the seed's weights and every batch saved for the JAX
    package's subprocess."""
    cfg = TRN.mesh_config(arch, smoke=True)
    model = LM(cfg, device="cpu").init(torch.Generator().manual_seed(SEED))
    save_checkpoint(str(directory / arch / "init"), 0,
                    {"params": model.params})
    step, opt = make_train_step(model, total_steps=100)
    params, state = model.params, opt.init(model.params)
    hist, arrays = [], {}
    for i in range(STEPS):
        batch = TRN.train_batch(cfg, SEED, i, B, S, "cpu")
        arrays.update({f"train{i}/{k}": v.numpy() for k, v in batch.items()})
        params, state, m = step(params, state, batch, i)
        hist.append({k: float(v) for k, v in m.items()})
    ref = str(directory / arch / "ref")
    save_checkpoint(ref, 0, {"params": params})
    model.params = params
    batch = TRN.train_batch(cfg, SEED + 1, 0, SERVE["batch"], SERVE["seq"],
                            "cpu")
    arrays.update({f"serve/{k}": v.numpy() for k, v in batch.items()})
    np.savez(directory / arch / "batches.npz", **arrays)
    serve = TRN.greedy_decode(make_prefill_step(model, pad_to=SERVE["pad_to"]),
                              make_decode_step(model), batch.pop("tokens"),
                              SERVE["steps"], batch)
    serve.pop("cache")
    return dict(hist=hist, ref=ref, serve=serve)


@pytest.fixture(scope="module")
def families_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("families")


@pytest.fixture(scope="module")
def references(families_dir):
    return {a: _reference(a, families_dir) for a in ARCHS}


@pytest.fixture(scope="module")
def jax_mesh(references, families_dir):
    """The JAX package's steps on JAX_MESH, in a subprocess started
    before the ranks and read after them."""
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(families_dir),
         ",".join(ARCHS), str(STEPS), str(SERVE["steps"]),
         str(SERVE["pad_to"])], cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
             "JAX_PLATFORMS": "cpu"})
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def ranks(references, jax_mesh):
    """One spawn of 2 ranks: every family on (2, 1), then on (1, 2)
    (train, then serve with the trained weights), then on JAX_MESH
    serving with the seed's weights (the ``(arch, "seed")`` jobs)."""
    jobs = [dict(arch=a, smoke=True, seed=SEED, device="cpu", mesh=m,
                 train=dict(steps=STEPS, batch=B, seq=S, total_steps=100,
                            ref=references[a]["ref"]), serve=SERVE)
            for m in MESHES for a in ARCHS]
    jobs += [dict(arch=a, smoke=True, seed=SEED, device="cpu", mesh=JAX_MESH,
                  serve=SERVE) for a in ARCHS]
    res = rl_train.spawn_ranks(TRN.mesh_steps_rank, 2, jobs, device="cpu",
                               timeout=RANK_TIMEOUT_S)
    return {(j["arch"], j["mesh"] if "train" in j else "seed"):
            [r[i] for r in res] for i, j in enumerate(jobs)}


@pytest.fixture(scope="module")
def jax_results(ranks, jax_mesh, families_dir):
    out, err = jax_mesh.communicate(timeout=JAX_TIMEOUT_S)
    assert jax_mesh.returncode == 0, out[-1500:] + err[-3000:]
    return {a: dict(np.load(families_dir / a / "jax.npz")) for a in ARCHS}


CELLS = [pytest.param(a, m, id=f"{a}-{m[0]}x{m[1]}")
         for a in ARCHS for m in MESHES]


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_train_steps_match_the_unsharded_step(references, ranks, arch,
                                              mesh):
    want = references[arch]["hist"]
    lrs = sum(h["lr"] for h in want)
    for r, res in enumerate(ranks[arch, mesh]):
        assert res["loaded"] == []
        for got, w in zip(res["train"], want):
            for k in ("loss", "gnorm"):
                assert got[k] == pytest.approx(w[k], rel=1e-4), (r, k)
        for path, v in res["params"].items():
            assert v["max_diff"] <= 2 * lrs + 1e-5 * v["max_ref"], (r, path)


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_prefill_and_decode_match_the_unsharded_steps(references, ranks,
                                                      arch, mesh):
    got, want = ranks[arch, mesh][0]["serve"], references[arch]["serve"]
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_steps_match_jax_on_a_mesh(ranks, jax_results, arch):
    """The port's steps on (2, 1) gloo ranks against the JAX package's on
    a (2, 1) mesh of XLA CPU devices, from the same weights and batches:
    the train steps' loss and gnorm (rtol 1e-4, as
    ``test_torch_lm_train_step.py`` holds the unsharded steps), the
    prefill and greedy decode on the seed's weights (tokens equal,
    logits within atol = rtol = 2e-5)."""
    want = jax_results[arch]
    for res in ranks[arch, JAX_MESH]:
        for k in ("loss", "gnorm"):
            np.testing.assert_allclose([h[k] for h in res["train"]],
                                       want[k], rtol=1e-4, err_msg=k)
    got = ranks[arch, "seed"][0]["serve"]
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_local_blocks_follow_the_rules(ranks, arch, mesh):
    """Each parameter's and cache leaf's block is the shape its
    placements give on the mesh; the families' own leaves are split
    where their rules say."""
    am = AbstractMesh(mesh, ("data", "model"))
    rules = shd.make_rules(False)
    res = ranks[arch, mesh][0]
    for rep, table in ((res["params"], PT._PARAM_RULES),
                       (res["cache"], PT._CACHE_RULES)):
        for path, v in rep.items():
            logical = PT._classify(tuple(path.split("/")), len(v["shape"]),
                                   table, strip_state=table is
                                   PT._PARAM_RULES)
            pls = shd.logical_placements(v["shape"], logical, am, rules)
            assert v["local"] == shd.local_shape(v["shape"], pls, am), path
            assert v["placements"] == str(pls), path
    launches = res["launches"]
    assert set(launches["train"]) == {"flash_attention", "decode_gqa",
                                      "ssd_chunk"}
    # the plain versions on the CPU launch nothing, so record no shape
    assert res["shapes"] == {k: [] for k in launches["train"]}


def test_the_families_own_leaves_are_split(ranks):
    """The leaves A.5 adds to a mesh: the experts over the model axis,
    the Mamba-2 state over the batch and the heads, whisper's cross
    cache over its kv heads."""
    olmoe = ranks["olmoe-1b-7b", (1, 2)][0]["params"]
    assert olmoe["stack/ffn/w_gate"]["local"][1] == 8 // 2   # E on model
    ssm = {m: ranks["mamba2-2.7b", m][0]["cache"]["ssm"]["local"]
           for m in MESHES}
    # (L, B, H, N, P): 2 rows over data, 8 heads over model
    assert ssm[(2, 1)][1:3] == (1, 8) and ssm[(1, 2)][1:3] == (2, 4)
    cross = ranks["whisper-tiny", (1, 2)][0]["cache"]["cross/k"]
    assert cross["local"][2] == 4 // 2


def _ssd_inputs(seed=3, Bn=2, T=40, H=4, P=16, N=16):
    rng = np.random.default_rng(seed)

    def f(*s):
        return rng.standard_normal(s).astype(np.float32)
    return {"x": f(Bn, T, H, P),
            "dt": np.log1p(np.exp(f(Bn, T, H))).astype(np.float32),
            "A": -np.exp(np.linspace(0, 1.5, H)).astype(np.float32),
            "Bm": f(Bn, T, N), "Cm": f(Bn, T, N), "wy": f(Bn, T, H, P),
            "ws": f(Bn, H, N, P)}


def _moe_inputs(seed=4, Bn=4, Sn=12, d=16, f=24, E=4):
    rng = np.random.default_rng(seed)

    def r(*s):          # N(0, 1) over the fan-in
        return (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
    return {"x": r(Bn, Sn, d), "router": r(d, E), "w_gate": r(E, d, f),
            "w_up": r(E, d, f), "w_down": r(E, f, d), "w": r(Bn, Sn, d)}


@pytest.fixture(scope="module")
def ops():
    """One spawn of 2 ranks: the SSD on (2, 1) and (1, 2) (chunk 16, a
    ragged T = 40), the MoE FFN (top-2 of 4) on both and on (2, 1) with
    the experts over the data axis."""
    ssd, moe = _ssd_inputs(), _moe_inputs()
    jobs = [dict(op="ssd", mesh=m, device="cpu", inputs=ssd, chunk=16)
            for m in MESHES]
    jobs += [dict(op="moe", mesh=m, device="cpu", inputs=moe, top_k=2,
                  overrides=o)
             for m, o in ((MESHES[0], None), (MESHES[1], None),
                          (MESHES[0], {"expert": ("data",)}))]
    res = rl_train.spawn_ranks(_mesh_ops.mesh_ops_rank, 2, jobs, device="cpu",
                               timeout=RANK_TIMEOUT_S)
    return ssd, moe, [[r[i] for r in res] for i in range(len(jobs))]


@pytest.mark.parametrize("j", [0, 1], ids=["2x1", "1x2"])
def test_ssd_forward_shards_is_ssd_forward(ops, j):
    inp = ops[0]
    t = {k: torch.tensor(v, requires_grad=k in ("x", "dt", "A", "Bm", "Cm"))
         for k, v in inp.items()}
    y, st = ssd_forward(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], chunk=16)
    ((y * t["wy"]).sum() + (st * t["ws"]).sum()).backward()
    for res in ops[2][j]:
        assert res["loaded"] == []
        np.testing.assert_allclose(res["y"], y.detach().numpy(), **OP_TOL)
        np.testing.assert_allclose(res["state"], st.detach().numpy(),
                                   **OP_TOL)
        for k, g in res["grads"].items():
            np.testing.assert_allclose(g, t[k].grad.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=k)
    # a rank's y block: its rows on (2, 1), its heads on (1, 2)
    assert ops[2][j][0]["y_local"] == ((1, 40, 4, 16) if j == 0
                                       else (2, 40, 2, 16))


@pytest.mark.parametrize("j", [2, 3, 4], ids=["2x1", "1x2", "2x1-expert=data"])
def test_moe_on_each_ranks_rows_is_the_unsharded_ffn(ops, j):
    inp = ops[1]
    t = {k: torch.tensor(v, requires_grad=k != "w") for k, v in inp.items()}
    p = {k: t[k] for k in ("router", "w_gate", "w_up", "w_down")}
    out, aux = moe_fwd(p, t["x"], top_k=2)
    ((out * t["w"]).sum() + aux).backward()
    for res in ops[2][j]:
        assert res["loaded"] == []
        np.testing.assert_allclose(res["out"], out.detach().numpy(), **OP_TOL)
        assert res["aux"] == pytest.approx(aux.item(), rel=1e-5)
        for k, g in res["grads"].items():
            np.testing.assert_allclose(g, t[k].grad.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    if j == 4:      # the experts over the data axis
        assert ops[2][j][0]["placements"]["w_gate"].startswith("(Shard(dim=0)")


def test_a_block_of_rows_dispatches_as_the_whole_batch():
    """``_group_dispatch`` of rows b0 .. b0 + n equals rows b0 .. b0 + n
    of the whole batch's dispatch (slots and each assignment's slot):
    what each rank runs on its own groups in ``moe_fwd``."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn((6, 20, 8), generator=g)
    eidx = torch.randint(0, 4, (6, 20, 2), generator=g)
    C = capacity(20, 2, 4, 1.25)
    slots, slot = _group_dispatch(x, eidx, 4, C)
    for b0, n in ((0, 3), (3, 3), (2, 2), (5, 1)):
        s, sl = _group_dispatch(x[b0:b0 + n], eidx[b0:b0 + n], 4, C)
        assert torch.equal(s, slots[b0:b0 + n])
        assert torch.equal(sl, slot[b0:b0 + n])
