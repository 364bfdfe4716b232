"""The LM loss on a (data, model) mesh of several ranks, taken on each
rank's block of the logits (``models.steps._ce_blocks``): B/dp rows and
Vp/tp vocab columns, the log-sum-exp's max and sum and the gold logit
all-reduced over the vocab's mesh dims, the mean over the rows' dims.

- on gloo ranks of (2, 1), (1, 2) and (2, 2) (``tests/_mesh_ops.py``), the
  loss, the z-loss (the mean squared lse), each rank's lse rows and its
  block of the logits' gradient equal the one-process ``_ce`` on the
  whole tensors within rtol 1e-5 (float32 sums in another order);
- the labels hit every rank's vocab slice, both edges of each slice and
  the last real columns before the padded ones (which enter the
  log-sum-exp as in ``_ce``);
- traced on the dry run's fake 2x4 mesh, the train step's largest
  logits-shaped tensor on a rank is its (B/dp, T, Vp/tp) block: no
  tensor holds the global batch's rows or the whole vocab;
- off a mesh the loss function is ``_ce``, bit for bit.

``tests/test_torch_mesh.py`` holds the whole train step on meshes
against the unsharded step.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as HA
from repro_torch.launch import rl_train
from repro_torch.launch import train as TRN
from repro_torch.models import LM
from repro_torch.models.steps import _ce, make_loss_fn
import _mesh_ops

torch.set_num_threads(1)
MESHES = [(2, 1), (1, 2), (2, 2)]
B, T, VOCAB, VP = 4, 12, 60, 64        # VP - VOCAB padded columns
ZW = 0.5
RTOL = 1e-5
RANK_TIMEOUT_S = 120


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal((B, T + 1, VP))).astype(np.float32)
    tokens = rng.integers(0, VOCAB, size=(B, T + 1))
    # every slice's edges on (1, 2) and (2, 2) (tp = 2: columns 0-31 and
    # 32-63), and the last real columns before the padding
    edges = [0, 1, 30, 31, 32, 33, VOCAB - 2, VOCAB - 1]
    tokens[:, 1:1 + len(edges)] = edges
    return {"logits": logits, "tokens": tokens.astype(np.int32)}


def _whole(inp):
    logits = torch.tensor(inp["logits"], requires_grad=True)
    labels = torch.as_tensor(inp["tokens"])[:, 1:]
    mask = torch.ones(labels.shape, dtype=torch.float32)
    loss, lse = _ce(logits[:, :-1], labels, mask)
    zl = torch.mean(lse ** 2)
    (loss + ZW * zl).backward()
    return {"loss": loss.item(), "zloss": zl.item(),
            "lse": lse.detach().numpy(), "grad": logits.grad.numpy()}


@pytest.fixture(scope="module")
def case():
    inp = _inputs()
    jobs = [dict(op="loss", mesh=m, device="cpu", inputs=inp, zw=ZW)
            for m in MESHES]
    by_mesh = {}
    for n, meshes in ((2, MESHES[:2]), (4, MESHES[2:])):
        res = rl_train.spawn_ranks(_mesh_ops.mesh_ops_rank, n,
                                   [j for j in jobs if j["mesh"] in meshes],
                                   device="cpu", timeout=RANK_TIMEOUT_S)
        for i, m in enumerate(meshes):
            by_mesh[m] = [r[i] for r in res]
    return _whole(inp), by_mesh


def test_the_labels_hit_every_slice_and_its_edges():
    tokens = _inputs()["tokens"][:, 1:]
    for lo, hi in ((0, 31), (32, 63)):
        got = set(tokens[(tokens >= lo) & (tokens <= hi)].tolist())
        assert lo in got and min(hi, VOCAB - 1) in got
    assert VOCAB - 1 in tokens and VP > VOCAB


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_loss_and_zloss_equal_the_whole(case, mesh):
    want, ranks = case[0], case[1][mesh]
    for r, res in enumerate(ranks):
        assert res["loaded"] == []
        assert res["loss"] == pytest.approx(want["loss"], rel=RTOL), r
        assert res["zloss"] == pytest.approx(want["zloss"], rel=RTOL), r


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_each_ranks_lse_and_gradient_block(case, mesh):
    want, ranks = case[0], case[1][mesh]
    dp, tp = mesh
    seen = set()
    for res in ranks:
        (b0, nb), (v0, nv) = res["rows"], res["cols"]
        assert (nb, nv) == (B // dp, VP // tp)
        assert res["grad"].shape == (B // dp, T + 1, VP // tp)
        np.testing.assert_allclose(res["lse"], want["lse"][b0:b0 + nb],
                                   rtol=RTOL, atol=0)
        block = want["grad"][b0:b0 + nb, :, v0:v0 + nv]
        np.testing.assert_allclose(res["grad"], block, rtol=RTOL,
                                   atol=RTOL * np.abs(want["grad"]).max())
        seen.add((b0, v0))
    assert len(seen) == dp * tp          # every block, each once


def test_off_a_mesh_the_loss_is_ce_bit_for_bit():
    cfg = get_arch("internlm2-1.8b", smoke=True)
    model = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    batch = TRN.train_batch(cfg, 0, 0, 2, 16, "cpu")
    loss, metrics = make_loss_fn(model)(model.params, batch)
    logits = model.forward(batch)[:, :-1]
    labels = batch["tokens"][:, 1:]
    want, _ = _ce(logits, labels, torch.ones(labels.shape))
    assert torch.equal(loss, want) and torch.equal(metrics["ce"], want)


class _LogitsShapes(TorchDispatchMode):
    """The shapes of every local tensor an op makes whose last dim is the
    vocab's (whole or a rank's block)."""

    def __init__(self, widths):
        super().__init__()
        self.widths, self.shapes = widths, set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(HA._is_dtensor_type(t) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if HA._in_sharding_propagation():       # DTensor's global shapes
            return out
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.ndim == 3 and \
                    t.shape[-1] in self.widths:
                self.shapes.add(tuple(t.shape))
        return out


def test_the_loss_holds_a_ranks_block_on_the_fake_2x4_mesh():
    """internlm2-smoke's train step (8 x 64, Vp 512) on the dry run's
    fake 2x4 mesh: every logits-shaped tensor a rank makes, forward and
    backward, has at most its B/dp = 4 rows and its Vp/tp = 128
    columns (before the repair: the global batch's (8, 63, 512))."""
    if dist.is_initialized():
        pytest.fail("a process group is already initialised in this worker")
    dryrun.init_fake_group(8)
    try:
        mesh = dryrun._mesh_from_shape("2x4", "cpu")
        cfg = get_arch("internlm2-1.8b", smoke=True)
        mode = _LogitsShapes({cfg.vocab_padded, cfg.vocab_padded // 4})
        run = dryrun._run

        def traced(fn, args, aux, held=None):
            def f(*a):
                with mode:
                    return fn(*a)
            return run(f, args, aux, held)
        dryrun._run = traced
        try:
            dryrun.trace_cfg_cell(cfg, ShapeSpec("t", "train", 64, 8), mesh,
                                  device="cpu")
        finally:
            dryrun._run = run
    finally:
        dist.destroy_process_group()
    assert mode.shapes
    assert max(s[0] for s in mode.shapes) == 4
    assert {s[2] for s in mode.shapes} == {128}
    assert (4, 63, 128) in mode.shapes
