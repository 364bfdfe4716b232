"""The dry run's counts (``repro_torch.launch.hlo_analysis.StepCounter``)
on a fake process group in this process, and the kernels' fake routes
and cost formulas (``repro_torch.kernels._library``).

- a ``Shard(0) -> Replicate()`` redistribution on a fake 2x4 ``cpu``
  mesh and a functional all-reduce give exactly the reference's ring
  bytes (``repro.launch.hlo_analysis._TRAFFIC_FACTOR``);
- a DTensor product counts one rank's local product, with no global
  term (``FlopCounterMode`` around the same code counts both);
- each kernel's fake route gives its plain version's output shapes and
  dtypes; its FLOP formula equals ``FlopCounterMode``'s count of the
  plain version where the two do the same work (non-causal attention,
  decode at full length, ``lstm_cell``, ``ssd_intra``, ``lstm_seq``);
  its bytes formula reads each input and writes each output once;
- no launch counter moves.

The fake group is torn down at the end of the module: nothing else in
the worker sees it.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.launch import hlo_analysis as ref_ha
from repro_torch.kernels import _library
from repro_torch.kernels.decode_gqa import ops as dec_ops
from repro_torch.kernels.decode_gqa.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_chunked
from repro_torch.kernels.lstm_cell import ops as cell_ops
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref
from repro_torch.kernels.lstm_seq import ops as seq_ops
from repro_torch.kernels.lstm_seq.ref import lstm_seq_ref
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.kernels.ssd_chunk.ref import ssd_intra_ref
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as HA

torch.set_num_threads(1)
MODS = (fa_ops, dec_ops, cell_ops, seq_ops, ssd_ops)


@pytest.fixture(scope="module")
def mesh():
    if dist.is_initialized():
        pytest.fail("a process group is already initialised in this worker")
    dryrun.init_fake_group(8)
    try:
        yield dryrun._mesh_from_shape("2x4", "cpu")
    finally:
        dist.destroy_process_group()


def test_redistribution_and_all_reduce_give_the_reference_ring_bytes(mesh):
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    counter = HA.StepCounter()
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty((32, 24)), mesh,
                               (Shard(0), Replicate()), run_check=False)
        y = torch.empty((16, 16))
        with counter:
            whole = x.redistribute(mesh, (Replicate(), Replicate()))
            funcol.all_reduce(y, "sum", mesh.get_group("model"))
    assert tuple(whole.shape) == (64, 24)
    z_gather = 64 * 24 * 4                  # the gathered result
    z_reduce = 16 * 16 * 4
    want = {"all-gather": ref_ha._TRAFFIC_FACTOR["all-gather"](z_gather, 2),
            "all-reduce": ref_ha._TRAFFIC_FACTOR["all-reduce"](z_reduce, 4)}
    stats = counter.collectives()
    assert stats.by_op == want
    assert stats.counts == {"all-gather": 1, "all-reduce": 1}
    assert stats.per_chip_bytes == sum(want.values())


def test_a_dtensor_product_counts_one_ranks_local_product(mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    M, K, N = 64, 32, 48
    counter = HA.StepCounter()
    flops = FlopCounterMode(display=False)
    with FakeTensorMode():
        a = DTensor.from_local(torch.empty((M // 2, K)), mesh,
                               (Shard(0), Replicate()), run_check=False)
        w = DTensor.from_local(torch.empty((K, N // 4)), mesh,
                               (Replicate(), Shard(1)), run_check=False)
        with counter:
            out = a @ w
        with flops:
            a @ w
    assert tuple(out.to_local().shape) == (M // 2, N // 4)
    local = 2 * (M // 2) * K * (N // 4)
    assert counter.flops == local
    assert counter.flops_by_op == {"mm": local}
    assert counter.collectives().per_chip_bytes == 0
    # FlopCounterMode counts more than the local product around DTensor
    assert flops.get_total_flops() > local


def _rng_tensors(shapes, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(s).astype(np.float32)
                            ).to(dtype) for s in shapes]


def _flash():
    q, k, v = _rng_tensors([(2, 4, 24, 64), (2, 2, 40, 64), (2, 2, 40, 64)])
    return (fa_ops.flash_attention, (q, k, v), dict(causal=False),
            lambda: attention_chunked(q, k, v, causal=False))


def _decode():
    q, k, v = _rng_tensors([(3, 4, 1, 64), (3, 2, 50, 64), (3, 2, 50, 64)])
    length = torch.full((3,), 50, dtype=torch.int32)
    return (dec_ops.decode_attention, (q, k, v, length), {},
            lambda: decode_attention_ref(q, k, v, length))


def _cell():
    args = _rng_tensors([(5, 7), (5, 16), (5, 16), (7, 64), (16, 64),
                         (64,)])
    return cell_ops.lstm_cell, args, {}, lambda: lstm_cell_ref(*args)


def _ssd():
    args = _rng_tensors([(3, 16, 8), (3, 16, 8), (3, 5, 16, 16), (3, 5, 16)])
    return ssd_ops.ssd_intra, args, {}, lambda: ssd_intra_ref(*args)


def _seq():
    xs, wx, wh, b = _rng_tensors([(6, 3, 7), (7, 128), (32, 128), (128,)])
    mask = torch.ones((6, 3), dtype=torch.bool)
    args = (xs, mask, wx, wh, b)
    return seq_ops.lstm_seq, args, {}, lambda: lstm_seq_ref(*args)


CASES = {"flash_attention": _flash, "decode_gqa": _decode,
         "lstm_cell": _cell, "ssd_chunk": _ssd, "lstm_seq": _seq}


def _fake_args(args):
    mode = FakeTensorMode()
    return mode, [mode.from_tensor(a) for a in args]


@pytest.mark.parametrize("name", sorted(CASES))
def test_fake_route_gives_the_plain_versions_shapes(name):
    fn, args, kw, plain = CASES[name]()
    before = [m.LAUNCHES for m in MODS]
    with torch.no_grad():
        want = plain()
    mode, fargs = _fake_args(args)
    with mode, torch.no_grad():
        got = fn(*fargs, **kw)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert (tuple(g.shape), g.dtype) == (tuple(w.shape), w.dtype)
    assert [m.LAUNCHES for m in MODS] == before


@pytest.mark.parametrize("name", sorted(CASES))
def test_flop_formula_equals_the_plain_versions_count(name):
    fn, args, kw, plain = CASES[name]()
    mode, fargs = _fake_args(args)
    counter = HA.StepCounter()
    with mode, torch.no_grad(), counter:
        fn(*fargs, **kw)
    plain_count = FlopCounterMode(display=False)
    with torch.no_grad(), plain_count:
        plain()
    assert counter.flops == plain_count.get_total_flops() > 0
    # the kernel counts as one operator, its bytes by its formula: each
    # input read once, each output written once
    (op_name,) = counter.flops_by_op
    assert getattr(torch.ops.repro_torch, op_name) in _library.BYTES
    with torch.no_grad():
        outs = plain()
    outs = outs if isinstance(outs, tuple) else (outs,)
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    assert counter.bytes == _library.nbytes(*tensors, *outs)


def test_causal_flash_formula_counts_the_triangle():
    B, H, S, D = 2, 4, 96, 64
    assert fa_ops.flops((B, H, S, D), (B, 2, S, D), (B, 2, S, D), True, 0) \
        == 4 * B * H * D * S * (S + 1) // 2
    # a window of w: row i sees min(i + 1, w) keys
    w = 10
    pairs = sum(min(i + 1, w) for i in range(S))
    assert fa_ops.visible_pairs(S, S, True, w) == pairs
    assert fa_ops.visible_pairs(S, 7, False, 0) == S * 7


def test_real_cpu_calls_still_take_the_plain_versions():
    """The operators' CPU route is the plain version, bit for bit."""
    for name in sorted(CASES):
        fn, args, kw, plain = CASES[name]()
        with torch.no_grad():
            got, want = fn(*args, **kw), plain()
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w), name
