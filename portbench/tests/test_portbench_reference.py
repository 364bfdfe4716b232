"""At four streams on the CPU, a run of each cell holds the port to the
plain reference; the control (the reference in TF32 and bfloat16, put
in the program's place) fails the comparison; and a run whose timed
path is broken underneath comes out not correct, once for each fault
the cells can have (the cells take one chip, so no exchange between
chips can be left out).  The cost tables and the isolated latencies the
reference works out equal the program's."""
import json
import pathlib

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import costmodel

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in harness.bench()["workloads"]]


def _ctx(cell, seed, periods=60, control=None):
    ctx = harness.load_ctx(cell, seed, 0.0, False, "cpu", 0.0)
    ctx.traffic = dict(ctx.traffic, streams=4)
    ctx.config = dict(ctx.config, env=dict(ctx.config["env"],
                                           periods=periods))
    ctx.control = control
    return ctx


@pytest.mark.parametrize("cell", CELLS)
def test_port_agrees_and_the_control_fails(cell):
    out, res = harness.run_cell(_ctx(cell, 2 ** 31 + 77, control="cpu"))
    assert out["correct"], out["checks"]
    assert res["readings"]["compared"]["streams"] == 4
    assert res["failed"] == 0 and res["attempted"] > 0
    ok, checks = harness.judge(res["control_readings"], out_limits(cell))
    assert not ok, checks


def out_limits(cell):
    return json.loads((ROOT / "portbench" / "limits" /
                       f"{cell}.json").read_text())


def _broken(monkeypatch, fault):
    from repro_torch.core import serve as core_serve
    from repro_torch.sim import engine
    make, sim = core_serve.make_serving_tick, engine.simulate

    def rows(queues):
        return {g: {k: v.clone() for k, v in queues[g].items()
                    if torch.is_tensor(v)}
                for g in ("trace", "state")}

    def restore(queues, saved, sl):
        for g, leaves in saved.items():
            for k, v in leaves.items():
                queues[g][k][sl] = v[sl]

    def make_broken(env, **kw):
        tick = make(env, **kw)

        def broken(queues, adm):
            saved = rows(queues)
            out = tick(queues, adm)
            S = queues["occupied"].shape[0]
            if fault == "state_unchanged":
                restore(queues, saved, slice(0, S))
            elif fault == "half_batch":
                restore(queues, saved, slice(S // 2, S))
            return out
        return broken

    def altered(*args, **kw):
        start, fin = sim(*args, **kw)
        return start, torch.where(fin < 1e29, fin + 1.0, fin)

    monkeypatch.setattr(core_serve, "make_serving_tick", make_broken)
    if fault == "answer_altered":
        monkeypatch.setattr(engine, "simulate", altered)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    _broken(monkeypatch, fault)
    out, _ = harness.run_cell(_ctx("paper6-mixed-pareto", 5, periods=20))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_tables_equal_the_programs(cell):
    from portbench.runners.relmas import build_service
    ctx = harness.load_ctx(cell, 1, 0.0, False, "cpu", 0.0)
    env = build_service(ctx.config, "cpu").env
    tab = costmodel.tables(ctx.config)
    d = env.registry.dense()
    for k in ("lat", "bw", "en", "min_lat"):
        np.testing.assert_array_equal(tab[k], d[k])
    np.testing.assert_array_equal(tab["n_layers"], d["n_layers"])
    assert tab["names"] == env.registry.model_names
    assert env.feat_dim == ctx.config["policy"]["feat_dim"]
    assert env.act_dim == ctx.config["policy"]["act_dim"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
def test_control_on_the_card_reads_tf32(card):
    """The card's TF32 products and the CPU's rounding of the operands
    both leave the control far from the float64 reference."""
    from portbench.reference import relmas as ref
    rng = np.random.default_rng(0)
    F, H, G = 16, 256, 7
    w = {"lstm": {"wx": rng.uniform(-.1, .1, (F, 4 * H)),
                  "wh": rng.uniform(-.1, .1, (H, 4 * H)),
                  "b": rng.uniform(-.1, .1, 4 * H)},
         "fc1": {"w": rng.uniform(-.1, .1, (H, H // 2)),
                 "b": rng.uniform(-.1, .1, H // 2)},
         "fc2": {"w": rng.uniform(-.2, .2, (H // 2, G)),
                 "b": rng.uniform(-.1, .1, G)}}
    x = rng.uniform(0, 1, (4, 97, F))
    m = np.ones((4, 97), bool)
    a64 = ref.actor(w, x, m)
    for dev in ("cpu", card):
        gap = np.abs(ref.actor(w, x, m, "tf32", dev) - a64).max()
        assert 1e-5 < gap < 1e-1


def test_seed_permutes_the_policy_without_changing_it():
    from portbench.reference import relmas as ref
    from portbench.runners.relmas import draw_weights, permute_hidden
    base = draw_weights(7, 16, 64, 7, "cpu")
    x = np.random.default_rng(0).uniform(0, 1, (3, 20, 16))
    m = np.arange(20)[None] < np.array([[20], [9], [1]])
    a = ref.actor(base, x, m)
    for seed in (1, 2 ** 40 + 3):
        w = permute_hidden(base, seed)
        assert not np.array_equal(w["lstm"]["wh"], base["lstm"]["wh"])
        np.testing.assert_allclose(ref.actor(w, x, m), a, atol=1e-12)
