"""The port's LM training driver (``repro_torch.launch.train``) on the
CPU at smoke size: the reference's crash-and-restart check
(``tests/test_system.py::test_lm_train_driver_failure_restart``) held
on the port, an interrupted run bit-equal to an uninterrupted one,
``--compress``, and a checkpoint of the JAX package's own train state
resumed by the port.

Tolerances: the interrupted run's parameters, moments and per-step
losses equal the uninterrupted run's bit for bit (the same CPU
arithmetic replayed from an exact float32 checkpoint); the step after
the JAX checkpoint: loss within rtol 1e-4 of JAX's next step and every
parameter within 2 lr (``tests/test_torch_lm_train_step.py``'s
criteria).
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JCheckpointManager
from repro.configs.registry import get_arch as jax_get_arch
from repro.data import TokenPipeline as JTokenPipeline
from repro.models.model import build_model as jax_build_model
from repro.models.steps import make_train_step as jax_make_train_step
from repro_torch.ckpt import restore_checkpoint
from repro_torch.launch import train

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
SMOKE = ["--device", "cpu", "--arch", "internlm2-1.8b", "--smoke",
         "--batch", "4", "--seq", "32"]


def _log(outdir):
    with open(os.path.join(outdir, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_driver_cli_failure_restart(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *SMOKE,
         "--steps", "24", "--ckpt-every", "8", "--fail-at", "13",
         "--outdir", str(tmp_path)],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-1500:]
    assert "[supervisor] failure: injected failure at step 13 (restart 1)" \
        in r.stdout
    assert "[supervisor] restored at step 8" in r.stdout
    assert "[train internlm2-smoke] step     0 loss" in r.stdout
    assert "[train] done: final loss" in r.stdout
    logs = _log(tmp_path)
    assert logs[-1]["loss"] < logs[0]["loss"]
    assert set(logs[0]) == {"step", "loss", "gnorm", "secs"}


def _final_ckpt(outdir):
    tree, step, meta = restore_checkpoint(os.path.join(outdir, "ckpt"))
    return tree, step, meta


def test_interrupted_run_is_bit_equal_to_an_uninterrupted_one(tmp_path):
    args = SMOKE + ["--steps", "10", "--ckpt-every", "4", "--log-every", "1"]
    a = train.main(args + ["--outdir", str(tmp_path / "a")])
    b = train.main(args + ["--outdir", str(tmp_path / "b"),
                           "--fail-at", "6"])
    assert (a["restarts"], b["restarts"]) == (0, 1)
    assert a["first_loss"] == b["first_loss"]
    assert a["final_loss"] == b["final_loss"]
    assert len(a["save_secs"]) == 3 and len(b["restore_secs"]) == 1
    by_step = lambda logs: {r["step"]: r["loss"] for r in logs}
    la, lb = _log(tmp_path / "a"), _log(tmp_path / "b")
    assert len(lb) == len(la) + 2          # steps 4 and 5 replayed
    assert by_step(la) == by_step(lb)
    ta, sa, ma = _final_ckpt(tmp_path / "a")
    tb, sb, mb = _final_ckpt(tmp_path / "b")
    assert sa == sb == 10 and ma == mb == {"step": 10}
    fa, fb = jax.tree.leaves(ta), jax.tree.leaves(tb)
    assert set(ta) == {"params", "opt"} and len(fa) == len(fb)
    for x, y in zip(fa, fb):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compressed_training_runs_and_learns(tmp_path, scheme):
    out = train.main(SMOKE + ["--steps", "30", "--ckpt-every", "100",
                              "--log-every", "1", "--compress", scheme,
                              "--outdir", str(tmp_path)])
    assert out["restarts"] == 0
    logs = _log(tmp_path)
    assert np.mean([r["loss"] for r in logs[-5:]]) < \
        np.mean([r["loss"] for r in logs[:5]])
    tree, _, _ = _final_ckpt(tmp_path)
    assert set(tree) == {"params", "opt", "res"}
    assert any(np.abs(x).max() > 0 for x in jax.tree.leaves(tree["res"]))


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """JAX's ``make_train_step`` runs two steps of internlm2-smoke and
    ``repro.ckpt`` saves its ``{"params", "opt"}`` state at step 2; the
    port's driver restores it and takes step 2, as JAX's next step."""
    steps, done = 3, 2
    cfg = jax_get_arch("internlm2-1.8b", smoke=True)
    model = jax_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    step_fn, opt = jax_make_train_step(model, total_steps=steps)
    step_fn = jax.jit(step_fn)
    state = opt.init(params)
    pipe = JTokenPipeline(batch=4, seq=32, vocab=cfg.vocab, seed=0)
    batch = lambda i: {k: jnp.asarray(v) for k, v in pipe.get(i).items()}
    for i in range(done):
        params, state, _ = step_fn(params, state, batch(i), jnp.asarray(i))
    JCheckpointManager(str(tmp_path / "ckpt")).save(
        done, {"params": params, "opt": state}, {"step": done})
    jp, _, jm = step_fn(params, state, batch(done), jnp.asarray(done))

    out = train.main(SMOKE + ["--steps", str(steps), "--ckpt-every", "100",
                              "--log-every", "1", "--outdir",
                              str(tmp_path)])
    np.testing.assert_allclose(out["final_loss"], float(jm["loss"]),
                               rtol=1e-4)
    assert len(out["restore_secs"]) == 1
    tree, step, _ = _final_ckpt(tmp_path)
    assert step == steps
    lr = float(jm["lr"])
    for x, y in zip(jax.tree.leaves(tree["params"]), jax.tree.leaves(jp)):
        assert np.abs(x - np.asarray(y)).max() <= 2 * lr
