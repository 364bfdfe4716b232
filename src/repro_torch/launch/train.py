"""LM training driver on one device: data pipeline -> train step ->
checkpoints, under failure-injection supervision.  The counterpart of
the JAX package's ``launch/train.py``, with the same flags plus
``--device`` (default ``cuda``; without a GPU it raises unless
``--device cpu`` is given):

- step-indexed deterministic data (``data.TokenPipeline``): a restart
  replays the same batches;
- atomic checkpoints of ``{"params", "opt"}`` (plus ``"res"`` under
  ``--compress``) every ``--ckpt-every`` steps and at the last, in the
  JAX package's format and key paths, so either package resumes the
  other's; a rerun in the same ``--outdir`` resumes from the latest;
- ``--fail-at N`` injects a crash at step N, which the supervisor
  (``runtime.run_with_restarts``) rolls back to the last checkpoint;
- ``--compress int8|topk``: gradient compression with error feedback
  (``runtime.compression``) before the update, at the reference's fixed
  lr of 3e-4 and without accumulation.

Each step writes the update into the state's own tensors, as the
reference's ``jax.jit(..., donate_argnums=(0, 1))`` donates them: one
copy of the parameters and moments is held, not two.

The mesh and the sharding rules of the reference are not ported yet
(ROADMAP A11b).  Weights are drawn on the device by a
``torch.Generator`` seeded from ``--seed``; each step's batch is drawn
by NumPy and moved to the device.

Usage (CPU-sized):
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch internlm2-1.8b --smoke --steps 60 --batch 8 --seq 64 \\
      --outdir runs/lm_demo
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import LM
from repro_torch.models.steps import (make_loss_fn, make_train_step,
                                      value_and_grad)
from repro_torch.runtime import (CompressionState, FailureInjector,
                                 compress_grads, decompress_grads,
                                 run_with_restarts)
from repro_torch.telemetry.console import console_line
from repro_torch.tree import tree_map

COMPRESS_LR = 3e-4          # the reference's fixed lr under --compress


def build(cfg, device, *, total_steps: int, compress: str | None = None):
    """-> (model, train_step, opt, has_res).  Under ``compress`` the
    step is ``(params, opt_state, batch, step, residual) -> (params,
    opt_state, metrics, residual)``: the gradients go through the lossy
    round-trip with error feedback, back in the parameters' dtype, and
    the update runs at ``COMPRESS_LR``."""
    model = LM(cfg, device=device)
    base_step, opt = make_train_step(model, total_steps=total_steps)
    if not compress:
        return model, base_step, opt, False
    loss_fn = make_loss_fn(model)

    def train_step(params, opt_state, batch, step, residual):
        loss, metrics, grads = value_and_grad(loss_fn, params, batch)
        payload, residual = compress_grads(grads, residual, scheme=compress)
        grads = tree_map(lambda g, p: g.to(p.dtype),
                         decompress_grads(payload, scheme=compress), params)
        lr = torch.tensor(COMPRESS_LR, dtype=torch.float32)
        new_p, new_o, gnorm = opt.update(grads, opt_state, params, step, lr)
        return new_p, new_o, {**metrics, "loss": loss, "gnorm": gnorm,
                              "lr": lr}, residual

    return model, train_step, opt, True


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=-1)
    ap.add_argument("--compress", default=None, choices=[None, "int8", "topk"])
    ap.add_argument("--outdir", default="runs/lm_train")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None):
    """Train; returns ``{"first_loss", "final_loss", "restarts"}`` as
    the reference, plus the seconds of each checkpoint save and
    restore (``save_secs``, ``restore_secs``)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_arch(args.arch, smoke=args.smoke)
    model, train_step, opt, has_res = build(cfg, device,
                                            total_steps=args.steps,
                                            compress=args.compress)
    pipe = TokenPipeline(batch=args.batch, seq=args.seq, vocab=cfg.vocab,
                         seed=args.seed)
    mgr = CheckpointManager(os.path.join(args.outdir, "ckpt"))
    injector = FailureInjector(at_steps=(args.fail_at,)
                               if args.fail_at >= 0 else ())
    losses: list[float] = []
    save_secs: list[float] = []
    restore_secs: list[float] = []

    def init_fn():
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = model.init(gen).params
        model.params = None             # the state owns the weights
        state = {"params": params, "opt": opt.init(params)}
        if has_res:
            state["res"] = CompressionState.init(params)
        return state, 0

    def restore_fn():
        step = mgr.latest_step()
        if step is None:
            return None
        t0 = time.perf_counter()
        # the structure, shapes and dtypes of a fresh state, on no device
        like = tree_map(lambda t: t.to("meta"), init_fn()[0])
        tree, step, _ = mgr.restore(like, step)
        tree = tree_map(lambda a, ref: torch.as_tensor(a).to(
            device=device, dtype=ref.dtype), tree, like)
        restore_secs.append(time.perf_counter() - t0)
        return tree, step

    def save_fn(state, step):
        t0 = time.perf_counter()
        mgr.save(step, state, {"step": step})
        save_secs.append(time.perf_counter() - t0)

    def step_fn(state, step):
        injector.maybe_fail(step)
        t0 = time.time()
        batch = {k: torch.as_tensor(v).to(device)
                 for k, v in pipe.get(step).items()}
        if has_res:
            p, o, m, res = train_step(state["params"], state["opt"], batch,
                                      step, state["res"])
            state = {"params": p, "opt": o, "res": res}
        else:
            p, o, m = train_step(state["params"], state["opt"], batch, step)
            state = {"params": p, "opt": o}
        loss = float(m["loss"])
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            rec = dict(step=step, loss=round(loss, 4),
                       gnorm=round(float(m["gnorm"]), 3),
                       secs=round(time.time() - t0, 3))
            logf.write(json.dumps(rec) + "\n")
            logf.flush()
            console_line(f"[train {cfg.name}] step {step:5d} loss {loss:.4f}")
        return state

    os.makedirs(args.outdir, exist_ok=True)
    with open(os.path.join(args.outdir, "log.jsonl"), "a") as logf:
        _, restarts = run_with_restarts(
            init_fn=init_fn, restore_fn=restore_fn, step_fn=step_fn,
            save_fn=save_fn, total_steps=args.steps,
            ckpt_every=args.ckpt_every,
            on_event=lambda ev: console_line(f"[supervisor] {ev}"))
    if losses:
        console_line(f"[train] done: final loss {losses[-1]:.4f} "
                     f"(first {losses[0]:.4f}), restarts={restarts}")
    return {"first_loss": losses[0] if losses else None,
            "final_loss": losses[-1] if losses else None,
            "restarts": restarts, "save_secs": save_secs,
            "restore_secs": restore_secs}


if __name__ == "__main__":
    main()
