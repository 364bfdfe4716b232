"""LM training driver: data pipeline -> train step -> checkpoints,
under failure-injection supervision.  The counterpart of the JAX
package's ``launch/train.py``, with the same flags plus ``--device``
(default ``cuda``; without a GPU it raises unless ``--device cpu`` is
given):

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

As the reference's driver, it builds the host mesh (``make_host_mesh``,
one rank: (1, 1) (data, model)) and the default rules, places the
initial and the restored state on it (``runtime.elastic.device_put_like``)
and takes ``make_train_step(model, mesh=, rules=)``; on a mesh of one
rank the state stays plain tensors and the step is the one-device step.
Weights are drawn on the device by a ``torch.Generator`` seeded from
``--seed``; each step's batch is drawn by NumPy and moved to the device.

:func:`mesh_steps_rank` is the rank entry of the steps on a mesh of
several ranks (``rl_train.spawn_ranks``): the train, prefill and decode
steps of any family's config (:func:`train_batch` draws whisper's
frames and the VLM's patches beside the tokens) and the elastic restore
across meshes, held by the caller against the one-process run
(:func:`greedy_decode` serves both).

Usage (CPU-sized):
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch internlm2-1.8b --smoke --steps 60 --batch 8 --seq 64 \\
      --outdir runs/lm_demo
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch.ckpt import (CheckpointManager, restore_checkpoint,
                              save_checkpoint)
from repro_torch.configs import get_arch
from repro_torch.data import TokenPipeline, synthetic_batch
from repro_torch.device import resolve_device
from torch.distributed.tensor import DTensor

from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import LM
from repro_torch.models import partition as PT
from repro_torch.models import sharding as shd
from repro_torch.models.steps import (make_decode_step, make_loss_fn,
                                      make_prefill_step, make_train_step,
                                      value_and_grad, whole)
from repro_torch.runtime import (CompressionState, FailureInjector,
                                 compress_grads, decompress_grads,
                                 run_with_restarts)
from repro_torch.runtime.elastic import device_put_like, reshard_restore
from repro_torch.telemetry.console import console_line
from repro_torch.tree import tree_map

COMPRESS_LR = 3e-4          # the reference's fixed lr under --compress


def build(cfg, device, *, total_steps: int, compress: str | None = None,
          mesh=None, rules=None):
    """-> (model, train_step, opt, has_res).  Under ``compress`` the
    step is ``(params, opt_state, batch, step, residual) -> (params,
    opt_state, metrics, residual)``: the gradients go through the lossy
    round-trip with error feedback, back in the parameters' dtype, and
    the update runs at ``COMPRESS_LR`` (on one rank, as the
    reference's)."""
    model = LM(cfg, device=device)
    base_step, opt = make_train_step(model, mesh=mesh, rules=rules,
                                     total_steps=total_steps)
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
    mesh = make_host_mesh(device.type)
    rules = shd.make_rules(multi_pod=False)
    model, train_step, opt, has_res = build(cfg, device,
                                            total_steps=args.steps,
                                            compress=args.compress,
                                            mesh=mesh, rules=rules)
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
        params = device_put_like(model.init(gen).params, mesh, rules)
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
        tree = device_put_like(tree, mesh, rules)
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


# ---------------------------------------------------------------------------
# the steps on a mesh of several ranks
# ---------------------------------------------------------------------------
def mesh_config(arch: str, *, smoke: bool = False, n_layers=None,
                param_dtype=None, head_dim=None):
    """``arch``'s config, cut to ``n_layers``, in ``param_dtype`` and
    with attention heads of ``head_dim`` where given (a smoke config's
    16 is below what the attention kernels take on the card)."""
    cfg = get_arch(arch, smoke=smoke)
    repl = {k: v for k, v in (("n_layers", n_layers),
                              ("param_dtype", param_dtype),
                              ("head_dim", head_dim)) if v is not None}
    return dataclasses.replace(cfg, **repl) if repl else cfg


def train_batch(cfg, seed: int, step: int, B: int, S: int, device):
    """Step ``step``'s batch of ``cfg``'s family, a pure function of
    (seed, step): ``tokens`` (B, S) of ``synthetic_batch``, and the
    stubs' inputs drawn by NumPy beside them, whisper's ``frames`` (B,
    n_frames, d_model) as N(0, 1) x 0.1 and the VLM's ``patches`` (B,
    n_patches, vit_dim) as N(0, 1), in float32 (the model casts them to
    its dtype)."""
    out = {"tokens": torch.as_tensor(synthetic_batch(
        seed, step, B, S, cfg.vocab)).to(device)}
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 1]))
    if cfg.family == "encdec":
        out["frames"] = 0.1 * rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model))
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal((B, cfg.n_patches, cfg.vit_dim))
    return {k: v if k == "tokens" else torch.as_tensor(
        v.astype(np.float32)).to(device) for k, v in out.items()}


def greedy_decode(prefill, decode, tokens, steps: int,
                  extra: dict | None = None) -> dict:
    """Prefill ``tokens`` (B, S) (with ``extra``: whisper's ``frames``,
    the VLM's ``patches``, before the text), then ``steps`` greedy
    decode steps from the position after the prefill's last (S, or P + S
    after P patches), each fed the previous argmax.  Returns the logits
    of the prefill's last position and of every step (steps + 1, B, Vp)
    and the tokens (B, steps + 1), as NumPy, and the final ``cache``."""
    B, S = tokens.shape
    extra = extra or {}
    start = S + (extra["patches"].shape[1] if "patches" in extra else 0)
    logits, cache = prefill({"tokens": tokens, **extra})
    logits = whole(logits)
    out_l, out_t = [logits.float().cpu().numpy()], []
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    for t in range(steps):
        out_t.append(tok.cpu().numpy())
        pos = torch.full((B,), start + t, dtype=torch.int32,
                         device=tokens.device)
        tok, logits, cache = decode(cache, {"token": tok[:, None],
                                            "pos": pos})
        out_l.append(whole(logits).float().cpu().numpy())
    out_t.append(tok.cpu().numpy())
    return {"logits": np.stack(out_l), "tokens": np.stack(out_t, axis=1),
            "cache": cache}


def _leaf_report(tree, ref=None) -> dict:
    """Per leaf (key path string): global and local shape, placements,
    and against ``ref`` (the same tree as NumPy, whole) the largest
    |diff| and |ref| over this rank's block."""
    out = {}

    def one(path, x):
        local = x.to_local() if isinstance(x, DTensor) else x
        rec = {"shape": tuple(x.shape), "local": tuple(local.shape),
               "placements": str(tuple(getattr(x, "placements", ())))}
        if ref is not None:
            want = torch.as_tensor(_at(ref, path)).to(local.device)
            if isinstance(x, DTensor):
                want = shd.place(want, x.device_mesh, x.placements
                                 ).to_local()
            rec["max_diff"] = float((local.detach().float()
                                     - want.float()).abs().max())
            rec["max_ref"] = float(want.abs().max())
        out["/".join(map(str, path))] = rec
    PT.map_with_path(one, tree)
    return out


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _counters() -> dict:
    from repro_torch.kernels.decode_gqa import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    return {"flash_attention": fa_ops.LAUNCHES,
            "decode_gqa": dec_ops.LAUNCHES, "ssd_chunk": ssd_ops.LAUNCHES}


def _reset_counters() -> None:
    from repro_torch.kernels.decode_gqa import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    fa_ops.LAUNCHES = dec_ops.LAUNCHES = ssd_ops.LAUNCHES = 0


def _launch_shapes(clear: bool = False) -> dict:
    """The shapes the three kernels were launched at (``ops.SHAPES``),
    sorted, by kernel; ``clear`` empties the sets after."""
    from repro_torch.kernels.decode_gqa import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    out = {}
    for name, mod in (("flash_attention", fa_ops), ("decode_gqa", dec_ops),
                      ("ssd_chunk", ssd_ops)):
        out[name] = sorted(mod.SHAPES)
        if clear:
            mod.SHAPES.clear()
    return out


def mesh_steps_rank(rank: int, relay, jobs: list) -> list:
    """One rank of the LM steps on meshes over the process group, one
    job after another (the tests' and ``chip_smoke.py``'s harness).  A
    job is a dict:

    - ``arch``, ``smoke``, ``n_layers``, ``param_dtype``, ``head_dim``
      (:func:`mesh_config`),
      ``seed`` (weights: ``torch.Generator(device).manual_seed(seed)``
      on every rank, as a one-process run draws them), ``device``
      (``cuda`` or ``cpu``), ``mesh`` (a (data, model) shape);
    - ``train``: ``steps``, ``batch``, ``seq``, ``total_steps`` and
      ``ref`` (optional: a checkpoint directory holding the one-process
      run's ``params`` after the steps): the steps' metrics, the batches
      of :func:`train_batch` (data seed ``seed``), every leaf against
      ``ref``;
    - ``elastic``: ``dir`` and ``meshes``: the state ({"params", "opt"},
      after the train steps if any; the params alone with ``state``
      false) saved on the job's mesh and ``reshard_restore``d onto each
      of these meshes, each rank's block compared bit for bit;
    - ``restore``: a directory holding a checkpoint of ``params`` written
      by anyone (the JAX package too): ``reshard_restore``d onto the
      job's mesh, each block compared with the host restore's;
    - ``serve``: ``batch``, ``seq``, ``steps``, ``pad_to``: a prefill
      and greedy decode steps (:func:`greedy_decode`) with the weights
      of the job (after training if any).

    Returns a dict a job: ``train`` (the metrics a step), ``params``
    (:func:`_leaf_report` against ``ref``), ``elastic`` (a record a
    mesh: leaves, ``equal``), ``restore`` (the same), ``serve`` (logits
    and tokens, rank 0 only), ``cache`` (the prefill cache's leaf
    report), ``launches`` (this rank's ``flash_attention`` /
    ``decode_gqa`` / ``ssd_chunk`` launches in the train steps and in
    the serve steps), ``shapes`` (the shapes of those launches by
    kernel, :func:`_launch_shapes`), ``peak_gb`` (the card's peak
    allocation, None on the CPU), ``secs``, ``laps`` (its seconds by
    part: setup, train, compare, elastic, serve) and the modules of JAX
    or ``repro`` it has loaded (none)."""
    import sys
    out = []
    for job in jobs:
        t0 = time.perf_counter()
        device = resolve_device(job["device"])
        laps, last = {}, [t0]

        def lap(name: str) -> None:
            if device.type == "cuda":
                torch.cuda.synchronize()
            now = time.perf_counter()
            laps[name], last[0] = now - last[0], now
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        cfg = mesh_config(job["arch"], smoke=job.get("smoke", False),
                          n_layers=job.get("n_layers"),
                          param_dtype=job.get("param_dtype"),
                          head_dim=job.get("head_dim"))
        rules = shd.make_rules(False)
        mesh = make_mesh(tuple(job["mesh"]), ("data", "model"), device.type)
        model = LM(cfg, device=device).init(
            torch.Generator(device=device).manual_seed(job["seed"]))
        params = device_put_like(model.params, mesh, rules)
        model.params = None
        res = {"mesh": tuple(job["mesh"]), "launches": {}, "laps": laps}
        _launch_shapes(clear=True)
        lap("setup")
        if job.get("train"):
            tr = job["train"]
            step_fn, opt = make_train_step(model, mesh=mesh, rules=rules,
                                           total_steps=tr["total_steps"])
            state = opt.init(params)
            _reset_counters()
            hist = []
            for i in range(tr["steps"]):
                batch = train_batch(cfg, job["seed"], i, tr["batch"],
                                    tr["seq"], device)
                params, state, m = step_fn(params, state, batch, i)
                hist.append({k: float(v) for k, v in m.items()})
            res["launches"]["train"] = _counters()
            lap("train")
            ref = (restore_checkpoint(tr["ref"])[0]["params"]
                   if tr.get("ref") else None)
            res["train"] = hist
            res["params"] = _leaf_report(params, ref)
            res["opt"] = _leaf_report(state)
            lap("compare")
        else:
            state = None
            res["params"] = _leaf_report(params)
        if job.get("elastic"):
            res["elastic"] = _elastic(params, state, mesh, rules,
                                      job["elastic"], device)
            lap("elastic")
        if job.get("restore"):
            host, _, _ = restore_checkpoint(job["restore"], tree_map(
                lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                {"params": params}))
            want = tree_map(lambda a: torch.as_tensor(a).to(device), host)
            res["restore"] = _restore_check(job["restore"], want,
                                            job["mesh"], rules, device)
        if job.get("serve"):
            sv = job["serve"]
            model.params = params
            batch = train_batch(cfg, job["seed"] + 1, 0, sv["batch"],
                                sv["seq"], device)
            _reset_counters()
            got = greedy_decode(
                make_prefill_step(model, pad_to=sv["pad_to"], mesh=mesh,
                                  rules=rules),
                make_decode_step(model, mesh=mesh, rules=rules),
                batch.pop("tokens"), sv["steps"], batch)
            res["launches"]["serve"] = _counters()
            res["cache"] = _leaf_report(got.pop("cache"))
            res["serve"] = got if rank == 0 else None
            model.params = None
            lap("serve")
        res["shapes"] = _launch_shapes()
        res["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                          if device.type == "cuda" else None)
        res["secs"] = time.perf_counter() - t0
        res["loaded"] = sorted(m for m in sys.modules
                               if m == "jax" or m.startswith(("jax.",
                                                              "repro.")))
        relay(f"[rank {rank}] mesh {tuple(job['mesh'])} job done in "
              f"{res['secs']:.1f}s")
        out.append(res)
        del params, state, model
    return out


def _elastic(params, state, mesh, rules, el: dict, device) -> list:
    """Save ``{"params", "opt"}`` placed on ``mesh``, restore it onto each
    mesh of ``el["meshes"]`` and compare every leaf's block with the
    block that mesh's placements cut from the saved values, bit for
    bit."""
    tree = {"params": params} if state is None or not el.get(
        "state", True) else {"params": params, "opt": state}
    save_checkpoint(el["dir"], 0, tree, {"step": 0})
    want = tree_map(whole, tree)
    return [_restore_check(el["dir"], want, m, rules, device)
            for m in el["meshes"]]


def _restore_check(directory: str, want, shape, rules, device) -> dict:
    """``reshard_restore`` of ``directory`` onto a (data, model) mesh of
    ``shape``, like ``want`` (the whole values every rank holds): every
    leaf's block bit-equal to the block of ``want``."""
    mesh = make_mesh(tuple(shape), ("data", "model"), device.type)
    like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), want)
    got, step, _ = reshard_restore(directory, like, mesh, rules=rules)
    n, equal = [0], [True]

    def check(path, g):
        w = _at(want, path)
        if isinstance(g, DTensor):
            g, w = g.to_local(), shd.place(w, mesh, g.placements).to_local()
        n[0] += 1
        equal[0] &= bool(torch.equal(g.cpu(), w.cpu()))
    PT.map_with_path(check, got)
    return {"mesh": tuple(shape), "leaves": n[0], "equal": equal[0],
            "step": step, "placements": _leaf_report(got)}


if __name__ == "__main__":
    main()
