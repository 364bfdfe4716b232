"""Where an LM's logits on a (data, model) mesh part from the one-process
run's: the prefill and greedy decode steps of ``chip_smoke.py``'s phase
47 (FM_* sizes, float32, full width cut in depth), step by step, in
three comparisons a family:

- ``rows``: the one-process run on one row of the batch against the
  same row of the whole batch, the same weights (the seed's): what the
  batch's size alone moves (another GEMM split, another sum order);
- ``mesh``: 2 gloo ranks on (2, 1) and on (1, 2) against the
  one-process run on the seed's weights, no training: what the mesh's
  forward moves;
- ``trained``: the same after ``chip_smoke``'s 2 train steps on each
  side (the comparison phase 47 makes): what the mesh's forward and
  its own trained weights move together, with the largest parameter
  gap in units of 2 lr per step (phase 47's limit is 1).

    python scripts/mesh_serve_gap.py [--arch ARCH ...] [--n-layers 2]
                                     [--device cuda|cpu] [--smoke]

(``--smoke``: the smoke configs, whole, for a rehearsal on the CPU.)

Prints a line a comparison (the largest |logit difference| of the
prefill's last position and of each decode step, the largest |logit|,
tokens equal or not) and a last JSON line of every number.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

sys.path[:0] = [os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"), os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def serve(model, batch, device):
    from repro_torch.launch import train
    from repro_torch.models import make_decode_step, make_prefill_step
    batch = dict(batch)
    out = train.greedy_decode(make_prefill_step(model, pad_to=cs.FM_PAD),
                              make_decode_step(model), batch.pop("tokens"),
                              cs.FM_DEC, batch)
    out.pop("cache")
    return out


def gap(got, want) -> dict:
    d = np.abs(got["logits"] - want["logits"])
    return {"per_step": [float(x) for x in d.max(axis=(1, 2))],
            "max_logit": float(np.abs(want["logits"]).max()),
            "tokens_equal": bool(np.array_equal(got["tokens"],
                                                want["tokens"]))}


def show(arch, what, g) -> None:
    print(f"  {arch} {what}: max |diff| a step (prefill first) "
          + " ".join(f"{x:.2e}" for x in g["per_step"])
          + f"; max |logit| {g['max_logit']:.2f}; tokens equal "
          f"{g['tokens_equal']}" + (f"; parameters {g['params']:.4f} of "
                                    f"the limit" if "params" in g else ""),
          flush=True)


def run(arch: str, cut: dict, device: str, tmp: str) -> dict:
    from repro_torch.launch import rl_train, train
    from repro_torch.models import LM
    cfg = train.mesh_config(arch, **cut)
    out = {}
    model = LM(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(0))
    batch = train.train_batch(cfg, 1, 0, cs.FM_SB, cs.FM_SS, device)
    whole = serve(model, batch, device)
    for r in range(cs.FM_SB):
        one = serve(model, {k: v[r:r + 1] for k, v in batch.items()},
                    device)
        want = {k: v[:, r:r + 1] if k == "logits" else v[r:r + 1]
                for k, v in whole.items()}
        out[f"rows row {r}"] = gap(one, want)
    cs.free(model)
    ref_dir = os.path.join(tmp, arch)
    ref = cs.mesh_reference(cfg, ref_dir, cs.FM_STEPS, cs.FM_B, cs.FM_S,
                            (cs.FM_SB, cs.FM_SS, cs.FM_DEC, cs.FM_PAD),
                            device)
    base = dict(arch=arch, **cut, seed=0, device=device)
    sv = dict(batch=cs.FM_SB, seq=cs.FM_SS, steps=cs.FM_DEC,
              pad_to=cs.FM_PAD)
    jobs = [dict(base, mesh=m, serve=sv) for m in cs.FM_MESHES]
    jobs += [dict(base, mesh=m, serve=sv,
                  train=dict(steps=cs.FM_STEPS, batch=cs.FM_B, seq=cs.FM_S,
                             total_steps=100, ref=ref_dir))
             for m in cs.FM_MESHES]
    ranks = rl_train.spawn_ranks(train.mesh_steps_rank, 2, jobs,
                                 device=device, backend="gloo",
                                 timeout=cs.FM_RANK_TIMEOUT_S)
    lrs = sum(h["lr"] for h in ref["hist"])
    for j, job in enumerate(jobs):
        res = ranks[0][j]
        if "train" in job:
            g = gap(res["serve"], ref["serve"])
            g["params"] = max(
                v["max_diff"] / (2 * lrs + 1e-5 * v["max_ref"])
                for rk in ranks for v in rk[j]["params"].values())
            out[f"trained {job['mesh']}"] = g
        else:
            out[f"mesh {job['mesh']}"] = gap(res["serve"], whole)
    for what, g in out.items():
        show(arch, what, g)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+",
                    default=["mamba2-2.7b", "internlm2-1.8b"])
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    a = ap.parse_args(argv)
    cut = (dict(smoke=True) if a.smoke else
           dict(n_layers=a.n_layers, param_dtype="float32"))
    if a.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = cs.card()
    else:
        card = "cpu"
    print(f"mesh_serve_gap [{card}]", flush=True)
    os.makedirs(os.path.join(cs.ROOT, "runs"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="mesh_gap-", dir=os.path.join(cs.ROOT,
                                                                "runs"))
    try:
        res = {arch: run(arch, cut, a.device, tmp) for arch in a.arch}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"card": card, "gaps": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
