"""Time ``chip_smoke.py``'s LM serving phases on two checkouts of the
repo, in the order A B B A, on one GPU.

    python scripts/chip_phase_ab.py DIR_A DIR_B [--out DIR]

Each run is a fresh process that puts the checkout's ``src`` and root
first on ``sys.path``, builds its kernels and runs the serving phases of
its own ``chip_smoke.py`` in that script's order: internlm2-1.8b,
mamba2-2.7b, whisper-tiny, olmoe-1b-7b, jamba (one super-block) and
internvl2-76b (8 layers), each model's prefill/decode, batcher and
parity phases.  The internlm2 and olmoe batchers serve 32 requests in
both checkouts, so the two do the same work.  A run's output goes to
``<out>/ab_<i>_<A|B>.txt`` (``runs/chip_phase_ab`` by default); the
script prints each phase's seconds per run and, last, a JSON line with
the per-checkout means.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys, time
tree = sys.argv[1]
sys.path[:0] = [tree + "/src", tree]
import torch
import chip_smoke as cs
CARD = cs.card()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
times = {}

def run(name, fn):
    with cs.phase(name):
        t0 = time.perf_counter()
        out = fn()
        times[name] = time.perf_counter() - t0
    return out

def batcher(model):
    cs.serve_batcher(model, n=32, n_slots=16, smax=512, prompt_len=32,
                     max_new=64)

run("build", lambda: cs.build_all(["flash_attention", "decode_gqa",
                                   "ssd_chunk"]))
plan = [
    (cs.LM_ARCH, None, [("lm:prefill_decode", cs.lm_prefill_decode_phase),
                        ("lm:batcher", lambda m, c: batcher(m)),
                        ("lm:parity", cs.lm_parity_phase)]),
    (cs.MAMBA_ARCH, None,
     [("lm:mamba2_prefill_decode", cs.mamba_prefill_decode_phase),
      ("lm:mamba2_batcher", cs.mamba_batcher_phase),
      ("lm:mamba2_parity", cs.mamba_parity_phase)]),
    (cs.WH_ARCH, None,
     [("lm:whisper_prefill_decode", cs.whisper_prefill_decode_phase),
      ("lm:whisper_parity", cs.whisper_parity_phase)]),
    (cs.OLMOE_ARCH, None,
     [("lm:olmoe_prefill_decode", cs.olmoe_prefill_decode_phase),
      ("lm:olmoe_batcher", lambda m, c: batcher(m)),
      ("lm:olmoe_parity", cs.olmoe_parity_phase)]),
    (cs.JAMBA_ARCH, cs.JAMBA_LAYERS,
     [("lm:jamba_prefill_decode", cs.jamba_prefill_decode_phase),
      ("lm:jamba_batcher", cs.jamba_batcher_phase),
      ("lm:jamba_parity", cs.jamba_parity_phase)]),
    (cs.VLM_ARCH, cs.VLM_LAYERS,
     [("lm:vlm_prefill_decode", cs.vlm_prefill_decode_phase),
      ("lm:vlm_batcher", cs.vlm_batcher_phase),
      ("lm:vlm_parity", cs.vlm_parity_phase)]),
]
for arch, layers, phases in plan:
    t0 = time.perf_counter()
    model = cs.lm_from_seed(arch, layers)
    times["init:" + arch] = time.perf_counter() - t0
    for name, fn in phases:
        run(name, lambda: fn(model, CARD))
    cs.free(model)
print(json.dumps({"card": CARD, "seconds": times}))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--out", default=os.path.join("runs", "chip_phase_ab"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    trees = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    runs = []
    for i, which in enumerate("ABBA"):
        log = os.path.join(args.out, f"ab_{i}_{which}.txt")
        with open(log, "w") as f:
            res = subprocess.run([sys.executable, "-c", CHILD, trees[which]],
                                 stdout=f, stderr=subprocess.STDOUT,
                                 cwd=trees[which], timeout=1200)
        with open(log) as f:
            last = f.read().strip().splitlines()[-1]
        if res.returncode != 0:
            print(f"run {i} ({which}) failed with {res.returncode}: {last}")
            return 1
        runs.append((which, json.loads(last)))
    names = list(runs[0][1]["seconds"])
    print(f"card: {runs[0][1]['card']}")
    print("phase " + " ".join(f"{i}:{w}" for i, (w, _) in enumerate(runs)))
    for name in names + ["total"]:
        row = [sum(r["seconds"].values()) if name == "total"
               else r["seconds"][name] for _, r in runs]
        print(f"{name} " + " ".join(f"{x:.2f}" for x in row))
    mean = {w: {n: sum(r["seconds"][n] for v, r in runs if v == w) / 2
                for n in names} for w in "AB"}
    for w in "AB":
        mean[w]["total"] = sum(mean[w].values())
    print(json.dumps({"card": runs[0][1]["card"], "trees": trees,
                      "mean_seconds": mean}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
