"""The comparison's readings on the card, for setting its limits: the
program's over a dozen seeds or more, and the control's (the reference
in the next precision below the configuration's, put in the program's
place) over three or more, at the cell's own size, in one process.

    python3 portbench/control.py --workload paper6-mixed-pareto \
        --seeds 101 102 ... --control-seeds 101 102 103 [--streams S] \
        [--json FILE]

Each seed serves one call of the cell's streams (the window's call),
with ``check_pairs`` streams sampled from it, and holds them to the
reference; a control seed also holds the control's periods, computed
from the same start states.  The benchmark's own runs never run it.
"""
import time

T_START = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from portbench.run import _setup_env  # noqa: E402


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--streams", type=int, default=0)
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    from portbench import harness
    from portbench.runners import relmas
    ctx = harness.load_ctx(args.workload, args.seeds[0], 0.0, False,
                           "cuda", T_START)
    n = int(ctx.traffic["check_pairs"])
    ctx.traffic = dict(ctx.traffic, check_streams_per_call=n)
    if args.streams:
        ctx.traffic["streams"] = args.streams
    sess = relmas.Session(ctx.config, "cuda")
    K = int(ctx.traffic["tick_k"])
    sess.serve(sess.draw(args.seeds[0], ctx.traffic), 0, K)   # warm-up
    rows = []
    for seed in args.seeds:
        ctx.seed = seed
        ctx.control = "cuda" if seed in args.control_seeds else None
        t0 = time.perf_counter()
        res = relmas.run(ctx, sess)
        row = dict(seed=seed, program={k: res["readings"][k]
                                       for k in relmas.ref.NUMBERS},
                   compared=res["readings"]["compared"],
                   notes=res["readings"]["notes"][:5],
                   call_s=res["call_s"], check_s=res["check_s"],
                   seconds=time.perf_counter() - t0)
        if ctx.control is not None:
            row["control"] = {k: res["control_readings"][k]
                              for k in relmas.ref.NUMBERS}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = dict(workload=args.workload, streams=ctx.traffic["streams"],
                   lower={k: max(r["program"][k] for r in rows)
                          for k in relmas.ref.NUMBERS})
    ctl = [r["control"] for r in rows if "control" in r]
    if ctl:
        summary["upper"] = {k: min(c[k] for c in ctl)
                            for k in relmas.ref.NUMBERS}
    summary["card"] = harness.card()
    print(json.dumps(summary), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(rows=rows, summary=summary), f, indent=1)
    return 0


if __name__ == "__main__":
    _setup_env()
    sys.exit(main(sys.argv[1:]))
