"""One run of a cell at another number of streams, for choosing the
cell's size (the S sweep in ``PERF.md``), or with the sampled streams'
capture switched off, for measuring what that capture costs.

    python3 portbench/sweep.py --workload paper6-mixed-pareto \
        --streams 1024 --seed 5 --seconds 10 [--trace 0] [--no-capture]

Prints one JSON line: the streams, each call's seconds, the run's
end-to-end numbers (``--trace 0``) or per-layer metrics (``--trace 1``,
the default) and, with the capture on, whether the run was correct.
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
    ap.add_argument("--streams", type=int, default=0)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--no-capture", action="store_true")
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(1)
    from portbench import harness
    ctx = harness.load_ctx(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START)
    if args.streams:
        ctx.traffic = dict(ctx.traffic, streams=args.streams)
    line = dict(workload=args.workload, streams=ctx.traffic["streams"],
                capture=not args.no_capture, card=harness.card())
    if args.no_capture:
        ctx.capture = False
        res = harness.runner(ctx.config).run(ctx)
        line.update(end_to_end=res["metrics"])
    else:
        out, res = harness.run_cell(ctx)
        line.update(correct=out["correct"], metrics=out["metrics"],
                    end_to_end=res["metrics"], device=out["device"])
    line.update(call_s=res["call_s"], capture_s=res["capture_s"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    _setup_env()
    sys.exit(main(sys.argv[1:]))
