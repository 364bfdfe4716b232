"""Host time a call of each kernel wrapper, on one GPU.

    python scripts/wrapper_host_us.py [--calls N]

Run from the root of a checkout (its ``src/repro_torch`` is imported):
the kernels are built there, then each of the five wrappers
(``lstm_seq``, ``flash_attention``, ``decode_gqa``, ``ssd_chunk``'s
``ssd_intra``, ``lstm_cell``) is called ``N`` times back to back at a
shape small enough that its kernel takes less time than the call, and
the host's wall time a call is printed (the mean of 5 runs of N calls
each, the card synchronised before and after each run), with the
``launches`` each run counted.  Comparing two checkouts on one card in
one session shows what a change to the wrappers costs on the host.  The
last line is a JSON object with the card and the microseconds a call.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.getcwd()
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402


def card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def host_us(fn, counter, calls: int, runs: int = 5) -> tuple[float, int]:
    """(mean host microseconds a call, launches a run)."""
    for _ in range(20):
        fn()
    times, launched = [], 0
    for _ in range(runs):
        torch.cuda.synchronize()
        before = counter()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        launched = counter() - before
        times.append((t1 - t0) / calls * 1e6)
    return sum(times) / len(times), launched


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write("wrapper_host_us: needs a GPU\n")
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_gqa import ops as dec
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.lstm_cell import ops as cell
    from repro_torch.kernels.lstm_seq import ops as seq
    from repro_torch.kernels.ssd_chunk import ops as ssd
    for name in ("lstm_seq", "flash_attention", "decode_gqa", "ssd_chunk",
                 "lstm_cell"):
        _build.build(name)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    bf = torch.bfloat16
    q, k, v = rnd(1, 2, 64, 64, dtype=bf), rnd(1, 1, 64, 64, dtype=bf), \
        rnd(1, 1, 64, 64, dtype=bf)
    qd, kd, vd = rnd(1, 2, 1, 64, dtype=bf), rnd(1, 1, 64, 64, dtype=bf), \
        rnd(1, 1, 64, 64, dtype=bf)
    length = torch.full((1,), 64, dtype=torch.int32, device="cuda")
    H = 32
    x, h, c = rnd(2, 16), rnd(2, H), rnd(2, H)
    wx, wh, b = rnd(16, 4 * H), rnd(H, 4 * H), rnd(4 * H)
    xs = rnd(2, 2, 16)
    mask = torch.ones((2, 2), dtype=torch.bool, device="cuda")
    cm, bm = rnd(1, 16, 16), rnd(1, 16, 16)
    xdt, cum = rnd(1, 8, 16, 16), rnd(1, 8, 16)
    cases = {
        "lstm_seq": (lambda: seq.lstm_seq(xs, mask, wx, wh, b),
                     lambda: seq.LAUNCHES),
        "flash_attention": (lambda: fa.flash_attention(q, k, v),
                            lambda: fa.LAUNCHES),
        "decode_gqa": (lambda: dec.decode_attention(qd, kd, vd, length),
                       lambda: dec.LAUNCHES),
        "ssd_chunk": (lambda: ssd.ssd_intra(cm, bm, xdt, cum),
                      lambda: ssd.LAUNCHES),
        "lstm_cell": (lambda: cell.lstm_cell(x, h, c, wx, wh, b),
                      lambda: cell.LAUNCHES),
    }
    name_card = card()
    out = {}
    with torch.no_grad():
        for name, (fn, counter) in cases.items():
            us, launched = host_us(fn, counter, args.calls)
            if launched != args.calls:
                raise AssertionError(f"{name}: {launched} launches for "
                                     f"{args.calls} calls")
            out[name] = us
            sys.stdout.write(f"{name} [{name_card}]: {us:.2f} us a call "
                             f"({args.calls} calls x 5 runs, {launched} "
                             f"launches a run)\n")
    sys.stdout.write(json.dumps({"card": name_card, "root": ROOT,
                                 "host_us": out}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
