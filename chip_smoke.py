"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

Run from the root of a checkout, with one card and ``nvcc``:

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero and prints
no result:

1. ``build``            compile every kernel of the serving path from
                        ``src/repro_torch/csrc`` with ``nvcc`` (sm_90a);
2. ``kernel:lstm_seq``  the kernel against its plain PyTorch version on
                        the card at four shapes with ragged, all-false
                        and random masks (atol = rtol = 1e-4: the same
                        float32 sums in another order over up to 97
                        recurrent steps); kernel, plain and cuDNN
                        ``torch.nn.LSTM`` times at the serving shape
                        beside the kernel's bound;
3. ``serve:relmas``     the driver ``repro_torch.launch.serve.main`` at
                        the paper's policy width (hidden 256, paper6
                        fleet, mixed workload, 96 RQ slots, 64 jobs,
                        60 periods, 32 streams); the kernel must launch
                        exactly once per tick;
4. ``serve:fcfs``       the same streams under the FCFS heuristic;
5. ``parity``           the same streams through the port on the CPU
                        (plain versions) and on the card, relmas and
                        fcfs: equal ``counted``, per-stream ``hits``
                        within 1% of ``counted``; with host-clock
                        spans (synchronised) around the engine, the
                        actor and the greedy heuristic on the card run.

Then a ``kernels`` JSON line, the card's name and power limit as
``nvidia-smi`` reports them, and a last JSON line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PEAK_F32_FLOPS = 67e12      # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
TOL = 1e-4
SERVE_ARGS = ["--workload", "mixed", "--fleet", "paper6", "--hidden", "256",
              "--batched", "--streams", "32", "--requests", "32",
              "--scenario", "steady", "--rate-scale", "1.0",
              "--periods", "60", "--max-rq", "96", "--max-jobs", "64"]
KERNEL_SHAPES = [(97, 32, 16, 256), (97, 1, 16, 256), (97, 32, 16, 64),
                 (12, 33, 23, 64)]


def card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"[{name}] start", flush=True)
    try:
        yield
    except BaseException:
        print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f}s",
              flush=True)
        raise
    print(f"[{name}] ok in {time.perf_counter() - t0:.1f}s", flush=True)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def lstm_inputs(T, B, F, H, gen, full_mask=False):
    xs = torch.randn((T, B, F), generator=gen)
    wx = torch.randn((F, 4 * H), generator=gen) * 0.1
    wh = torch.randn((H, 4 * H), generator=gen) * 0.1
    b = torch.randn((4 * H,), generator=gen) * 0.1
    if full_mask:
        mask = torch.ones((T, B), dtype=torch.bool)
    else:
        # ragged prefixes; with 3+ rows also an all-false and a random row
        lens = torch.randint(1, T + 1, (B,), generator=gen)
        mask = torch.arange(T)[:, None] < lens[None, :]
        if B >= 3:
            mask[:, 1] = False
            mask[:, 2] = torch.rand((T,), generator=gen) < 0.6
    return [x.cuda().contiguous() for x in (xs, mask, wx, wh, b)]


def lstm_bound_ms(T, B, F, H, mask) -> tuple[float, str]:
    """Least time for the call: its float32 multiply-adds on the
    unmasked steps over the float32 peak, or its bytes (each input read
    once, hs written once) over the memory rate, whichever is larger."""
    steps = int(mask.sum())
    flops = 2.0 * steps * (F + H) * 4 * H
    nbytes = 4 * (T * B * F + F * 4 * H + H * 4 * H + 4 * H + T * B * H) \
        + T * B
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                      else "bytes")


def check_kernel(ops, ref, CARD):
    gen = torch.Generator().manual_seed(0)
    max_err = 0.0
    with torch.no_grad():
        for (T, B, F, H) in KERNEL_SHAPES:
            for full in (False, True):
                args = lstm_inputs(T, B, F, H, gen, full_mask=full)
                got = ops.lstm_seq(*args)
                want = ref.lstm_seq_ref(*args)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                ok = torch.allclose(got, want, atol=TOL, rtol=TOL)
                print(f"  lstm_seq T={T} B={B} F={F} H={H} "
                      f"mask={'full' if full else 'ragged'} "
                      f"max_abs_err={err:.3e} ok={ok}", flush=True)
                if not ok:
                    raise AssertionError(f"lstm_seq disagrees with its plain "
                                         f"version at {(T, B, F, H)}")
                max_err = max(max_err, err)
            ms = cuda_ms(lambda: ops.lstm_seq(*args), reps=20)
            print(f"  lstm_seq T={T} B={B} F={F} H={H} full mask "
                  f"[{CARD}]: kernel_ms={ms:.4f}", flush=True)
        # timing at the serving shape, full mask: the same function as
        # cuDNN's LSTM there (weights in PyTorch's (4H, in) layout)
        T, B, F, H = KERNEL_SHAPES[0]
        args = lstm_inputs(T, B, F, H, gen, full_mask=True)
        xs, mask, wx, wh, b = args
        lstm = torch.nn.LSTM(F, H).cuda()
        lstm.weight_ih_l0.copy_(wx.t())
        lstm.weight_hh_l0.copy_(wh.t())
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
        lib_err = (lstm(xs)[0] - ref.lstm_seq_ref(*args)).abs().max().item()
        kernel_ms = cuda_ms(lambda: ops.lstm_seq(*args), reps=50)
        plain_ms = cuda_ms(lambda: ref.lstm_seq_ref(*args), reps=10)
        library_ms = cuda_ms(lambda: lstm(xs), reps=50)
        bound_ms, bound_by = lstm_bound_ms(T, B, F, H, mask)
    print(f"  lstm_seq T={T} B={B} F={F} H={H} full mask [{CARD}]: "
          f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} (cuDNN nn.LSTM, max_abs_err vs "
          f"plain {lib_err:.2e}) bound_ms={bound_ms:.4f} ({bound_by})",
          flush=True)
    return dict(max_abs_err=max_err, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


class Spans:
    """Synchronised host-clock spans around named functions of a module,
    installed for one run and removed after it."""

    def __init__(self, targets):
        self.targets = targets          # [(module, attr, label)]
        self.us = {label: 0.0 for _, _, label in targets}

    def __enter__(self):
        self.saved = []
        for mod, attr, label in self.targets:
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))

            def timed(*a, _fn=fn, _label=label, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a, **k)
                torch.cuda.synchronize()
                self.us[_label] += (time.perf_counter() - t0) * 1e6
                return out
            setattr(mod, attr, timed)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


def serve_phase(serve_cli, ops, policy, CARD):
    ops.LAUNCHES = 0
    out = serve_cli.main(SERVE_ARGS + ["--policy", policy])
    launches = ops.LAUNCHES
    if not out["counted"] > 0 or not 0.0 <= out["sla_rate"] <= 1.0:
        raise AssertionError(f"serve:{policy}: counted={out['counted']} "
                             f"sla_rate={out['sla_rate']}")
    expected = out["ticks"] if policy == "relmas" else 0
    if launches != expected:
        raise AssertionError(f"serve:{policy}: lstm_seq launched "
                             f"{launches} times in {out['ticks']} ticks, "
                             f"expected {expected}")
    print(f"  serve:{policy} [{CARD}]: ticks={out['ticks']} "
          f"lstm_seq launches={launches} tick_p50_ms="
          f"{out['tick_p50_us'] / 1e3:.3f} tick_p99_ms="
          f"{out['tick_p99_us'] / 1e3:.3f} sla_rate={out['sla_rate']:.4f} "
          f"counted={out['counted']}", flush=True)
    return launches


def parity_phase(serve_cli, policy, CARD):
    from repro_torch.core import baselines
    from repro_torch.kernels.lstm_seq import ops
    from repro_torch.sim import engine
    results = {}
    for dev in ("cpu", "cuda"):
        args = serve_cli.parse_args(SERVE_ARGS + ["--policy", policy,
                                                  "--device", dev])
        svc = serve_cli.build_service(args)
        if dev == "cpu":
            _, results[dev] = serve_cli.serve_batched(svc, args)
            continue
        spans = Spans([(engine, "simulate", "engine"),
                       (ops, "lstm_seq", "lstm_seq"),
                       (baselines, "_greedy_sa", "greedy_sa")])
        with spans:
            _, results[dev] = serve_cli.serve_batched(svc, args)
        tick_us = float(np.sum(results[dev]["stats"]["tick_wall_us"]))
        shares = " ".join(f"{k}_share={v / tick_us:.4f}"
                          for k, v in spans.us.items() if v)
        print(f"  parity:{policy} card run with synchronised spans "
              f"[{CARD}]: tick_total_ms={tick_us / 1e3:.1f} {shares}",
              flush=True)
    cpu, gpu = results["cpu"], results["cuda"]
    n_diff = 0
    for s, (mc, mg) in enumerate(zip(cpu["metrics"], gpu["metrics"])):
        if mc["counted"] != mg["counted"]:
            raise AssertionError(f"parity:{policy} stream {s}: counted "
                                 f"{mg['counted']} on the card, "
                                 f"{mc['counted']} on the CPU")
        if abs(mc["hits"] - mg["hits"]) > 0.01 * mc["counted"]:
            raise AssertionError(f"parity:{policy} stream {s}: hits "
                                 f"{mg['hits']} vs {mc['hits']}")
        key = lambda c: (c["rid"], c["hit"], c["missed"])
        a = {key(c) for c in cpu["completions"][s]}
        b = {key(c) for c in gpu["completions"][s]}
        n_diff += len(a ^ b)
    print(f"  parity:{policy}: streams={len(cpu['metrics'])} "
          f"counted={cpu['aggregate']['counted']} "
          f"hits cpu={cpu['aggregate']['hits']} "
          f"card={gpu['aggregate']['hits']} "
          f"completions differing={n_diff}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs one GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels.lstm_seq import ops, ref
    from repro_torch.launch import serve as serve_cli

    CARD = card()
    print(f"card: {CARD}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with phase("build"):
        for f in ops.BUILD_DIR.glob("liblstm_seq_*.so"):
            f.unlink()                      # build from source in this run
        t0 = time.perf_counter()
        lib = ops.build()
        print(f"  nvcc {lib.name}: {time.perf_counter() - t0:.1f}s",
              flush=True)
    with phase("kernel:lstm_seq"):
        kinfo = check_kernel(ops, ref, CARD)
    with phase("serve:relmas"):
        launches = serve_phase(serve_cli, ops, "relmas", CARD)
    with phase("serve:fcfs"):
        serve_phase(serve_cli, ops, "fcfs", CARD)
    with phase("parity"):
        for policy in ("relmas", "fcfs"):
            parity_phase(serve_cli, policy, CARD)

    kernels = [dict(name="lstm_seq", route="cuda",
                    source="src/repro_torch/csrc/lstm_seq.cu",
                    replaces="src/repro/kernels/lstm_seq/lstm_seq.py:70",
                    launches=launches, **kinfo)]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(CARD, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
