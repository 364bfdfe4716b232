"""Where ``lstm_seq``'s time goes: edited builds of the kernel and every
launch plan, timed.

Each variant is ``src/repro_torch/csrc/lstm_seq.cu`` with one part of a
step's work taken out, so its output is wrong and is not checked; its
time beside the full kernel's says what that part costs inside the
whole.  Then the unedited kernel under every ``(units, rows)`` plan the
source builds, so the wrapper's plan can be held against the others.
Run from the root of a checkout, on a machine with the card and nvcc:

    python3 scripts/lstm_seq_variants.py

Prints the card, the clusters it holds at once, then each variant's
mean time (two runs of 50 calls, CUDA events) and its time per step at
the serving shape (T, B, F, H) = (97, 32, 16, 256) with a full mask,
under the plan ``ops.seq_plan`` picks.  The edits are text
substitutions on the source; a substitution that no longer matches the
source raises.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (puts src/ on the path)
import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.lstm_seq import ops  # noqa: E402

SHAPE = chip_smoke.KERNEL_SHAPES[0]
SEND = ("        st_async(mapa(dst + 16 * v, peer),\n"
        "                 reinterpret_cast<const float4*>(hloc)[v], "
        "mapa(bar, peer));\n")
EXPECT = "      if (tid == 0) mbar_expect_tx(bar, H * RS * 4);\n"
WAIT = "      mbar_wait(bar, (ex >> 1) & 1);\n"
PRODUCT = ("      if (t > 0) {       // acc += h_{t-1} @ Wh over this "
           "thread's slice")
XPART = "      x_part(t + 1);     // the input side runs while h_t is in flight\n"
CELL = ("        const float ig = sigmoid_f(g.x);\n"
        "        const float fg = sigmoid_f(g.y);\n"
        "        const float gg = tanh_f(g.z);\n"
        "        const float og = sigmoid_f(g.w);\n"
        "        const float c2 = fg * c + ig * gg;\n"
        "        const float h2 = og * tanh_f(c2);\n")
SUM = "for (int s = 0; s < SLICES; ++s) add4(g, red[(s * R + pr) * U + pu]);"
NO_EXCHANGE = [(SEND, ""), (EXPECT, ""), (WAIT, "")]
NO_PRODUCT = [(PRODUCT, PRODUCT.replace("t > 0", "t < 0"))]
NO_CELL = [(CELL, "        const float c2 = g.x + g.y * c, h2 = g.z + g.w;\n")]
NO_SUM = [(SUM, SUM.replace("s < SLICES", "s < 1"))]
NO_XPART = [(XPART, "")]
B2 = "      __syncthreads();   // hloc holds this CTA's slice of h_t\n"
SELF = [("for (int i = tid; i < C * NV; i += NT) {",
         "for (int i = tid; i < NV; i += NT) {"),
        ("const int peer = i / NV, v = i % NV;",
         "const int peer = rank, v = i % NV;"),
        ("mbar_expect_tx(bar, H * RS * 4)", "mbar_expect_tx(bar, U * RS * 4)")]
NO_PREFETCH = [("      if (t + 2 <= tlast) stage_x(b0, t + 2);   // two steps ahead\n",
                ""),
               ("        m_next = row_ok && mask[static_cast<size_t>(t + 1) * B + rb];",
                "        m_next = row_ok;")]
ALONE = NO_PRODUCT + NO_SUM + NO_CELL + NO_XPART
# name -> [(text, replacement)]
VARIANTS = {
    "full kernel": [],
    "no exchange (no stores, no wait)": NO_EXCHANGE,
    "no recurrent product": NO_PRODUCT,
    "no 16-slice sum (slice 0 only)": NO_SUM,
    "no sigmoid/tanh": NO_CELL,
    "no input side (x @ Wx)": NO_XPART,
    "exchange alone (no product, sum, cell math, input side)": ALONE,
    "exchange alone, no barrier before the stores": ALONE + [(B2, "")],
    "exchange alone, each CTA storing into itself only": ALONE + SELF,
    "exchange alone, no x or mask prefetch": ALONE + NO_PREFETCH,
    "barriers alone (no stores, no wait)": ALONE + NO_EXCHANGE,
}


def edited(base: str, name: str, subs) -> str:
    source = base
    for old, new in subs:
        if old not in source:
            raise ValueError(f"{name}: {old!r} not in the source")
        source = source.replace(old, new)
    return source


def build(source: str, out: str) -> str:
    path = out[:-3] + ".cu"
    with open(path, "w") as f:
        f.write(source)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, path],
                   check=True, capture_output=True, text=True)
    return out


def load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.lstm_seq_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.lstm_seq_launch.restype = ctypes.c_int
    lib.lstm_seq_error_string.argtypes = [ctypes.c_int]
    lib.lstm_seq_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("lstm_seq_variants: needs a CUDA card", file=sys.stderr)
        return 1
    T, B, F, H = SHAPE
    base = (_build.CSRC / "lstm_seq.cu").read_text()
    lib = ops._lib()
    dev = torch.device("cuda", 0)
    resident = ops.resident_clusters(lib, dev, F, H)
    plan = ops.seq_plan(B, H, resident)
    print(f"{chip_smoke.card()}; lstm_seq (T, B, F, H) = {SHAPE}, full "
          f"mask; resident clusters {resident}; plan {plan}", flush=True)
    gen = torch.Generator().manual_seed(0)
    args = chip_smoke.lstm_inputs(T, B, F, H, gen, full_mask=True)
    hs = torch.empty((T, B, H), device="cuda")

    def timed(lib_, plan_):
        return [chip_smoke.cuda_ms(lambda: ops.launch(lib_, plan_, *args, hs),
                                   reps=50) for _ in range(2)]

    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        sources = {name: edited(base, name, subs)
                   for name, subs in VARIANTS.items()}
        with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
            paths = dict(zip(sources, pool.map(
                lambda item: build(item[1], os.path.join(
                    tmp, f"libv{list(sources).index(item[0])}.so")),
                sources.items())))
        for name, path in paths.items():
            ms = timed(load(path), plan)
            print(f"  {name}: ms={ms[0]:.4f} {ms[1]:.4f} per_step_us="
                  f"{ms[0] * 1e3 / T:.3f}", flush=True)
        print("  plans (unedited kernel):", flush=True)
        for units, max_rows in ops.MAX_ROWS.items():
            C = H // units
            if resident.get(C, 0) < 1:
                continue
            for rows in range(1, max_rows + 1):
                p = ops.SeqPlan(units, C, rows,
                                min(-(-B // rows), resident[C]))
                ms = timed(lib, p)
                print(f"    {p}{' (chosen)' if p == plan else ''}: "
                      f"ms={ms[0]:.4f} {ms[1]:.4f} per_step_us="
                      f"{ms[0] * 1e3 / T:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
