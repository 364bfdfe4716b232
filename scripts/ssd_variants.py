"""Where ``ssd_chunk``'s time goes: edited builds of the kernel, timed.

Each variant is ``src/repro_torch/csrc/ssd_chunk.cu`` with one part of
its work taken out, so its output is wrong and is not checked; its time
beside the full kernel's says what that part costs inside the whole.
Run from the root of a checkout, on a machine with the card and nvcc:

    python3 scripts/ssd_variants.py

Prints the card, then each variant's mean time (two runs of 20 calls) at
the mamba2-2.7b prefill shape of ``chip_smoke.py`` (the "model" draw).
The edits are text substitutions on the source; a substitution that no
longer matches the source raises.
"""
from __future__ import annotations

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
from repro_torch.kernels.ssd_chunk import ops  # noqa: E402

JOINT = "for (int kk = 0; kk < na; ++kk)"
ALONE = "for (int kk = na; kk < 2 * sb + 2; ++kk)"
LOADS = ("xr[t][0] = __ldg(xg + (8 * kk + tg) * Q + c4);\n"
         "        xr[t][1] = __ldg(xg + (8 * kk + tg + 4) * Q + c4);")
STORE = "if (n < Gm::NT8) {\n          const int col = n * 8 + 2 * tig;"
EXP = ('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : '
       '"f"(c * (-CLIP * LOG2E)));')
# name -> [(text, replacement)]
VARIANTS = {
    "full kernel": [],
    "no per-head k-loop (S phase, loads, splits into shared memory, "
    "stores)": [(JOINT, "for (int kk = 0; kk < 0; ++kk)"),
                (ALONE, "for (int kk = 2 * sb + 2; kk < 2 * sb + 2; ++kk)")],
    "no S phase": [("for (int i = 0; i < nsl; ++i) {",
                    "for (int i = 0; i < 0; ++i) {")],
    "no xdt loads and no y stores (compute only)": [
        (LOADS, "xr[t][0] = make_float4(1.f, 0.5f, 0.25f, 0.125f * kk);\n"
                "        xr[t][1] = make_float4(1.f, 0.5f, 0.25f, 0.1f * c4);"),
        (STORE, STORE.replace("n < Gm::NT8", "n < Gm::NT8 && N < 0"))],
    "one tensor-core product instead of three": [
        ("  mma(d, al, bh);\n  mma(d, ah, bl);\n", "")],
    "no exp (decay 1)": [(EXP, "r = c;")],
}


def build(source: str, out: str) -> ctypes.CDLL:
    path = out[:-3] + ".cu"
    with open(path, "w") as f:
        f.write(source)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, path],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    lib.ssd_chunk_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.ssd_chunk_launch.restype = ctypes.c_int
    lib.ssd_chunk_error_string.argtypes = [ctypes.c_int]
    lib.ssd_chunk_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_variants: needs a CUDA card", file=sys.stderr)
        return 1
    base = (_build.CSRC / "ssd_chunk.cu").read_text()
    shape = chip_smoke.SSD_SHAPES[0]
    print(f"{chip_smoke.card()}; ssd_chunk (BC, C, N, H, P) = {shape}",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    args = chip_smoke.ssd_inputs(*shape, "model", gen)
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        for i, (name, subs) in enumerate(VARIANTS.items()):
            source = base
            for old, new in subs:
                if old not in source:
                    raise ValueError(f"{name}: {old!r} not in the source")
                source = source.replace(old, new)
            ops._LIB = build(source, os.path.join(tmp, f"libv{i}.so"))
            ms = [chip_smoke.cuda_ms(lambda: ops.ssd_intra(*args), reps=20)
                  for _ in range(2)]
            print(f"  {name}: ms={ms[0]:.4f} {ms[1]:.4f}", flush=True)
    ops._LIB = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
