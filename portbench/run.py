"""Run one benchmark cell once on the card and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  See ``portbench/README.md``.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _setup_env() -> None:
    """Import paths, and every build or kernel cache at a fixed place
    inside the checkout."""
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # one process, one compute thread: the program is paced by its host
    # thread, which an idle-spinning thread pool would compete with
    os.environ["OMP_NUM_THREADS"] = "1"
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


if __name__ == "__main__":
    _setup_env()
    from portbench.harness import main
    sys.exit(main(sys.argv[1:], T_START))
