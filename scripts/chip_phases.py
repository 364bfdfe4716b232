"""Run chosen training phases of ``chip_smoke.py`` on one GPU, each
timed, without the rest of the script.

    python scripts/chip_phases.py PHASE [PHASE ...]

PHASE is one of ``kernel:lstm_cell``, ``kernel:flash_attention``,
``kernel:decode_gqa``, ``kernel:ssd_chunk``, ``train:parity``,
``telemetry:train``, ``train:churn``, ``train:sharded``,
``train:sharded_ranks``, ``train:sharded_nccl`` (two or more cards),
``train:sharded_driver``, ``train:lm``, ``train:lm_families``,
``train:lm_mesh``, ``train:lm_mesh_nccl`` (four or more cards),
``train:families_mesh``, ``legacy:runners``, ``dryrun:production``
and ``dryrun:check`` (after ``train:lm`` to hold the memory to its
peak).  The five kernel libraries
are built first (one ``nvcc`` each, together).  Each phase prints what
``chip_smoke.py`` prints for it; the last line is a JSON object with
the card and each phase's seconds.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path[:0] = [os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"), os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    names = list(sys.argv[1:] if argv is None else argv)
    from repro_torch.kernels.decode_gqa import ops as dec_ops
    from repro_torch.kernels.decode_gqa import ref as dec_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.lstm_cell import ops as cell_ops
    from repro_torch.kernels.lstm_cell import ref as cell_ref
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    from repro_torch.kernels.ssd_chunk import ref as ssd_ref
    phases = {"kernel:lstm_cell": lambda c: cs.check_cell(cell_ops, cell_ref,
                                                          c),
              "kernel:flash_attention": lambda c: cs.check_flash(
                  fa_ops, fa_ref, c),
              "kernel:decode_gqa": lambda c: cs.check_decode(dec_ops,
                                                             dec_ref, c),
              "kernel:ssd_chunk": lambda c: cs.check_ssd(ssd_ops, ssd_ref,
                                                         c),
              "train:parity": cs.train_parity_phase,
              "telemetry:train": cs.telemetry_train_phase,
              "train:churn": cs.train_churn_phase,
              "train:sharded": cs.train_sharded_phase,
              "train:sharded_ranks": cs.train_sharded_ranks_phase,
              "train:sharded_nccl": cs.train_sharded_nccl_phase,
              "train:sharded_driver": cs.train_sharded_driver_phase,
              "train:lm": cs.train_lm_phase,
              "train:lm_families": cs.train_lm_families_phase,
              "train:lm_mesh": cs.train_lm_mesh_phase,
              "train:lm_mesh_nccl": cs.train_lm_mesh_nccl_phase,
              "train:families_mesh": cs.train_families_mesh_phase,
              "legacy:runners": cs.legacy_runners_phase,
              "dryrun:production": cs.dryrun_production_phase,
              "dryrun:check": cs.dryrun_check_phase}
    unknown = [n for n in names if n not in phases]
    if unknown or not names:
        print(f"unknown phases {unknown}; pick from {sorted(phases)}",
              file=sys.stderr)
        return 2
    if not cs.torch.cuda.is_available():
        print("chip_phases: no GPU", file=sys.stderr)
        return 1
    card = cs.card()
    cs.torch.backends.cuda.matmul.allow_tf32 = False
    cs.torch.backends.cudnn.allow_tf32 = False
    secs = {}
    with cs.phase("build"):
        t0 = time.perf_counter()
        cs.build_all(["lstm_seq", "flash_attention", "decode_gqa",
                      "ssd_chunk", "lstm_cell"])
        secs["build"] = time.perf_counter() - t0
    for name in names:
        with cs.phase(name):
            t0 = time.perf_counter()
            phases[name](card)
            secs[name] = time.perf_counter() - t0
    print(json.dumps({"card": card, "seconds": secs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
