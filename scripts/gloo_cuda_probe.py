"""What gloo carries for CUDA tensors, and what DTensor does on a ``cuda``
``DeviceMesh`` over a gloo group, with ranks sharing one card.

    python scripts/gloo_cuda_probe.py [--ranks 2] [--mesh cuda|cpu] [--stage]

Spawns the ranks (``rl_train.spawn_ranks``, gloo) and runs, in order,
plain collectives on CUDA tensors (broadcast, all_reduce,
all_gather_into_tensor, the list all_gather, reduce_scatter_tensor,
all_to_all_single), the ``DeviceMesh`` of the given device type, then
DTensor redistributions (Shard -> Replicate, Partial -> Replicate,
Partial -> Shard, Replicate -> Shard) and a DTensor matmul with its
backward.  Each step prints ``rank r: <step> ok`` or its exception to
stderr before the next starts, and ``faulthandler`` prints the Python
stack of a rank that crashes, so the last line of a rank names the step
that killed it.  ``--stage`` first installs
``launch.mesh.stage_gloo_cuda_collectives`` (the functional collectives
on CUDA tensors through the host), as ``launch.mesh.make_mesh`` does
for a ``cuda`` mesh over gloo.  The last stdout line is a JSON object
with each step's outcome on rank 0.
"""
from __future__ import annotations

import argparse
import faulthandler
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch  # noqa: E402


def _steps(mesh_type: str):
    import torch.distributed as dist
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    dev = torch.device("cuda", torch.cuda.current_device())
    n, r = dist.get_world_size(), dist.get_rank()
    x = torch.arange(8, dtype=torch.float32, device=dev) + r
    yield "broadcast", lambda: dist.broadcast(x.clone(), 0)
    yield "all_reduce", lambda: dist.all_reduce(x.clone())
    yield "all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
        torch.empty(8 * n, device=dev), x)
    yield "all_gather_list", lambda: dist.all_gather(
        [torch.empty_like(x) for _ in range(n)], x)
    yield "reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
        torch.empty(8 // n, device=dev), x)
    yield "all_to_all_single", lambda: dist.all_to_all_single(
        torch.empty_like(x), x)
    from torch.distributed.device_mesh import DeviceMesh
    state = {}

    def mesh():
        state["mesh"] = DeviceMesh(mesh_type, torch.arange(n),
                                   mesh_dim_names=("model",))
    yield f"DeviceMesh({mesh_type})", mesh
    t = x if mesh_type == "cuda" else x.cpu()

    def redist(src, dst):
        d = DTensor.from_local(t.clone(), state["mesh"], [src],
                               run_check=False)
        return d.redistribute(state["mesh"], [dst]).to_local()
    yield "Shard->Replicate", lambda: redist(Shard(0), Replicate())
    yield "Partial->Replicate", lambda: redist(Partial(), Replicate())
    yield "Partial->Shard", lambda: redist(Partial(), Shard(0))
    yield "Replicate->Shard", lambda: redist(Replicate(), Shard(0))

    def matmul():
        m = state["mesh"]
        a = DTensor.from_local(torch.ones((4, 8), device=t.device), m,
                               [Replicate()], run_check=False)
        w = DTensor.from_local(torch.ones((8, 4), device=t.device), m,
                               [Shard(1)], run_check=False)
        w.requires_grad_()
        (a @ w).sum().backward()
        return w.grad.redistribute(m, [Replicate()]).to_local()
    yield "DTensor matmul + backward", matmul


def probe_rank(rank: int, relay, mesh_type: str, stage: bool) -> dict:
    faulthandler.enable(file=sys.stderr, all_threads=True)
    if stage:
        from repro_torch.launch.mesh import stage_gloo_cuda_collectives
        stage_gloo_cuda_collectives()
    out = {}
    for name, fn in _steps(mesh_type):
        print(f"rank {rank}: {name} ...", file=sys.stderr, flush=True)
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:          # report and go on to the next
            out[name] = f"{type(e).__name__}: {str(e)[:200]}"
        print(f"rank {rank}: {name} {out[name]}", file=sys.stderr,
              flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--mesh", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--stage", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no GPU", file=sys.stderr)
        return 1
    from repro_torch.launch import rl_train
    print(f"torch {torch.__version__}, {torch.cuda.get_device_name(0)}",
          flush=True)
    res = rl_train.spawn_ranks(probe_rank, args.ranks, args.mesh,
                               args.stage, device="cuda", backend="gloo",
                               timeout=300)
    print(json.dumps(res[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
