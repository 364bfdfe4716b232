"""Quickstart of the PyTorch port: the paper's pipeline in ~60 lines.

1. Characterize DNN models on the heterogeneous MAS (registration phase)
2. Build the multi-tenant scheduling environment
3. Compare an untrained RELMAS policy with the heuristic baselines
4. Run a few DDPG updates on collected experience

Run on the card: PYTHONPATH=src python examples/torch_quickstart.py
on the CPU:      ... examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core import baselines as BL
from repro_torch.core import ddpg as D
from repro_torch.core import policy as P
from repro_torch.core.replay import ReplayBuffer
from repro_torch.core.rollout import (make_baseline_period, make_policy_period,
                                      run_episode)
from repro_torch.costmodel.fleets import get_fleet
from repro_torch.kernels.lstm_cell import ops as cell_ops
from repro_torch.sim.arrivals import ArrivalConfig
from repro_torch.sim.env import EnvConfig, SchedulingEnv
from repro_torch.workloads import build_registry


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    dev = ap.parse_args(argv).device

    # 1. registration phase: characterize the tenants on an accelerator
    #    fleet (paper Sec. 3).  Fleets are named presets: swap "paper6"
    #    for "8simba", "big_little", ... (repro_torch.costmodel.fleets)
    #    and the whole stack below re-shapes to the new platform.
    fleet = get_fleet("paper6")
    print("fleet:", fleet.describe())
    registry = build_registry("light", mas=fleet)  # SqueezeNet, YOLO-Lite, KWS
    print("tenants:", registry.model_names)

    # 2. environment: the heterogeneous MAS + Pareto arrivals (Sec. 5)
    ecfg = EnvConfig(periods=16, max_rq=32, max_jobs=16)
    env = SchedulingEnv(registry, ecfg,
                        ArrivalConfig(max_jobs=16, horizon_us=ecfg.horizon_us,
                                      slack_us=2 * ecfg.t_s_us), device=dev)

    # 3. baselines vs a freshly initialized RELMAS policy
    for name, fn in BL.BASELINES.items():
        m, _ = run_episode(env, make_baseline_period(env, fn),
                           np.random.default_rng(0))
        print(f"{name:>8s}: SLA satisfaction {m['sla_rate']:.3f}")

    pcfg = P.PolicyConfig(feat_dim=env.feat_dim, act_dim=env.act_dim,
                          hidden=32)
    dcfg = D.DDPGConfig(policy=pcfg)
    state = D.init_ddpg(torch.Generator().manual_seed(0), dcfg, dev)
    cell_ops.LAUNCHES = 0
    period = make_policy_period(env, pcfg)
    m, trans = run_episode(env, period, np.random.default_rng(0),
                           params=state.actor,
                           gen=torch.Generator(device=dev).manual_seed(1),
                           sigma=0.3, collect=True)
    print(f"  relmas: SLA satisfaction {m['sla_rate']:.3f} (untrained)")

    # 4. a few DDPG updates from the replay buffer (Sec. 4.2)
    buf = ReplayBuffer(256, env.seq_len, env.feat_dim, env.act_dim)
    for t in trans:
        buf.add(t["s"], t["mask"], t["a"], t["r"], t["s2"], t["mask2"])
    for _ in range(10):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in buf.sample(16).items()}
        state, info = D.ddpg_update(state, dcfg, batch)
    print(f"after 10 updates: critic_loss={float(info['critic_loss']):.4f} "
          f"q_mean={float(info['q_mean']):.3f}")
    # the actor's and critic's recurrences ran through the hand-written
    # lstm_cell kernel on the card (its plain version on the CPU)
    print(f"lstm_cell launches: {cell_ops.LAUNCHES}")
    print("see repro_torch/launch/rl_train.py for the full training driver")


if __name__ == "__main__":
    main()
