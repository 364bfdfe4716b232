"""Multi-accelerator multi-tenant simulation platform (paper Sec. 5).

Event-driven executor with shared-memory-bandwidth contention, Pareto
arrival generation, and the periodic-scheduling environment, batched
over a leading stream axis.
"""
from repro_torch.sim.arrivals import ArrivalConfig, generate_trace
from repro_torch.sim.engine import (commit_period_np, simulate,
                                    simulate_np, simulate_segments)
from repro_torch.sim.env import EnvConfig, SchedulingEnv

__all__ = ["ArrivalConfig", "generate_trace", "simulate", "simulate_np",
           "simulate_segments", "commit_period_np", "EnvConfig",
           "SchedulingEnv"]
