"""Scheduler core: the RELMAS actor and critic, the heuristic and MAGMA
baselines, the deployment scheduler, the serving tick, DDPG training
(replay, learner, rollouts, rounds) and the fleet-conditioned
generalist (``repro_torch.core.generalist``)."""
from repro_torch.core.scheduler import RelmasScheduler

__all__ = ["RelmasScheduler"]
