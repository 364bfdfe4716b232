"""Scheduler core: the RELMAS actor and critic, the heuristic baselines,
the serving tick, and DDPG training (replay, learner, rollouts, rounds)."""
