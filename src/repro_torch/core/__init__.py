"""Scheduler core: the RELMAS actor, the heuristic baselines and the
serving tick."""
