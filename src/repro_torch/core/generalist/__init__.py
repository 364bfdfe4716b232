"""Fleet-conditioned generalist policy: ONE checkpoint for every fleet.

The specialist RELMAS nets bake the platform into their shapes
(``F = 4 + 2M``) and weights; this subpackage removes both couplings
(the JAX package's ``core/generalist``):

- ``repro_torch.costmodel.descriptors`` — normalized per-SA hardware
  descriptors;
- :mod:`.features` — the M-agnostic feature/action space: pad to
  ``M_max``, append descriptors to every slot row (and the primer),
  masked SA allocation and action channels;
- :mod:`.env` — :class:`PaddedEnv` (any fleet at width ``M_max`` with
  poisoned padding SAs) and stacked fleet tensors;
- :mod:`.rollout` — batched eval / collection runners, the per-period
  step, and the checkpoint loader;
- :mod:`.train` — multi-fleet training rounds: each round samples a
  fleet and trains through ``repro_torch.core.train``'s round, on one
  device or sharded over several.
"""
from repro_torch.core.generalist.env import (PAD_LAT_US, PaddedEnv,
                                             build_padded_envs,
                                             stack_fleet_tables)
from repro_torch.core.generalist.features import (GeneralistSpec,
                                                  action_channel_mask,
                                                  append_descriptors,
                                                  generalist_act_fn,
                                                  masked_allocation)
from repro_torch.core.generalist.rollout import (
    collect_generalist, evaluate_generalist_batch,
    load_generalist_checkpoint, make_generalist_evaluate_batch,
    make_generalist_period, restore_spec)
from repro_torch.core.generalist.train import (
    expand_batch, generalist_replay_init, generalist_round_draws,
    generalist_rounds_host, generalist_update_rounds,
    make_generalist_round, make_generalist_rounds,
    make_sharded_generalist_rounds, sharded_generalist_draws,
    sharded_generalist_rounds_reference)

__all__ = [
    "PAD_LAT_US", "PaddedEnv", "build_padded_envs", "stack_fleet_tables",
    "GeneralistSpec", "action_channel_mask", "append_descriptors",
    "generalist_act_fn", "masked_allocation",
    "collect_generalist", "evaluate_generalist_batch",
    "load_generalist_checkpoint",
    "make_generalist_evaluate_batch", "make_generalist_period",
    "restore_spec",
    "expand_batch", "generalist_replay_init", "generalist_round_draws",
    "generalist_rounds_host", "generalist_update_rounds",
    "make_generalist_round", "make_generalist_rounds",
    "make_sharded_generalist_rounds", "sharded_generalist_draws",
    "sharded_generalist_rounds_reference",
]
