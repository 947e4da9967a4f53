"""Distributed runtime: sharding rules over a mesh of named axes, their
DTensor placements, and ZeRO optimizer-state sharding
(:func:`repro_torch.optim.opt_state_specs`)."""

from .sharding import (AbstractMesh, ShardingPolicy, Spec, batch_spec,
                       cache_specs, logical_axis_rules, param_specs,
                       placements)

__all__ = ["param_specs", "batch_spec", "cache_specs",
           "logical_axis_rules", "ShardingPolicy", "Spec", "AbstractMesh",
           "placements"]
