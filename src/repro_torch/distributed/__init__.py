"""Distributed runtime: sharding rules over a mesh of named axes, their
DTensor placements, ZeRO optimizer-state sharding
(:func:`repro_torch.optim.opt_state_specs`), pipeline parallelism over
task-graph channels (:mod:`.pipeline`) and int8 gradient compression
with error feedback (:mod:`.compress`)."""

from .compress import (compress_grads, compressed_psum, compression_error,
                       dequantize_int8, ef_compressed_mean, init_error_state,
                       quantize_int8)
from .pipeline import (PipelineConfig, compile_pipeline, pipeline_apply,
                       pipeline_loss_fn, schedule_task_graph,
                       shard_stage_params, spmd_pipeline, stack_stage_params)
from .sharding import (AbstractMesh, ShardingPolicy, Spec, batch_spec,
                       cache_specs, logical_axis_rules, param_specs,
                       placements)

__all__ = ["param_specs", "batch_spec", "cache_specs",
           "logical_axis_rules", "ShardingPolicy", "Spec", "AbstractMesh",
           "placements", "quantize_int8", "dequantize_int8",
           "init_error_state", "compress_grads", "ef_compressed_mean",
           "compressed_psum", "compression_error", "PipelineConfig",
           "schedule_task_graph", "spmd_pipeline", "compile_pipeline",
           "pipeline_apply", "pipeline_loss_fn", "stack_stage_params",
           "shard_stage_params"]
