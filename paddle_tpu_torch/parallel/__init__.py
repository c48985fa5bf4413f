"""Hybrid-parallel building blocks (counterpart of ``paddle_tpu/parallel``;
reference: paddle/distributed/fleet/meta_parallel/*)."""
from .layers import (ColumnParallelLinear, RowParallelLinear,
                     VocabParallelEmbedding, parallel_matmul)
from .moe import MoEMLP, top_k_routing
from .pipeline import pipeline_apply, spmd_pipeline, stack_stage_params
from .ring import ring_attention, ring_flash_attention, ulysses_attention
from .sharding import (ShardingError, bind_static, constraint,
                       param_shardings, partition_to_sharding, shard_layer,
                       sharded_build, tree_shardings, validate_partition)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "parallel_matmul", "MoEMLP",
           "top_k_routing", "pipeline_apply", "spmd_pipeline",
           "stack_stage_params", "ring_attention", "ring_flash_attention",
           "ulysses_attention", "ShardingError", "bind_static", "constraint",
           "param_shardings", "partition_to_sharding", "shard_layer",
           "sharded_build", "tree_shardings", "validate_partition"]
