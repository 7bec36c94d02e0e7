"""Parallelism (counterpart of ``paddle_tpu.parallel``): meshes over the
ranks of a ``torch.distributed`` world, sharding rules as DTensor
placements, the :class:`DistStrategy` knobs, ZeRO, the quantized gradient
exchange, sequence parallelism through ring and Ulysses attention,
pipeline parallelism over stacked layers, and the mixture of experts with
expert parallelism.

The asynchronous parameter server comes later (ROADMAP queue 1, item
21 (e)); sharded checkpoints are ``io.save_sharded`` and its siblings."""

from . import api, mesh, quantized_collectives, ring_attention, sharding, strategy, ulysses
from . import moe, pipeline, zero
from .moe import moe_ep_rules
from .pipeline import bubble_fraction, interleave_perm, pipeline_apply
from .mesh import (DATA_AXES, DP, EP, FSDP, PP, SP, TP, AbstractMesh, DistributedInitError,
                   Mesh, data_axis_names, data_parallel_size, initialize, make_mesh)
from .quantized_collectives import quantized_pmean, quantized_psum
from .ring_attention import ring_attention as ring_attention_fn
from .sharding import (P, PartitionSpec, ShardingRules, ShardingRuleWarning, fsdp,
                       replicated, transformer_tp_rules)
from .strategy import DistStrategy, unported_fields
from .ulysses import ulysses_attention

__all__ = [
    "api", "mesh", "moe", "pipeline", "quantized_collectives", "ring_attention",
    "sharding", "strategy", "ulysses", "zero",
    "bubble_fraction", "interleave_perm", "moe_ep_rules", "pipeline_apply",
    "quantized_pmean", "quantized_psum", "ring_attention_fn", "ulysses_attention",
    "AbstractMesh", "DATA_AXES", "DP", "EP", "FSDP", "PP", "SP", "TP", "DistributedInitError",
    "Mesh", "data_axis_names", "data_parallel_size", "initialize", "make_mesh",
    "P", "PartitionSpec", "ShardingRules", "ShardingRuleWarning", "fsdp", "replicated",
    "transformer_tp_rules", "DistStrategy", "unported_fields",
]
