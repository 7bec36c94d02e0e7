"""Distributed/execution strategy (counterpart of
``paddle_tpu.parallel.strategy``; ExecutionStrategy/BuildStrategy and
DistributeTranspilerConfig analog): the knob surface as a dataclass, with
every field of the JAX package's, so configs written for it construct.

The port acts on the loss-scaling fields (``loss_scale``,
``dynamic_loss_scale``, ``loss_scale_growth_interval``), on
rematerialization (``remat``, ``remat_policy``), on gradient
accumulation (``accum_steps``), on the optimizer state's storage dtype
(``opt_state_dtype``) and, under a mesh, on the gradient exchange
(``reduce_strategy``, ``accum_exchange``, ``quantized_allreduce``,
``quant_block_size``, ``error_feedback``, ``quant_stochastic_rounding``),
ZeRO (``zero_sharding``), sequence parallelism (``sequence_parallel``,
``sp_impl``) and pipeline parallelism (``pp_microbatches``,
``pp_interleave``). ``async_mode`` selects the asynchronous parameter
server: ``Trainer`` refuses it and points to
``parallel.AsyncPSTrainer``, as the JAX Trainer does. ``Trainer`` raises
:class:`NotYetPorted` for any other field set away from its default (the
program dump), naming the ROADMAP item that brings it
(:func:`unported_fields`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class DistStrategy:
    # microbatch gradient accumulation (multi_batch_merge_pass analog)
    accum_steps: int = 1
    # how accumulated gradients are exchanged: "gspmd" or "hoisted"
    accum_exchange: str = "gspmd"
    # 'allreduce' replicates params; 'sharded' (fsdp) shards them
    reduce_strategy: str = "allreduce"
    # donation and rematerialization (memory_optimize analog)
    donate_buffers: bool = True
    remat: bool = False
    remat_policy: Any = None
    # dtype of float optimizer accumulators; the update math stays f32
    opt_state_dtype: Optional[str] = None
    # loss scaling for mixed precision: a float enables scaling at that
    # initial value; dynamic_loss_scale grows/shrinks it from the overflow
    # history (a non-finite grad always skips the step when enabled)
    loss_scale: Optional[float] = None
    dynamic_loss_scale: bool = False
    loss_scale_growth_interval: int = 1000
    # debug dump of the compiled program (debug_graphviz_path analog)
    dump_hlo_path: Optional[str] = None
    # pipeline parallelism: microbatches and virtual stages per rank
    pp_microbatches: int = 0
    pp_interleave: int = 1
    # sequence/context parallelism over the mesh's 'sp' axis
    sequence_parallel: bool = False
    sp_impl: str = "ring"
    # quantized gradient exchange ("none", "int8", "int4") and its knobs
    quantized_allreduce: str = "none"
    quant_block_size: int = 256
    error_feedback: bool = True
    quant_stochastic_rounding: bool = False
    # ZeRO-style cross-replica sharded weight update
    zero_sharding: bool = False
    # asynchronous parameter-server mode
    async_mode: bool = False


# the fields the port acts on
PORTED_FIELDS = ("loss_scale", "dynamic_loss_scale", "loss_scale_growth_interval",
                 "remat", "remat_policy", "accum_steps", "opt_state_dtype",
                 "reduce_strategy", "accum_exchange", "zero_sharding",
                 "sequence_parallel", "sp_impl", "quantized_allreduce",
                 "quant_block_size", "error_feedback", "quant_stochastic_rounding",
                 "donate_buffers", "pp_microbatches", "pp_interleave", "async_mode")

# field -> the ROADMAP queue 1 item that brings it
_LATER = {
    "dump_hlo_path": "item 25 (the program's graph form)",
}


def unported_fields(strategy: DistStrategy) -> Dict[str, str]:
    """{field: the ROADMAP queue 1 item that brings it} for every field of
    ``strategy`` set away from its default, other than those the port
    acts on (:data:`PORTED_FIELDS`)."""
    out = {}
    for f in dataclasses.fields(DistStrategy):
        if f.name in PORTED_FIELDS or getattr(strategy, f.name) == f.default:
            continue
        out[f.name] = "ROADMAP queue 1, " + _LATER[f.name]
    return out


__all__ = ["DistStrategy", "PORTED_FIELDS", "unported_fields"]
