"""Parallelism (counterpart of ``paddle_tpu.parallel``): so far the
:class:`DistStrategy` knobs. Meshes, sharding and the collectives come
with the multi-GPU slice (ROADMAP queue 1, item 21)."""

from .strategy import DistStrategy, unported_fields

__all__ = ["DistStrategy", "unported_fields"]
