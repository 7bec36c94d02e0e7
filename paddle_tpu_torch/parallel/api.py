"""Glue between the Trainer and the mesh (counterpart of
``paddle_tpu.parallel.api``).

The JAX package places the scope with ``NamedSharding``s and lets XLA's
SPMD partitioner insert the collectives into one jitted step. Here every
rank is a process of its own: :func:`shard_scope` turns the scope's
tensors into DTensors placed by the rule table, :func:`put_batch` makes
each feed a DTensor sharded over the data axes, and the step runs eagerly
on them: DTensor's propagation inserts the collectives (a param's grad
comes back ``Partial`` and is reduced to the param's placements), which
is what :func:`jit_sharded_step` stands for.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .sharding import PartitionSpec, ShardingRules, placements, replicated


def _rules(rules: Optional[ShardingRules], mesh=None) -> ShardingRules:
    """The table, replicated() by default, adapted to ``mesh`` (api.py:21)."""
    rules = rules if rules is not None else replicated()
    return rules.adapted_to(mesh) if mesh is not None else rules


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicate(mesh, t: torch.Tensor):
    """``t`` (the same full tensor on every rank) as a replicated DTensor."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, mesh.device_mesh, [Replicate()] * len(mesh.axis_names),
                              run_check=False)


def shard_scope(mesh, rules: Optional[ShardingRules], params, state, opt_state):
    """Params, state and optimizer state as DTensors on ``mesh`` by the rule
    table (api.py:35, the BCastParamsToDevices analog): each param by its
    spec, the state replicated, each optimizer accumulator of its param's
    shape by its param's spec (co-located with its param shard, as the
    reference's pserver kept them) and everything else replicated. Every
    rank passes the same full tensors."""
    from torch.distributed.tensor import distribute_tensor

    rules = _rules(rules, mesh)
    sharded = rules.shard_params(mesh, params)
    state = {k: replicate(mesh, v) for k, v in state.items()}

    def place_opt(os):
        out: Dict[str, Any] = {}
        for key, sub in os.items():
            if key != "accums":
                out[key] = _replicate_tree(mesh, sub)
        accums = {}
        for pname, acc in os.get("accums", {}).items():
            pl = placements(rules.spec_for(pname, tuple(params[pname].shape), mesh), mesh)
            accums[pname] = {k: (distribute_tensor(v, mesh.device_mesh, pl)
                                 if tuple(v.shape) == tuple(params[pname].shape)
                                 else _replicate_tree(mesh, v))
                             for k, v in acc.items()}
        out["accums"] = accums
        return out

    return sharded, state, place_opt(opt_state) if opt_state is not None else None


def _replicate_tree(mesh, tree):
    if isinstance(tree, dict):
        return {k: _replicate_tree(mesh, v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and not is_dtensor(tree):
        return replicate(mesh, tree)
    return tree


def put_batch(mesh, rules: Optional[ShardingRules], feed: Dict[str, Any],
              stacked: bool = False, global_batch: bool = False, metrics=None):
    """Each feed as a DTensor sharded over the data axes (api.py:64, the
    DataFeeder.feed_parallel analog), on this rank's device.

    The JAX package's multi-process contract holds (api.py:64-68): each
    rank passes its LOCAL slice of the batch dim (and the full extent of
    every other dim), and the DTensor's global batch is the local one
    times the ranks its batch axes span. ``global_batch=True`` takes the
    other form: every rank passes the same WHOLE batch and keeps its own
    slice (rank coordinate ``c`` over the batch axes keeps rows
    ``[c·b/n, (c+1)·b/n)``), which is how ``Trainer.step`` reads a feed, so
    a reader that yields the same batches on every rank drives the mesh
    as it drives one device. A dim 1 sharded over a ``seq_axis`` is sliced
    the same way. A feed that already is a DTensor is used as it is.

    ``stacked=True``: a ``{name: (K, batch, ...)}`` super-batch; the
    steps axis is replicated and the batch sharding applies from dim 1.
    ``metrics`` (``PipelineMetrics``) records the host bytes put."""
    import time as _time
    from torch.distributed.tensor import DTensor

    rules = _rules(rules, mesh)
    out = {}
    t0 = _time.perf_counter()
    host_bytes = 0
    if metrics is not None:
        from ..data.feeder import host_feed_nbytes
        host_bytes = host_feed_nbytes(feed)
    for k, v in feed.items():
        if is_dtensor(v):
            out[k] = v
            continue
        t = _as_tensor(v)
        off = 1 if stacked else 0
        spec = rules.batch_spec(mesh, t.dim() - off, shape=tuple(t.shape[off:]))
        spec = PartitionSpec(*([None] * off + list(spec)))
        if global_batch:
            t = _local_slice(t, spec, mesh)
        t = t.to(mesh.device, non_blocking=True)
        out[k] = DTensor.from_local(t, mesh.device_mesh, placements(spec, mesh),
                                    run_check=False)
    if metrics is not None and host_bytes:
        metrics.record_h2d(host_bytes, _time.perf_counter() - t0)
    return out


def _as_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        from ..framework import params_from_jax
        return params_from_jax({"v": a}, device="cpu")["v"]
    return torch.from_numpy(np.ascontiguousarray(a))


def _local_slice(t: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """This rank's block of a whole tensor under ``spec``."""
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = int(np.prod([mesh.shape[a] for a in axes]))
        if t.shape[i] % n:
            raise ValueError(f"put_batch: dim {i} of a feed of shape {tuple(t.shape)} does "
                             f"not split over mesh axes {axes} ({n} ranks)")
        size = t.shape[i] // n
        c = mesh.axes_coord(axes)
        t = t.narrow(i, c * size, size)
    return t


def jit_sharded_step(mesh, rules: Optional[ShardingRules], fn, donate_argnums=(),
                     scope=None):
    """``jit_sharded_step`` (api.py:153): the step as it is. Its inputs are
    already DTensors (:func:`shard_scope`, :func:`put_batch`), so running
    ``fn`` eagerly propagates the placements and inserts the collectives;
    there is nothing to compile."""
    return fn


__all__ = ["is_dtensor", "jit_sharded_step", "put_batch", "replicate", "shard_scope"]
