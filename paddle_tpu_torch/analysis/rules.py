"""Lint rules (counterpart of ``paddle_tpu.analysis.rules``): the one rule
that reads a trainer's state rather than its traced step,
:func:`check_replicated_optstate`. The rules over the traced program come
with ROADMAP queue 1, item 25."""

from __future__ import annotations

import numpy as np

from .report import LintReport


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _itemsize(v) -> int:
    return v.element_size() if hasattr(v, "element_size") else np.dtype(v.dtype).itemsize


def check_replicated_optstate(params, opt_state, mesh, rules,
                              report: LintReport,
                              replicated_optstate_bytes: int = 64 << 20,
                              zero_sharding: bool = False) -> None:
    """``sharding:replicated-optstate`` (rules.py:885): per-parameter
    optimizer accumulators (Adam's moments ...) of which every rank along
    a data-parallel axis holds a full copy, more than
    ``replicated_optstate_bytes`` a rank in all.

    An accumulator takes its parameter's placement
    (``parallel.api.shard_scope``) and the data axes shard only the batch,
    so under plain dp the whole optimizer state is replicated N ways: the
    redundancy that ZeRO's sharded update removes. With
    ``zero_sharding=True`` (``DistStrategy.zero_sharding``, the update
    already sharded) the trigger is quiet and the info finding
    ``sharding:zero-active`` reports the bytes a rank holds, from each
    leaf's local shard (a DTensor's ``to_local()``). ``mesh`` is read
    through its axis names and sizes only."""
    if mesh is None or opt_state is None or not params:
        return
    from ..parallel import mesh as mesh_lib

    data_axes = tuple(a for a in mesh_lib.data_axis_names(mesh)
                      if mesh.shape[a] > 1)
    data_n = mesh_lib.data_parallel_size(mesh)
    if data_n <= 1:
        return
    if zero_sharding:
        per_dev = 0
        leaves = 0
        for v in _leaves(opt_state):
            local = tuple(v.to_local().shape) if hasattr(v, "to_local") else tuple(v.shape)
            per_dev += int(np.prod(local or (1,))) * _itemsize(v)
            leaves += 1
        axes_desc = "x".join(f"{a}={mesh.shape[a]}" for a in data_axes)
        report.add(
            "sharding:zero-active", "info",
            f"ZeRO weight-update sharding is on: optimizer state is "
            f"partitioned 1/{data_n} across the data axis ({axes_desc}) "
            f"— {per_dev / 1e6:.1f} MB/device realized across "
            f"{leaves} leaves",
            where="opt_state",
            opt_state_bytes_per_device=int(per_dev),
            data_shards=data_n, leaves=leaves)
        return
    from ..parallel.api import _rules as _adapt
    table = _adapt(rules, mesh)
    data_axis_set = set(data_axes)
    repl_bytes = 0.0   # bytes a rank holds that the data axes replicate
    saved_bytes = 0.0  # what a 1/data_n ZeRO shard would reclaim
    leaves = 0
    for pname, acc in (opt_state.get("accums") or {}).items():
        if pname not in params:
            continue
        pshape = tuple(params[pname].shape)
        spec = table.spec_for(pname, pshape, mesh)
        spec_axes = [a for e in spec if e is not None
                     for a in (e if isinstance(e, tuple) else (e,))
                     if a in mesh.axis_names]
        sharded_n = int(np.prod([mesh.shape[a] for a in spec_axes] or [1]))
        sharded_data_n = int(np.prod([mesh.shape[a] for a in spec_axes
                                      if a in data_axis_set] or [1]))
        for v in _leaves(acc):
            shape = tuple(v.shape)
            nbytes = int(np.prod(shape or (1,))) * _itemsize(v)
            # only leaves of the param's shape take its placement; scalars
            # and step counters are replicated
            inherit = shape == pshape
            per_dev = nbytes / (sharded_n if inherit else 1)
            # the redundancy left across the data axes after the spec's
            # own data-axis sharding (an fsdp rule carries none there)
            repl = data_n // (sharded_data_n if inherit else 1)
            if repl <= 1:
                continue
            repl_bytes += per_dev
            saved_bytes += per_dev * (repl - 1) / repl
            leaves += 1
    if leaves == 0 or repl_bytes < replicated_optstate_bytes:
        return
    axes_desc = "x".join(f"{a}={mesh.shape[a]}" for a in data_axes)
    report.add(
        "sharding:replicated-optstate", "warning",
        f"{repl_bytes / 1e6:.1f} MB/device of optimizer state "
        f"({leaves} accumulator tensors) is replicated across the "
        f"{data_n}-way data axis ({axes_desc}) — a ZeRO-style "
        f"cross-replica sharded update (each replica owns a 1/{data_n} "
        f"shard of opt state and the update, params all-gathered once "
        f"per step) reclaims {saved_bytes / 1e6:.1f} MB/device of HBM",
        where="opt_state",
        replicated_bytes_per_device=int(repl_bytes),
        zero_saving_bytes=int(saved_bytes),
        data_shards=data_n, leaves=leaves)


__all__ = ["check_replicated_optstate"]
