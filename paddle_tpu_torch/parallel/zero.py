"""ZeRO-style cross-replica sharded weight update (counterpart of
``paddle_tpu.parallel.zero``).

Every param and every optimizer accumulator of its param's shape is
flattened, zero-padded to a multiple of the data-shard count N and
reshaped to ``(N, k)``; data-parallel rank ``i`` owns row ``i`` (a DTensor
``Shard(0)`` over the data axes). The optimizer updates the rows only, so
its state takes 1/N of the memory. At the top of every step the rows are
gathered back to the params' logical shapes (:func:`combine_params`, one
``all_gather_into_tensor`` a param), and the step's grads are reduced
straight to rows (:func:`partition_grads`, one ``reduce_scatter_tensor`` a
param).

Pads start at 0 and stay 0: their grads are 0, every built-in optimizer
maps (p=0, g=0, acc=0) to 0, and weight decay multiplies 0, so global
norms (clipping, LARS) do not see them. Checkpoints hold one ``(k,)`` row
per leaf in a file per shard (``io.save_trainer``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, FrozenSet, Tuple

import numpy as np
import torch

PARAMS_NPZ = "params.npz"
OPT_NPZ = "opt_state.npz"
STATE_NPZ = "state.npz"


@dataclasses.dataclass(frozen=True)
class ZeroSpec:
    """One trainer's ZeRO layout (zero.py:50): the data axes and shard
    count, the LOGICAL flat spec per checkpoint collection (what a
    trainer without ZeRO would save; ``meta.zero.arrays``), the flat npz
    keys that are partitioned, and each param's logical shape and dtype."""

    axes: Tuple[str, ...]
    axes_dict: Dict[str, int]
    n: int
    arrays: Dict[str, Dict[str, Dict[str, Any]]]
    partitioned: Dict[str, FrozenSet[str]]
    shapes: Dict[str, Tuple[int, ...]]
    dtypes: Dict[str, Any]


def row_size(shape, n: int) -> int:
    """k: the padded row length of a logical ``shape`` at N shards."""
    size = int(np.prod(shape)) if len(shape) else 1
    return -(-size // n)


def partition_leaf(x: torch.Tensor, n: int) -> torch.Tensor:
    """A logical leaf → its (N, k) rows, zero-padded."""
    size = x.numel()
    k = -(-size // n)
    flat = x.reshape(-1)
    if n * k != size:
        flat = torch.nn.functional.pad(flat, (0, n * k - size))
    return flat.reshape(n, k)


def combine_leaf(x2: torch.Tensor, shape) -> torch.Tensor:
    """(N, k) rows → the logical leaf (padding dropped)."""
    size = int(np.prod(shape)) if len(shape) else 1
    return x2.reshape(-1)[:size].reshape(tuple(shape))


def _opt_partitioned_keys(opt_arrays: Dict[str, Dict[str, Any]],
                          shapes: Dict[str, Tuple[int, ...]]) -> FrozenSet[str]:
    """The flat opt_state keys that partition: accumulators of their
    param's logical shape (``step``, ``global`` and any other accumulator
    stay replicated)."""
    from ..io import SEP

    out = set()
    for key, ent in opt_arrays.items():
        parts = key.split(SEP)
        if len(parts) >= 3 and parts[0] == "accums":
            shape = shapes.get(parts[1])
            if shape is not None and tuple(ent["shape"]) == shape:
                out.add(key)
    return frozenset(out)


def make_spec(mesh, axes: Tuple[str, ...], params: Dict[str, Any], state: Any,
              opt_state: Any) -> ZeroSpec:
    """The ZeroSpec of LOGICAL (not yet partitioned) scope trees."""
    from ..io import flat_spec

    axes = tuple(axes)
    axes_dict = {a: int(mesh.shape[a]) for a in axes}
    n = int(np.prod(list(axes_dict.values())))
    shapes = {name: tuple(leaf.shape) for name, leaf in params.items()}
    dtypes = {name: leaf.dtype for name, leaf in params.items()}
    arrays = {PARAMS_NPZ: flat_spec(params), STATE_NPZ: flat_spec(state or {}),
              OPT_NPZ: flat_spec(opt_state) if opt_state is not None else {}}
    partitioned = {PARAMS_NPZ: frozenset(arrays[PARAMS_NPZ]), STATE_NPZ: frozenset(),
                   OPT_NPZ: _opt_partitioned_keys(arrays[OPT_NPZ], shapes)}
    return ZeroSpec(axes=axes, axes_dict=axes_dict, n=n, arrays=arrays,
                    partitioned=partitioned, shapes=shapes, dtypes=dtypes)


def row_placements(mesh, axes):
    """``Shard(0)`` on the data axes, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if a in axes else Replicate() for a in mesh.axis_names]


def _rows(mesh, spec: ZeroSpec, local_row: torch.Tensor):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local_row, mesh.device_mesh, row_placements(mesh, spec.axes),
                              run_check=False)


def _own_row(x: torch.Tensor, spec: ZeroSpec, mesh) -> torch.Tensor:
    """This rank's (1, k) row of a full logical tensor."""
    i = mesh.axes_coord(spec.axes)
    return partition_leaf(x.detach(), spec.n)[i:i + 1].clone()


# -- placement (Trainer.startup, checkpoint restore) --------------------------


def partition_params(params: Dict[str, torch.Tensor], spec: ZeroSpec,
                     mesh) -> Dict[str, Any]:
    """Full logical params (the same on every rank) → (N, k) row DTensors,
    each rank keeping its own row."""
    return {name: _rows(mesh, spec, _own_row(leaf, spec, mesh))
            for name, leaf in params.items()}


def partition_opt_state(opt_state: Any, spec: ZeroSpec, mesh) -> Any:
    """The accumulators of their param's shape → rows; everything else
    replicated (zero.py:133)."""
    from .api import replicate

    if opt_state is None:
        return None

    def walk(tree, shape):
        if isinstance(tree, dict):
            return {k: walk(v, shape) for k, v in tree.items()}
        if tree is None:
            return None
        if shape is not None and tuple(tree.shape) == shape:
            return _rows(mesh, spec, _own_row(tree, spec, mesh))
        return replicate(mesh, tree)

    out = {}
    for key, sub in opt_state.items():
        if key == "accums" and isinstance(sub, dict):
            out[key] = {pname: walk(acc, spec.shapes.get(pname)) for pname, acc in sub.items()}
        else:
            out[key] = walk(sub, None)
    return out


# -- in the step ------------------------------------------------------------------


def combine_params(pshards: Dict[str, Any], spec: ZeroSpec, mesh) -> Dict[str, Any]:
    """Rows → logical params as replicated DTensors: one
    ``all_gather_into_tensor`` a param over the data axes (the paper's
    top-of-step "fresh params" gather)."""
    import torch.distributed as dist
    from .api import replicate

    group = mesh.axes_group(spec.axes)
    out = {}
    for name, rows in pshards.items():
        local = rows.to_local() if hasattr(rows, "to_local") else rows
        full = torch.empty((spec.n,) + tuple(local.shape[1:]), dtype=local.dtype,
                           device=local.device)
        dist.all_gather_into_tensor(full, local.contiguous(), group=group)
        out[name] = replicate(mesh, combine_leaf(full, spec.shapes[name]))
    return out


def partition_grads(grads: Dict[str, Any], spec: ZeroSpec, mesh) -> Dict[str, Any]:
    """The step's grads (of the logical params, ``Partial`` over the data
    axes as the backward leaves them) → this rank's rows: one
    ``reduce_scatter_tensor`` a param. A grad that is already reduced
    (replicated) keeps its own row."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate

    group = mesh.axes_group(spec.axes)
    data_dims = [mesh.dim(a) for a in spec.axes]
    i = mesh.axes_coord(spec.axes)
    out = {}
    for name, g in grads.items():
        if isinstance(g, DTensor):
            pl = list(g.placements)
            partial = all(isinstance(pl[d], Partial) and pl[d].reduce_op == "sum"
                          for d in data_dims)
            want = [pl[d] if (partial and d in data_dims) else Replicate()
                    for d in range(len(pl))]
            if want != pl:
                g = g.redistribute(placements=want)
            local = g.to_local()
        else:
            partial, local = False, g
        flat = partition_leaf(local, spec.n)
        if partial:
            row = torch.empty((1, flat.shape[1]), dtype=flat.dtype, device=flat.device)
            dist.reduce_scatter_tensor(row, flat.contiguous(), group=group)
        else:
            row = flat[i:i + 1].clone()
        out[name] = _rows(mesh, spec, row)
    return out


def allgather_bytes_per_step(spec: ZeroSpec) -> int:
    """Bytes one rank sends in the top-of-step param all-gather: (N-1)
    row-sized hops a leaf a data axis of a ring all-gather."""
    total = 0
    for name, shape in spec.shapes.items():
        k = row_size(shape, spec.n)
        itemsize = torch.empty((), dtype=spec.dtypes[name]).element_size()
        for size in spec.axes_dict.values():
            total += (size - 1) * k * itemsize
    return int(total)


__all__ = ["ZeroSpec", "allgather_bytes_per_step", "combine_leaf", "combine_params",
           "make_spec", "partition_grads", "partition_leaf", "partition_opt_state",
           "partition_params", "row_placements", "row_size"]
