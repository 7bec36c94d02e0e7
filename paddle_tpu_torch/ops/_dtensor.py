"""How the port's custom autograd Functions and hand-written kernels meet
DTensors (the mesh's tensors, ``parallel``): a Function that takes a
DTensor runs on the local shards at placements its math allows, and is
wrapped back as a DTensor; a kernel launch that is handed a DTensor
raises. Nothing turns a DTensor into a local tensor silently.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.errors import EnforceError


def is_dtensor(x) -> bool:
    return hasattr(x, "to_local") and hasattr(x, "placements")


def refuse(what: str, *tensors) -> None:
    """Raise if a DTensor reaches a kernel launch."""
    if any(is_dtensor(t) for t in tensors):
        raise EnforceError(f"{what}: a DTensor reached the kernel launch; the caller "
                           "must pass this rank's local shards (ops/_dtensor.py)")


def is_shard(pl) -> bool:
    """Whether a placement shards its tensor (a ``Shard`` or strided shard)."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    return isinstance(pl, (Shard, _StridedShard))


def kept_placements(x, dims: Sequence[int]):
    """``x``'s placements with a ``Shard`` of one of ``dims`` kept and every
    other mesh dim (a shard of another dim, a ``Partial``) replicated."""
    from torch.distributed.tensor import Replicate, Shard

    return [pl if isinstance(pl, Shard) and pl.dim in dims else Replicate()
            for pl in x.placements]


def local_at(x, like, placements, grad_placements=None):
    """The local shard of ``x`` redistributed to ``placements`` (on
    ``like``'s mesh; a plain tensor is taken as replicated), through the
    differentiable ``to_local``. ``grad_placements`` is what the local
    grad stands for (default: ``placements``); a replicated input that
    meets rows sharded over a mesh dim has a grad that is a ``Partial``
    sum there (:func:`partial_where_sharded`). None stays None."""
    if x is None:
        return None
    from torch.distributed.tensor import DTensor, Replicate

    if not is_dtensor(x):
        x = DTensor.from_local(x, like.device_mesh, [Replicate()] * like.device_mesh.ndim,
                               run_check=False)
    if tuple(x.placements) != tuple(placements):
        x = x.redistribute(placements=placements)
    return x.to_local(grad_placements=grad_placements)


def partial_where_sharded(rows):
    """``Partial()`` on each mesh dim where ``rows`` is a ``Shard``,
    ``Replicate()`` elsewhere: the grad of a replicated operand that met
    those rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    return [Partial() if isinstance(pl, Shard) else Replicate() for pl in rows]


def wrap(t: torch.Tensor, like, placements):
    """A local result as the DTensor of ``placements`` on ``like``'s mesh."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, like.device_mesh, placements, run_check=False)


def batch_placements(x):
    """``x``'s batch shard (a ``Shard`` of dim 0) kept, every other mesh dim
    replicated: the placements of a tensor that follows ``x``'s rows."""
    from torch.distributed.tensor import Replicate, Shard

    return [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
            for pl in x.placements]


def rowwise(fn, x, *operands):
    """``fn(x, *operands)`` for an op whose rows (dim 0) are independent (a
    convolution, a pooling): on a DTensor ``x`` it runs on the local rows,
    the operands (weights) gathered whole with their grads a ``Partial``
    sum over the ranks that hold other rows, and the result comes back as a
    DTensor of ``x``'s rows. DTensor's own convolution rule is tensor
    parallelism's and cannot take a batch shard in its backward."""
    if not is_dtensor(x):
        return fn(x, *operands)
    rows = batch_placements(x)
    whole = kept_placements(x, ())
    part = partial_where_sharded(rows)
    out = fn(local_at(x, x, rows), *(local_at(o, x, whole, part) for o in operands))
    return wrap(out, x, rows)


__all__ = ["batch_placements", "is_dtensor", "kept_placements", "local_at",
           "partial_where_sharded", "refuse", "rowwise", "wrap"]
