"""Control-flow ops (counterpart of ``paddle_tpu.layers.control_flow``;
the reference's control_flow.py While:655, IfElse:1412, Switch:1286,
StaticRNN:429, DynamicRNN:1542).

The JAX package lowers them to ``lax.while_loop``/``cond``/``switch``.
Here they run eagerly, and a tensor predicate is never read on the host
behind the caller's back:

- :func:`cond`, :func:`case`, :func:`switch_case`, :class:`Switch` and
  :class:`IfElse` run every branch and select the result on the device
  (``torch.where``), as the JAX package's cond does under ``vmap``; the
  branches must be free of side effects and give results of one
  structure. A Python bool predicate runs only its branch.
- :func:`while_loop` must read its predicate on the host at every
  iteration: it does so outside a CUDA graph capture, and raises
  :class:`HostReadUnderCapture` inside one (a host read breaks the
  capture). A Python bool predicate is read as it is.
- :func:`Print` prints on the host, and raises under capture likewise.

``StaticRNN``/``DynamicRNN`` run :func:`rnn.rnn`.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence

import torch

from ..core.dtypes import convert_dtype
from ..core.errors import EnforceError
from ..framework import current_device


class HostReadUnderCapture(EnforceError):
    """A control-flow op needed a tensor's value on the host while a CUDA
    graph was being captured."""


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _host_bool(pred, what: str) -> bool:
    if not isinstance(pred, torch.Tensor):
        return bool(pred)
    if _capturing():
        raise HostReadUnderCapture(
            f"{what} reads its predicate on the host, which a CUDA graph capture "
            "cannot do; run it outside run_steps, or use cond/case, which select "
            "on the device")
    return bool(pred)


def _tree_select(mask, a, b):
    """``torch.where(mask, a, b)`` over two trees of one structure; ``mask``
    broadcasts from the left (a row mask [b] selects rows)."""
    if isinstance(a, dict):
        return {k: _tree_select(mask, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_tree_select(mask, x, y) for x, y in zip(a, b))
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    trailing = (1,) * (max(a.dim(), b.dim()) - mask.dim())
    return torch.where(mask.to(a.device).reshape(tuple(mask.shape) + trailing), a, b)


def while_loop(cond_fn: Callable, body_fn: Callable, loop_vars: Any):
    """While analog (control_flow.py:655 / while_op.cc): ``loop_vars`` is a
    nest of tensors; ``cond_fn`` gives a bool scalar, read on the host each
    iteration (:class:`HostReadUnderCapture` under a capture)."""
    while _host_bool(cond_fn(loop_vars), "while_loop"):
        loop_vars = body_fn(loop_vars)
    return loop_vars


def cond(pred, true_fn: Callable, false_fn: Callable, *operands):
    """conditional_block/IfElse analog: a tensor ``pred`` runs both
    branches and selects on the device; a Python bool runs its branch."""
    if not isinstance(pred, torch.Tensor):
        return true_fn(*operands) if pred else false_fn(*operands)
    return _tree_select(pred.reshape(()).bool(), true_fn(*operands), false_fn(*operands))


def _select_branch(idx, fns: Sequence[Callable]):
    """The result of ``fns[idx]`` for a 0-d int tensor ``idx`` in range:
    every branch runs, the results selected on the device."""
    results = [fn() for fn in fns]
    out = results[-1]
    for i in range(len(results) - 2, -1, -1):
        out = _tree_select(idx == i, results[i], out)
    return out


def case(pred_fn_pairs: Sequence, default: Callable = None):
    """layers.case analog: the first true predicate's branch, else
    ``default`` (without one, the first branch)."""
    preds = [torch.as_tensor(p, dtype=torch.bool) for p, _ in pred_fn_pairs]
    fns = [f for _, f in pred_fn_pairs]
    if default is not None:
        fns = fns + [default]
    stacked = torch.stack([p.reshape(()) for p in preds])
    first = torch.argmax(stacked.to(torch.int32))
    fallback = len(preds) if default is not None else 0
    return _select_branch(torch.where(stacked.any(), first, fallback), fns)


def switch_case(branch_index, branch_fns: Sequence[Callable], default: Callable = None):
    """switch/case analog (control_flow.py Switch:1286): an index out of
    range takes ``default``, or without one is clamped into range."""
    fns = list(branch_fns)
    idx = torch.as_tensor(branch_index).reshape(())
    if default is not None:
        n = len(fns)
        return _select_branch(torch.where((idx >= 0) & (idx < n), idx, n), fns + [default])
    return _select_branch(torch.clamp(idx, 0, len(fns) - 1), fns)


def Print(x, message: str = "", summarize: int = 20, name=None):
    """The in-graph Print op analog (control_flow.py:146): prints on the
    host and returns ``x``."""
    if _capturing():
        raise HostReadUnderCapture("Print reads its tensor on the host, which a CUDA "
                                   "graph capture cannot do")
    print(message, x)
    return x


def _row(arr, i) -> torch.Tensor:
    """[1] int64: row ``i`` of ``arr`` as lax's dynamic index takes it, a
    negative index counted from the end, then clamped into range."""
    n = arr.shape[0]
    i = torch.as_tensor(i, device=arr.device).reshape(1).long()
    return torch.clamp(torch.where(i < 0, i + n, i), 0, n - 1)


def array_write(arr, i, x):
    """LoDTensorArray write analog on a preallocated [cap, ...] buffer: a
    new buffer with row ``i`` set to ``x``."""
    return arr.index_copy(0, _row(arr, i), x.to(arr.dtype)[None])


def array_read(arr, i):
    """Row ``i`` of the buffer."""
    return arr.index_select(0, _row(arr, i))[0]


def create_array(capacity: int, element_shape, dtype=torch.float32, device=None):
    """A [capacity, *element_shape] zero buffer on ``device`` (the running
    program's device, else the card)."""
    return torch.zeros((capacity,) + tuple(element_shape), dtype=convert_dtype(dtype),
                       device=current_device(device))


def increment(x, value=1, in_place=None):
    return x + value


def less_than(x, y, force_cpu=None):
    return torch.lt(torch.as_tensor(x), torch.as_tensor(y))


def array_length(arr):
    return torch.tensor(arr.shape[0], dtype=torch.int32, device=arr.device)


class While:
    """Class-form While (control_flow.py While:655) over
    :func:`while_loop`: ``While(cond_fn)(body_fn, loop_vars)``."""

    def __init__(self, cond_fn: Callable, name=None):
        self.cond_fn = cond_fn

    def __call__(self, body_fn: Callable, loop_vars):
        return while_loop(self.cond_fn, body_fn, loop_vars)


class IfElse:
    """Row-wise IfElse (control_flow.py IfElse:1412): both branch functions
    run on the whole batch and each row takes its branch's result by the
    mask ``cond`` ([b] or [b, 1] bool). ``IfElse(cond)(true_fn, false_fn,
    x)``."""

    def __init__(self, cond, name=None):
        self.cond = torch.as_tensor(cond)

    def __call__(self, true_fn: Callable, false_fn: Callable, *operands):
        return _tree_select(self.cond.reshape(-1), true_fn(*operands), false_fn(*operands))


class Switch:
    """Scalar Switch (control_flow.py Switch:1286): ordered (predicate, fn)
    cases and a default; the first true case wins."""

    def __init__(self, name=None):
        self.cases: List = []
        self.default_fn: Callable = None

    def case(self, pred, fn: Callable):
        self.cases.append((pred, fn))
        return self

    def default(self, fn: Callable):
        self.default_fn = fn
        return self

    def __call__(self):
        return case(self.cases, self.default_fn)


class StaticRNN:
    """StaticRNN (control_flow.py:429): a fixed-length loop over time,
    ``StaticRNN()(cell_fn, inputs, init_state)`` with ``cell_fn(state,
    x_t) -> (new_state, out_t)`` and inputs [b, t, ...]."""

    def __init__(self, name=None):
        pass

    def __call__(self, cell_fn: Callable, inputs, init_state):
        from .rnn import rnn as _rnn
        return _rnn(cell_fn, inputs, init_state)


class DynamicRNN:
    """DynamicRNN (control_flow.py:1542): StaticRNN with per-row
    ``sequence_length`` masking in place of the reference's
    lod_rank_table/shrink_memory machinery."""

    def __init__(self, name=None):
        pass

    def __call__(self, cell_fn: Callable, inputs, init_state, sequence_length=None):
        from .rnn import rnn as _rnn
        return _rnn(cell_fn, inputs, init_state, sequence_length=sequence_length)


__all__ = ["DynamicRNN", "HostReadUnderCapture", "IfElse", "Print", "StaticRNN", "Switch",
           "While", "array_length", "array_read", "array_write", "case", "cond",
           "create_array", "increment", "less_than", "switch_case", "while_loop"]
