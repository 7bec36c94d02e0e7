"""Tensor creation and manipulation ops (counterpart of
``paddle_tpu.layers.tensor``).

The JAX package's semantics, kept: ``reshape`` copies a dimension given
as 0 and infers one given as -1; ``flatten`` collapses [0, axis) and
[axis, rank) into two dims; ``split`` takes a count of equal parts or
section sizes with one -1; ``argsort`` is stable. Creation ops with no
input to take a device from put their tensor on the running program's
device (``device`` overrides it; outside a program the default is the
CUDA card). Random ops draw from the program's rng stream
(``next_rng_key``), or from a generator seeded with ``seed`` when it is
not 0; their numbers differ from the JAX package's (Philox or the CPU's
generator against threefry), their distributions do not.
``create_global_var`` and ``autoincreased_step_counter`` keep state
through ``create_variable``; the counter is int32, as the JAX package
stores it with x64 off.
"""

from __future__ import annotations

import builtins
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..core.dtypes import convert_dtype
from ..framework import current_device, next_rng_key


def cast(x, dtype):
    return x.to(convert_dtype(dtype))


def concat(inputs: Sequence[torch.Tensor], axis: int = 0, name=None):
    return torch.cat(list(inputs), dim=axis)


def split(x, num_or_sections: Union[int, List[int]], dim: int = -1, name=None):
    """split_op analog. ``num_or_sections`` int → equal parts; list →
    section sizes (−1 allowed for one inferred section)."""
    total = x.shape[dim]
    if isinstance(num_or_sections, int):
        if total % num_or_sections:
            raise ValueError(f"split: {total} is not divisible into "
                             f"{num_or_sections} equal parts")
        return list(torch.split(x, total // num_or_sections, dim=dim))
    sections = list(num_or_sections)
    if -1 in sections:
        known = builtins.sum(s for s in sections if s != -1)
        sections[sections.index(-1)] = total - known
    return list(torch.split(x, sections, dim=dim))


def reshape(x, shape: Sequence[int], name=None):
    """reshape_op analog supporting 0 (copy dim) and -1 (infer)."""
    return torch.reshape(x, [x.shape[i] if s == 0 else s for i, s in enumerate(shape)])


def transpose(x, perm: Sequence[int], name=None):
    return x.permute(*perm)


def squeeze(x, axes: Optional[Sequence[int]] = None, name=None):
    return torch.squeeze(x, dim=tuple(axes)) if axes else torch.squeeze(x)


def unsqueeze(x, axes: Sequence[int], name=None):
    for a in sorted(axes):
        x = torch.unsqueeze(x, a)
    return x


def stack(inputs, axis: int = 0, name=None):
    return torch.stack(list(inputs), dim=axis)


def unstack(x, axis: int = 0, num=None, name=None):
    return list(torch.unbind(x, dim=axis))


def expand(x, expand_times: Sequence[int], name=None):
    return torch.tile(x, tuple(expand_times))


def expand_as(x, target, name=None):
    return torch.broadcast_to(x, target.shape)


def tile(x, reps, name=None):
    return torch.tile(x, tuple(reps))


def slice(x, axes: Sequence[int], starts: Sequence[int], ends: Sequence[int], name=None):
    """slice_op analog with per-axis starts/ends (negative ok)."""
    idx = [builtins.slice(None)] * x.dim()
    for a, s, e in zip(axes, starts, ends):
        idx[a] = builtins.slice(s, e)
    return x[tuple(idx)]


def gather(x, index, axis: int = 0, name=None):
    """``jnp.take`` along ``axis``: the output has ``index``'s shape in
    place of that axis; a negative index counts from the end."""
    index = torch.as_tensor(index, device=x.device).long()
    index = torch.where(index < 0, index + x.shape[axis], index)
    axis = axis % x.dim()
    out = torch.index_select(x, axis, index.reshape(-1))
    return out.reshape(x.shape[:axis] + index.shape + x.shape[axis + 1:])


def gather_nd(x, index, name=None):
    return x[tuple(torch.movedim(index.long(), -1, 0))]


def scatter(x, index, updates, overwrite: bool = True, name=None):
    """scatter_op analog (1-D index over rows)."""
    return x.index_put((index.long(),), updates, accumulate=not overwrite)


def scatter_nd_add(x, index, updates, name=None):
    return x.index_put(tuple(torch.movedim(index.long(), -1, 0)), updates,
                       accumulate=True)


def fill_constant(shape, dtype, value, name=None, device=None):
    return torch.full(tuple(shape), value, dtype=convert_dtype(dtype),
                      device=current_device(device))


def fill_constant_batch_size_like(input, shape, dtype, value, input_dim_idx=0,
                                  output_dim_idx=0, name=None):
    shape = list(shape)
    shape[output_dim_idx] = input.shape[input_dim_idx]
    return torch.full(shape, value, dtype=convert_dtype(dtype), device=input.device)


def zeros(shape, dtype="float32", name=None, device=None):
    return torch.zeros(tuple(shape), dtype=convert_dtype(dtype), device=current_device(device))


def ones(shape, dtype="float32", name=None, device=None):
    return torch.ones(tuple(shape), dtype=convert_dtype(dtype), device=current_device(device))


def zeros_like(x, name=None):
    return torch.zeros_like(x)


def ones_like(x, name=None):
    return torch.ones_like(x)


def assign(x, name=None, device=None):
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=current_device(device))


def arange(start, end=None, step=1, dtype="int64", name=None, device=None):
    if end is None:
        start, end = 0, start
    return torch.arange(start, end, step, dtype=convert_dtype(dtype),
                        device=current_device(device))


def range(start, end, step, dtype, name=None, device=None):
    return torch.arange(start, end, step, dtype=convert_dtype(dtype),
                        device=current_device(device))


def linspace(start, stop, num, dtype="float32", name=None, device=None):
    return torch.linspace(start, stop, num, dtype=convert_dtype(dtype),
                          device=current_device(device))


def _generator(seed, device):
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    return next_rng_key()


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0, name=None,
                   device=None):
    device = current_device(device)
    x = torch.empty(tuple(shape), dtype=convert_dtype(dtype), device=device)
    return x.uniform_(min, max, generator=_generator(seed, device))


def gaussian_random(shape, mean=0.0, std=1.0, dtype="float32", seed=0, name=None,
                    device=None):
    device = current_device(device)
    x = torch.empty(tuple(shape), dtype=convert_dtype(dtype), device=device)
    return x.normal_(mean, std, generator=_generator(seed, device))


def uniform_random_batch_size_like(input, shape, dtype="float32", input_dim_idx=0,
                                   output_dim_idx=0, min=-1.0, max=1.0, seed=0, name=None):
    shape = list(shape)
    shape[output_dim_idx] = input.shape[input_dim_idx]
    return uniform_random(shape, dtype, min, max, seed, device=input.device)


def shape(x, name=None):
    return torch.tensor(tuple(x.shape), dtype=torch.int64, device=x.device)


def argmax(x, axis=-1, name=None):
    return torch.argmax(x, dim=axis)


def argmin(x, axis=-1, name=None):
    return torch.argmin(x, dim=axis)


def argsort(x, axis=-1, descending=False, name=None):
    idx = torch.argsort(-x if descending else x, dim=axis, stable=True)
    return torch.take_along_dim(x, idx, dim=axis), idx


def where(condition, name=None):
    """where_index_op analog: indices of nonzero elements."""
    return torch.argwhere(condition)


def cond_select(condition, x, y):
    return torch.where(condition, x, y)


def is_empty(x, name=None):
    return torch.tensor(x.numel() == 0, device=x.device)


def has_nan(x, name=None):
    return torch.any(torch.isnan(x))


def has_inf(x, name=None):
    return torch.any(torch.isinf(x))


def isfinite(x, name=None):
    return torch.all(torch.isfinite(x))


def increment(x, value=1.0, name=None):
    return x + value


def cumsum(x, axis=None, name=None):
    return torch.cumsum(x.reshape(-1) if axis is None else x, dim=0 if axis is None else axis)


def not_equal(x, y, name=None):
    return torch.ne(x, y)


def equal(x, y, name=None):
    return torch.eq(x, y)


def less_than(x, y, name=None):
    return torch.lt(x, y)


def less_equal(x, y, name=None):
    return torch.le(x, y)


def greater_than(x, y, name=None):
    return torch.gt(x, y)


def greater_equal(x, y, name=None):
    return torch.ge(x, y)


def logical_and(x, y, name=None):
    return torch.logical_and(x, y)


def logical_or(x, y, name=None):
    return torch.logical_or(x, y)


def logical_not(x, name=None):
    return torch.logical_not(x)


def logical_xor(x, y, name=None):
    return torch.logical_xor(x, y)


def reverse(x, axis, name=None):
    return torch.flip(x, dims=tuple(axis) if isinstance(axis, (list, tuple)) else (axis,))


def flatten(x, axis: int = 1, name=None):
    """flatten_op analog: collapse dims [0,axis) and [axis,rank)."""
    lead = int(np.prod(x.shape[:axis])) if axis > 0 else 1
    return torch.reshape(x, (lead, -1))


def create_tensor(dtype="float32", name=None, persistable: bool = False, device=None):
    """create_tensor analog: a one-element placeholder; use
    create_global_var for persistable state."""
    return torch.zeros((1,), dtype=convert_dtype(dtype), device=current_device(device))


def create_global_var(shape, value, dtype="float32", persistable: bool = False,
                      force_cpu: bool = False, name=None):
    """create_global_var analog: a named persistable state variable
    initialised to ``value`` (it lives in the program's state)."""
    from ..framework import LayerHelper
    from .. import initializer as init

    helper = LayerHelper("global_var", name=name)
    return helper.create_variable("value", tuple(shape), convert_dtype(dtype),
                                  initializer=init.Constant(float(value)))


def sums(input, out=None, name=None):
    """sum_op over a list of tensors (layers/tensor.py sums)."""
    total = input[0]
    for x in input[1:]:
        total = total + x
    if out is not None:
        total = total + out * 0  # the reference accumulates into out's slot
    return total


def autoincreased_step_counter(counter_name=None, begin: int = 1, step: int = 1):
    """@LR_DECAY_COUNTER@ analog: a persistable int32 counter incremented
    once per apply(). Returns the pre-increment value + step."""
    from ..framework import LayerHelper
    from .. import initializer as init

    helper = LayerHelper("step_counter", name=counter_name or "step_counter")
    cnt = helper.create_variable("value", (1,), torch.int32,
                                 initializer=init.Constant(begin - step))
    new = cnt + step
    helper.assign_variable("value", new)
    return new


def _sum_layer(x):
    """sum_op: elementwise sum of a list of same-shaped tensors; a single
    tensor is returned as it is. Exported as ``layers.sum``."""
    if isinstance(x, (list, tuple)):
        total = torch.as_tensor(x[0])
        for t in x[1:]:
            total = total + t
        return total
    return torch.as_tensor(x)


__all__ = [
    "arange", "argmax", "argmin", "argsort", "assign", "autoincreased_step_counter",
    "cast", "concat", "cond_select", "create_global_var", "create_tensor", "cumsum",
    "equal", "expand", "expand_as", "fill_constant", "fill_constant_batch_size_like",
    "flatten", "gather", "gather_nd", "gaussian_random", "greater_equal",
    "greater_than", "has_inf", "has_nan", "increment", "is_empty", "isfinite",
    "less_equal", "less_than", "linspace", "logical_and", "logical_not",
    "logical_or", "logical_xor", "not_equal", "ones", "ones_like", "range",
    "reshape", "reverse", "scatter", "scatter_nd_add", "shape", "slice", "split",
    "squeeze", "stack", "sums", "tile", "transpose", "uniform_random",
    "uniform_random_batch_size_like", "unsqueeze", "unstack", "where", "zeros",
    "zeros_like",
]
