"""Neural-network layers (counterpart of ``paddle_tpu.layers.nn``): ``fc``,
``mean``, ``softmax``/``log_softmax``, ``softmax_with_cross_entropy`` and
``cross_entropy``, with ``embedding`` and ``layer_norm`` for GPT.

``fc`` creates its parameters through ``LayerHelper`` inside a program,
under the JAX package's names (``fc_0/w``, ``fc_0/b``; ``w_0``, ``w_1``
... for a list input) and layout ([in, out] weights), and casts its
operands to the program's compute dtype. ``embedding`` and ``layer_norm``
keep the GPT slice's form, the params passed in by the caller; their
``LayerHelper`` forms come with the Transformer/BERT slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import initializer as init
from ..framework import LayerHelper, cast_compute, compute_dtype
from .ops import apply_activation


def fc(input, size: int, num_flatten_dims: int = 1, param_attr=None, bias_attr=None,
       act: Optional[str] = None, name: Optional[str] = None):
    """Fully-connected layer (layers/nn.py:167 fc; mul_op + elementwise_add).

    Flattens trailing dims from ``num_flatten_dims`` on and multiplies by
    a [flattened_in, size] weight. A list of inputs gets one weight each
    and their products are summed; ``bias_attr=False`` drops the bias."""
    helper = LayerHelper("fc", name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    cd = compute_dtype()
    out = None
    for i, x in enumerate(inputs):
        in_features = math.prod(x.shape[num_flatten_dims:])
        lead_shape = x.shape[:num_flatten_dims]
        x2 = x.reshape(*lead_shape, in_features) if x.dim() != num_flatten_dims + 1 else x
        w = helper.create_parameter(f"w_{i}" if len(inputs) > 1 else "w",
                                    shape=(in_features, size), dtype=torch.float32,
                                    attr=param_attr)
        y = torch.matmul(*cast_compute(cd, x2, w))
        out = y if out is None else out + y
    if bias_attr is not False:
        b = helper.create_parameter("b", shape=(size,), dtype=torch.float32,
                                    attr=bias_attr, initializer=init.Constant(0.0))
        out = out + b.to(out.dtype)
    return apply_activation(out, act)


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with the JAX gather's index rule: a negative id
    counts from the end, then ids are clamped into range (an out-of-range
    id must not fault the device)."""
    n = table.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)
    return table[ids]


def embedding(ids: torch.Tensor, table: torch.Tensor,
              compute_dtype) -> torch.Tensor:
    """Embedding lookup (layers/nn.py:93): the rows of ``table`` [vocab,
    dim] at ``ids``, cast to the compute dtype, with ``jnp.take``'s index
    rule: a negative id counts from the end, and an id outside [-vocab,
    vocab) gives a row of NaN (its "fill" mode; the generator's
    ``table[ids]`` clamps instead, see :func:`take_rows`). Not carried
    yet: ``padding_idx`` and ``is_sparse`` (the DeepFM slice)."""
    n = table.shape[0]
    ids = ids.long()
    rows = take_rows(table, ids)
    inside = ((ids >= -n) & (ids < n))[..., None]
    rows = torch.where(inside, rows, torch.full((), float("nan"), dtype=rows.dtype,
                                                device=rows.device))
    return cast_compute(compute_dtype, rows)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               begin_norm_axis: int = 1, epsilon: float = 1e-5) -> torch.Tensor:
    """Layer normalization over dims [begin_norm_axis, rank)
    (layers/nn.py:455): statistics and the affine map in f32, the output
    in x's dtype. The JAX layer creates ``scale`` and ``bias`` in x's
    dtype; here the caller owns them."""
    dims = tuple(range(begin_norm_axis, x.dim()))
    x32 = x.float()
    mean = x32.mean(dim=dims, keepdim=True)
    var = x32.var(dim=dims, keepdim=True, unbiased=False)
    out = (x32 - mean) * torch.rsqrt(var + epsilon)
    return (out * scale.float() + bias.float()).to(x.dtype)


def softmax(input, axis: int = -1, name=None, use_cudnn: bool = False):
    return torch.softmax(input, dim=axis)


def log_softmax(input, axis: int = -1, name=None):
    return torch.log_softmax(input, dim=axis)


def _pick(values, lab, axis):
    """``values`` at the class ``lab`` along ``axis`` (kept as a size-1
    dim). Ids outside the classes (``ignore_index``) read class 0; the
    caller masks them."""
    safe = torch.where((lab >= 0) & (lab < values.shape[axis]), lab, 0)
    return torch.gather(values, axis, safe.unsqueeze(axis))


def _hard_labels(label, ndim, axis):
    lab = label.long()
    if lab.dim() == ndim and lab.shape[axis] == 1:
        lab = lab.squeeze(axis)
    return lab


def softmax_with_cross_entropy(logits, label, soft_label: bool = False,
                               ignore_index: int = -100, numeric_stable_mode: bool = True,
                               return_softmax: bool = False, axis: int = -1):
    """Fused softmax + cross-entropy (softmax_with_cross_entropy_op.cc
    analog): an f32 log-softmax; hard labels [N] or [N, 1] give losses
    [N, 1], 0 where the label is ``ignore_index``."""
    logp = torch.log_softmax(logits.float(), dim=axis)
    if soft_label:
        loss = -torch.sum(label.float() * logp, dim=axis, keepdim=True)
    else:
        lab = _hard_labels(label, logits.dim(), axis)
        valid = (lab != ignore_index).unsqueeze(axis)
        loss = torch.where(valid, -_pick(logp, lab, axis), 0.0)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


def cross_entropy(input, label, soft_label: bool = False, ignore_index: int = -100):
    """cross_entropy_op analog: ``input`` is probabilities."""
    eps = 1e-12
    if soft_label:
        return -torch.sum(label * torch.log(input + eps), dim=-1, keepdim=True)
    lab = _hard_labels(label, input.dim(), -1)
    valid = (lab != ignore_index).unsqueeze(-1)
    return torch.where(valid, -torch.log(_pick(input, lab, -1) + eps), 0.0)


def mean(x, name=None):
    return torch.mean(x if torch.is_floating_point(x) else x.float())


__all__ = ["cross_entropy", "embedding", "fc", "layer_norm", "log_softmax", "mean",
           "softmax", "softmax_with_cross_entropy", "take_rows"]
