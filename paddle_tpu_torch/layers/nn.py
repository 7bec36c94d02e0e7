"""Neural-network layers (counterpart of ``paddle_tpu.layers.nn``): ``fc``,
``mean``, ``softmax``/``log_softmax``, ``softmax_with_cross_entropy`` and
``cross_entropy``, ``sigmoid_cross_entropy_with_logits``,
``square_error_cost``, ``cos_sim``, ``conv2d``, ``pool2d`` and ``batch_norm`` with
``to_chw_order``, ``embedding``, ``layer_norm``, ``matmul``, ``mul`` and
``dropout``.

``fc``, ``embedding`` and ``layer_norm`` create their parameters through
``LayerHelper`` inside a program, under the JAX package's names
(``fc_0/w``, ``fc_0/b``; ``w_0``, ``w_1`` ... for a list input;
``embedding_0/w``; ``layer_norm_0/scale``) and layouts ([in, out]
weights), and cast their matmul operands to the program's compute dtype.
GPT's module, which owns its params, uses the private forms
``_embedding_lookup`` and ``_layer_norm_given``.

The image layers take ``data_format=None`` as the program's layout
(:func:`framework.current_layout`: NCHW, or NHWC under ``layout_mode``).
An NHWC tensor is logically ``[b, H, W, C]``, as in the JAX package; it
reaches cuDNN as ``x.permute(0, 3, 1, 2)``, an NCHW-shaped view with
channels-last strides, and the result is permuted back, so no image is
copied into another layout. Conv weights are OIHW in both layouts.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from .. import initializer as init
from ..core.errors import enforce
from ..framework import (LayerHelper, cast_compute, compute_dtype, current_layout,
                         in_training, next_rng_key, seeded_generator)
from ..ops import _dtensor as _dt
from .. import quantize
from .ops import apply_activation

Int2 = Union[int, Sequence[int]]


def _pair(v: Int2) -> tuple:
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


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
        x2, w = cast_compute(cd, x2, w)
        y = (quantize.int8_dynamic_matmul(x2, w) if quantize.in_int8_serving()
             else torch.matmul(x2, w))
        out = y if out is None else out + y
    if bias_attr is not False:
        b = helper.create_parameter("b", shape=(size,), dtype=torch.float32,
                                    attr=bias_attr, initializer=init.Constant(0.0))
        out = out + b.to(out.dtype)
    return apply_activation(out, act)


# ---------------------------------------------------------------------------
# convolution, pooling and batch norm
# ---------------------------------------------------------------------------


def _to_nchw(x: torch.Tensor, data_format: str) -> torch.Tensor:
    # an NHWC tensor as an NCHW-shaped view (channels-last strides): no copy
    return x.permute(0, 3, 1, 2) if data_format == "NHWC" else x


def _from_nchw(x: torch.Tensor, data_format: str) -> torch.Tensor:
    return x.permute(0, 2, 3, 1) if data_format == "NHWC" else x


def conv2d(input, num_filters: int, filter_size: Int2, stride: Int2 = 1,
           padding: Int2 = 0, dilation: Int2 = 1, groups: int = 1, param_attr=None,
           bias_attr=None, act: Optional[str] = None, data_format: Optional[str] = None,
           name: Optional[str] = None, use_cudnn: bool = True):
    """2-D convolution (layers/nn.py:174; conv_op.cc analog) through
    cuDNN (``F.conv2d``). The weight is OIHW ``[num_filters, in_c/groups,
    kh, kw]`` in both layouts, drawn from ``MSRA(uniform=False)``; the
    padding is symmetric. Operands are cast to the compute dtype and the
    output stays in it (cuDNN accumulates a bf16 conv in f32, as the TPU's
    MXU does). In NHWC the weight goes in as channels-last, cast and laid
    out in one copy, so cuDNN runs its NHWC kernels with no transpose of
    its own. ``use_cudnn`` is accepted and ignored."""
    data_format = current_layout(data_format)
    helper = LayerHelper("conv2d", name=name)
    fs, st, pd, dl = _pair(filter_size), _pair(stride), _pair(padding), _pair(dilation)
    in_c = input.shape[1 if data_format == "NCHW" else 3]
    enforce(in_c % groups == 0, "input channels %d not divisible by groups %d", in_c, groups)
    w = helper.create_parameter("w", shape=(num_filters, in_c // groups, fs[0], fs[1]),
                                dtype=torch.float32, attr=param_attr,
                                initializer=init.MSRA(uniform=False))
    cd = compute_dtype()
    if quantize.in_int8_serving():
        # the JAX layer's int8 route: the filter as its conv sees it (OIHW,
        # or HWIO in NHWC), symmetric padding, the bias added after
        x, w = cast_compute(cd, input, w)
        dn = ("NCHW", "OIHW", "NCHW") if data_format == "NCHW" else ("NHWC", "HWIO", "NHWC")
        out = quantize.int8_dynamic_conv(
            x, w if data_format == "NCHW" else w.permute(2, 3, 1, 0), window_strides=st,
            padding=[(pd[0], pd[0]), (pd[1], pd[1])], rhs_dilation=dl,
            dimension_numbers=dn, feature_group_count=groups)
        return _conv_bias_act(helper, out, num_filters, bias_attr, act, data_format)
    x = _to_nchw(cast_compute(cd, input), data_format)
    if data_format == "NHWC":
        # one copy that casts and lays out; an OIHW weight made cuDNN copy
        # each weight again, 33 copies more on a ResNet-50 step (PERF.md, PR 7)
        w = w.to(cd, memory_format=torch.channels_last)
    else:
        w = cast_compute(cd, w)
    out = _from_nchw(_dt.rowwise(lambda a, b: F.conv2d(a, b, stride=st, padding=pd,
                                                        dilation=dl, groups=groups), x, w),
                     data_format)
    return _conv_bias_act(helper, out, num_filters, bias_attr, act, data_format)


def _conv_bias_act(helper, out, num_filters, bias_attr, act, data_format):
    if bias_attr is not False:
        b = helper.create_parameter("b", shape=(num_filters,), dtype=torch.float32,
                                    attr=bias_attr, initializer=init.Constant(0.0))
        bshape = (1, num_filters, 1, 1) if data_format == "NCHW" else (1, 1, 1, num_filters)
        out = out + b.to(out.dtype).reshape(bshape)
    return apply_activation(out, act)


def pool2d(input, pool_size: Int2 = 2, pool_type: str = "max", pool_stride: Int2 = 1,
           pool_padding: Int2 = 0, global_pooling: bool = False, ceil_mode: bool = False,
           exclusive: bool = True, data_format: Optional[str] = None, name=None,
           use_cudnn: bool = True):
    """2-D max or average pooling (layers/nn.py:323; pool_op.cc analog),
    with the JAX package's windows:

    - ``ceil_mode`` pads on the right by ``pad + (out_ceil − out_floor)·
      stride``, so every window that starts inside the padded input is
      kept; PyTorch's ``ceil_mode`` drops a window that starts in the
      right padding, so that case pads by hand and pools unpadded;
    - max pads with −inf; an average divides by the count of unpadded
      cells when ``exclusive`` and the input is padded, else by the whole
      window;
    - ``global_pooling`` takes the whole image as one window.

    Where a max window ties, the gradient goes to the first maximal cell
    in row-major order, as JAX's ``select_and_scatter`` routes it."""
    data_format = current_layout(data_format)
    enforce(pool_type in ("max", "avg"), f"pool_type must be 'max' or 'avg', got {pool_type}")
    x = _to_nchw(input, data_format)
    if global_pooling:
        ps, st, pd = tuple(x.shape[2:]), tuple(x.shape[2:]), (0, 0)
    else:
        ps, st, pd = _pair(pool_size), _pair(pool_stride), _pair(pool_padding)
    hi = list(pd)
    if ceil_mode:
        for i in range(2):
            span = x.shape[2 + i] + 2 * pd[i] - ps[i]
            hi[i] = pd[i] + (-(-span // st[i]) - span // st[i]) * st[i]
    padded = any(pd) or hi != list(pd)
    pads = (pd[1], hi[1], pd[0], hi[0])

    def pool(x):
        if hi == list(pd) and all(2 * p <= k for p, k in zip(pd, ps)):
            # PyTorch's own symmetric padding gives the same windows
            if pool_type == "max":
                return F.max_pool2d(x, ps, st, pd)
            return F.avg_pool2d(x, ps, st, pd, count_include_pad=not (exclusive and padded))
        if pool_type == "max":
            return F.max_pool2d(F.pad(x, pads, value=float("-inf")), ps, st)
        total = F.avg_pool2d(F.pad(x, pads), ps, st, divisor_override=1)
        if exclusive and padded:
            count = F.avg_pool2d(F.pad(torch.ones_like(x[:1, :1]), pads), ps, st,
                                 divisor_override=1)
            return total / count
        return total / math.prod(ps)

    return _from_nchw(_dt.rowwise(pool, x), data_format)


def batch_norm(input, act: Optional[str] = None, is_test: Optional[bool] = None,
               momentum: float = 0.9, epsilon: float = 1e-5, param_attr=None,
               bias_attr=None, data_layout: Optional[str] = None, name: Optional[str] = None,
               moving_mean_name=None, moving_variance_name=None,
               use_global_stats: bool = False):
    """Batch normalization (layers/nn.py:394; batch_norm_op analog), the
    JAX package's formula written out (not ``F.batch_norm``, whose running
    update weighs the batch by the momentum and takes the unbiased
    variance):

    - in training, the batch statistics in f32: ``E[x]`` and
      ``E[x²] − E[x]²`` clamped at 0; the moving stats (f32 program state,
      no grad) become ``momentum·old + (1 − momentum)·batch`` with that
      biased variance;
    - otherwise (``is_test``, or ``is_test=None`` outside training, or
      ``use_global_stats``) the moving stats;
    - the output ``x·inv + shift``, with ``inv`` and ``shift`` cast to
      x's dtype (two roundings under bf16), then ``act``.

    ``scale`` and ``bias`` are created in x's dtype (bf16 params under
    amp). The backward is autograd through this formula."""
    data_layout = current_layout(data_layout)
    helper = LayerHelper("batch_norm", name=name)
    c_axis = 1 if data_layout == "NCHW" else input.dim() - 1
    c = input.shape[c_axis]
    red_axes = tuple(a for a in range(input.dim()) if a != c_axis)
    bshape = [1] * input.dim()
    bshape[c_axis] = c
    scale = helper.create_parameter("scale", (c,), input.dtype, attr=param_attr,
                                    initializer=init.Constant(1.0))
    bias = helper.create_parameter("bias", (c,), input.dtype, attr=bias_attr,
                                   initializer=init.Constant(0.0))
    moving_mean = helper.create_variable("moving_mean", (c,), torch.float32,
                                         initializer=init.Constant(0.0))
    moving_var = helper.create_variable("moving_variance", (c,), torch.float32,
                                        initializer=init.Constant(1.0))
    training = in_training() if is_test is None else not is_test
    if training and not use_global_stats:
        x32 = input.float()
        mean = x32.mean(dim=red_axes)
        var = (x32.square().mean(dim=red_axes) - mean.square()).clamp_min(0.0)
        with torch.no_grad():
            helper.assign_variable("moving_mean",
                                   momentum * moving_mean + (1 - momentum) * mean)
            helper.assign_variable("moving_variance",
                                   momentum * moving_var + (1 - momentum) * var)
    else:
        mean, var = moving_mean, moving_var
    inv = torch.rsqrt(var + epsilon) * scale.float()
    shift = bias.float() - mean * inv
    out = input * inv.reshape(bshape).to(input.dtype) + shift.reshape(bshape).to(input.dtype)
    return apply_activation(out, act)


def to_chw_order(x):
    """The feature order at a conv → fc boundary: under NHWC an image
    tensor goes back to [b, C, H, W], so a flatten and fc see the C, H, W
    order that NCHW weights expect; identity otherwise."""
    if current_layout() == "NHWC" and x.dim() == 4:
        return x.permute(0, 3, 1, 2)
    return x


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with the JAX gather's index rule: a negative id
    counts from the end, then ids are clamped into range (an out-of-range
    id must not fault the device)."""
    n = table.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)
    from ..ops import _dtensor as D
    if D.is_dtensor(ids) and (not D.is_dtensor(table) or not any(
            D.is_shard(pl) for pl in table.placements)):
        # a replicated table at a mesh's ids: this rank's rows gathered from
        # its local copy, the table's grad a Partial sum over the mesh dims
        # the ids are sharded on (torch 2.11's DTensor cannot propagate the
        # sharding of this gather's index_put backward)
        from torch.distributed.tensor import Replicate
        local = D.local_at(table, ids, [Replicate()] * ids.device_mesh.ndim,
                           grad_placements=D.partial_where_sharded(ids.placements))
        return D.wrap(local[ids.to_local()], ids, list(ids.placements))
    return table[ids]


def _embedding_lookup(ids: torch.Tensor, table: torch.Tensor,
                      compute_dtype) -> torch.Tensor:
    """The rows of ``table`` [vocab, dim] at ``ids``, cast to the compute
    dtype, with ``jnp.take``'s index rule: a negative id counts from the
    end, and an id outside [-vocab, vocab) gives a row of NaN (its "fill"
    mode; the generator's ``table[ids]`` clamps instead, see
    :func:`take_rows`). The lookup of :func:`embedding`, and GPT's, whose
    module owns its table."""
    n = table.shape[0]
    ids = ids.long()
    rows = take_rows(table, ids)
    inside = ((ids >= -n) & (ids < n))[..., None]
    rows = torch.where(inside, rows, torch.full((), float("nan"), dtype=rows.dtype,
                                                device=rows.device))
    return cast_compute(compute_dtype, rows)


def embedding(input, size: Sequence[int], is_sparse: bool = False,
              is_distributed: bool = False, padding_idx: Optional[int] = None,
              param_attr=None, dtype="float32", name: Optional[str] = None):
    """Embedding lookup (layers/nn.py:93; lookup_table_op): a ``[vocab,
    dim]`` table ``w`` created in ``dtype`` (Xavier unless ``param_attr``
    says otherwise), read with :func:`_embedding_lookup`'s index rule and
    cast to the compute dtype. ``padding_idx`` (negative: counted from the
    end) zeroes its rows by a mask. An id input with a trailing dim of 1
    loses it, as in the JAX package.

    ``is_sparse`` and ``is_distributed`` are markers, as in the JAX
    package: ``is_distributed`` is recorded in the table's ``ParamInfo``
    (the row-sharded placement a mesh would give it), and the lookup and
    its gradient stay dense either way. The row-wise sparse gradient and
    updates are :mod:`paddle_tpu_torch.sparse`'s functions, which the
    ``Trainer`` does not take, as the JAX Trainer does not."""
    helper = LayerHelper("embedding", name=name)
    vocab, dim = int(size[0]), int(size[1])
    table = helper.create_parameter("w", shape=(vocab, dim), dtype=dtype, attr=param_attr,
                                    is_distributed=is_distributed)
    ids = input.long()
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    out = _embedding_lookup(ids, table, compute_dtype())
    if padding_idx is not None:
        pad = vocab + padding_idx if padding_idx < 0 else padding_idx
        out = out * (ids != pad)[..., None].to(out.dtype)
    return out


def matmul(x, y, transpose_x: bool = False, transpose_y: bool = False,
           alpha: float = 1.0, name=None):
    """matmul_op analog with batched broadcasting; mixed dtypes promote,
    as ``jnp.matmul`` does."""
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    dt = torch.promote_types(x.dtype, y.dtype)
    out = torch.matmul(x.to(dt), y.to(dt))
    if alpha != 1.0:
        out = out * alpha
    return out


def mul(x, y, x_num_col_dims: int = 1, y_num_col_dims: int = 1, name=None):
    """mul_op analog: x flattened to 2-D at ``x_num_col_dims``, y at
    ``y_num_col_dims``; the product takes x's leading and y's trailing
    dims."""
    xs = (math.prod(x.shape[:x_num_col_dims]), math.prod(x.shape[x_num_col_dims:]))
    ys = (math.prod(y.shape[:y_num_col_dims]), math.prod(y.shape[y_num_col_dims:]))
    dt = torch.promote_types(x.dtype, y.dtype)
    out = torch.matmul(x.reshape(xs).to(dt), y.reshape(ys).to(dt))
    return out.reshape(*x.shape[:x_num_col_dims], *y.shape[y_num_col_dims:])


def _normalize(x: torch.Tensor, dims, epsilon: float) -> torch.Tensor:
    """(x − mean)·rsqrt(var + eps) over ``dims``, in f32."""
    x32 = x.float()
    mean = x32.mean(dim=dims, keepdim=True)
    var = x32.var(dim=dims, keepdim=True, unbiased=False)
    return (x32 - mean) * torch.rsqrt(var + epsilon)


def layer_norm(input, scale: bool = True, shift: bool = True, begin_norm_axis: int = 1,
               epsilon: float = 1e-5, param_attr=None, bias_attr=None,
               act: Optional[str] = None, name: Optional[str] = None):
    """Layer normalization over dims [begin_norm_axis, rank)
    (layers/nn.py:455; layer_norm_op): the statistics and the affine map
    in f32, the output in the input's dtype, then ``act``. ``scale`` (ones)
    and ``bias`` (zeros), each of the normalised dims' shape, are created
    in the input's dtype, as the JAX layer creates them."""
    helper = LayerHelper("layer_norm", name=name)
    dims = tuple(range(begin_norm_axis, input.dim()))
    nshape = tuple(input.shape[a] for a in dims)
    out = _normalize(input, dims, epsilon)
    if scale:
        g = helper.create_parameter("scale", nshape, input.dtype, attr=param_attr,
                                    initializer=init.Constant(1.0))
        out = out * g.float()
    if shift:
        b = helper.create_parameter("bias", nshape, input.dtype, attr=bias_attr,
                                    initializer=init.Constant(0.0))
        out = out + b.float()
    return apply_activation(out.to(input.dtype), act)


def _layer_norm_given(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      begin_norm_axis: int = 1, epsilon: float = 1e-5) -> torch.Tensor:
    """:func:`layer_norm`'s arithmetic with ``scale`` and ``bias`` given by
    the caller (GPT's module owns them)."""
    out = _normalize(x, tuple(range(begin_norm_axis, x.dim())), epsilon)
    return (out * scale.float() + bias.float()).to(x.dtype)


def _scalar_like(x: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a 0-d tensor in x's dtype on x's device: the JAX
    package's weakly typed Python scalar, which is rounded to x's dtype
    before the op (``torch`` would apply it in f32 to a bf16 tensor)."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def dropout(x, dropout_prob: float, is_test: Optional[bool] = None,
            seed: Optional[int] = None,
            dropout_implementation: str = "downgrade_in_infer", name=None):
    """dropout_op analog (layers/nn.py:547). In training (``is_test``
    given, else :func:`framework.in_training`) each element is kept with
    probability ``1 − p`` and zeroed otherwise; ``upscale_in_train``
    divides the kept ones by ``1 − p`` (a division by ``1 − p`` rounded to
    x's dtype, so bf16 rounds as in the JAX package). At inference ``downgrade_in_infer`` (the default)
    returns ``x·(1 − p)`` and ``upscale_in_train`` returns x.

    The mask is ``torch.rand(x.shape) < 1 − p`` drawn from a generator on
    x's device: seeded with ``seed`` when given
    (:func:`framework.seeded_generator`), else the running program's
    stream (:func:`framework.next_rng_key`), so the same program rng and
    step give the same masks, a captured step replays them, and a
    recomputed :func:`framework.maybe_remat` block draws its forward's.
    The JAX package draws threefry bits, so the masks agree in their
    statistics only."""
    training = in_training() if is_test is None else not is_test
    if dropout_prob == 0.0:
        return x
    if not training:
        if dropout_implementation == "downgrade_in_infer":
            return x * _scalar_like(x, 1.0 - dropout_prob)
        return x
    g = seeded_generator(seed, x.device) if seed is not None else next_rng_key()
    keep = torch.rand(x.shape, generator=g, device=x.device) < 1.0 - dropout_prob
    out = torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))
    if dropout_implementation == "upscale_in_train":
        out = out / _scalar_like(out, 1.0 - dropout_prob)
    return out


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


def square_error_cost(input, label):
    """(input − label)² elementwise (layers/nn.py:621)."""
    return torch.square(input - label)


def sigmoid_cross_entropy_with_logits(x, label, ignore_index: int = -100, name=None):
    """The logistic loss of logits ``x`` against ``label`` (layers/nn.py:640),
    in its stable form ``max(x, 0) − x·label + log1p(exp(−|x|))``; 0 where
    ``label == ignore_index``."""
    # at x == 0 the grads are jnp's: maximum splits its grad in halves, and
    # |x| has the slope 1 (torch.abs has 0 there)
    neg_abs = torch.where(x >= 0, -x, x)
    loss = torch.maximum(x, torch.zeros_like(x)) - x * label + torch.log1p(torch.exp(neg_abs))
    return torch.where(label == ignore_index, torch.zeros_like(loss), loss)


def cos_sim(x, y, name=None):
    """Cosine similarity over the last dim, kept as a dim of 1
    (layers/nn.py:687): ``Σxy / max(‖x‖·‖y‖, 1e-12)``. The clamp is on the
    product of the norms, not on each norm as ``F.cosine_similarity``
    clamps, so a zero vector gives 0."""
    xn = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True))
    return torch.sum(x * y, dim=-1, keepdim=True) / torch.clamp_min(xn * yn, 1e-12)


__all__ = ["batch_norm", "conv2d", "cos_sim", "cross_entropy", "dropout", "embedding", "fc",
           "layer_norm", "log_softmax", "matmul", "mean", "mul", "pool2d",
           "sigmoid_cross_entropy_with_logits", "softmax", "softmax_with_cross_entropy",
           "square_error_cost", "take_rows", "to_chw_order"]
