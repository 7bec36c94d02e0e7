"""Quantization and low-precision inference (counterpart of
``paddle_tpu.quantize``).

- Fake quantization for quantization-aware training: :func:`fake_quant`
  (a straight-through estimator: the grad passes where ``|x/scale| <= 1``
  and none goes to the scale), :func:`fake_quant_abs_max` and
  :func:`quant_dequant_moving_avg`.
- Post-training weight quantization: :func:`quantize_params` (per output
  channel, symmetric) and :func:`dequantize_params`.
- Real int8 serving: under :func:`int8_serving` the ``fc`` and ``conv2d``
  layers run :func:`int8_dynamic_matmul` and :func:`int8_dynamic_conv`:
  activations quantized per tensor and weights per output channel on the
  fly (abs-max), an int8×int8→int32 product, then one f32 rescale. An
  inference artifact saved under the switch records it, and its loaded
  Predictor serves int8 with no switch set (``io``).
- :func:`cast_params_for_inference` (bf16 weights, paired with
  ``amp_guard`` for the compute) and :func:`fold_batch_norms`.

Every function keeps the JAX package's order of operations, so the int8
values, the int32 accumulators and the f32 results agree with it bit for
bit on the CPU.

The int8 products. On the card they run through ``torch._int_mm``
(cuBLASLt's int8 GEMM with int32 accumulation), which takes more than 16
rows and inner and output widths that are multiples of 8:
:func:`_padded_int_mm` pads with int8 zeros, which changes no
accumulator. A convolution is an im2col of the already quantized int8
activation (zero padding after the quantization, patches through a
strided view) followed by that product, one a group. On the CPU the same
int8 operands go through an int32 ``matmul``: the same accumulators.
Nothing falls back to a float product.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .core.dtypes import convert_dtype

Params = Dict[str, torch.Tensor]


# -- fake quantization (QAT, quantize_transpiler analog) ---------------------


class _FakeQuant(torch.autograd.Function):
    """``clip(round(x/scale·qmax), ±qmax)·scale/qmax`` forward; the
    straight-through mask ``|x/scale| <= 1`` on the grad backward, and no
    grad to ``scale`` (the JAX package's custom VJP returns None)."""

    @staticmethod
    def forward(ctx, x, scale, num_bits):
        qmax = 2.0 ** (num_bits - 1) - 1
        ctx.scale = None if isinstance(scale, torch.Tensor) else scale
        ctx.save_for_backward(x, *([scale] if ctx.scale is None else []))
        q = torch.clamp(torch.round(x / scale * qmax), -qmax, qmax)
        return q * scale / qmax

    @staticmethod
    def backward(ctx, g):
        x, *rest = ctx.saved_tensors
        scale = rest[0] if rest else ctx.scale
        mask = (torch.abs(x / scale) <= 1.0).to(g.dtype)
        return g * mask, None, None


def fake_quant(x: torch.Tensor, scale, num_bits: int = 8) -> torch.Tensor:
    """Quantize ``x`` to ``num_bits`` symmetric levels of ``scale`` and
    back; the grad passes straight through where ``x`` was not clipped."""
    return _FakeQuant.apply(x, scale, num_bits)


def fake_quant_abs_max(x: torch.Tensor, num_bits: int = 8) -> torch.Tensor:
    """fake_quantize_abs_max op analog: dynamic per-tensor scale."""
    scale = torch.clamp_min(torch.amax(torch.abs(x)), 1e-8)
    return fake_quant(x, scale, num_bits)


def quant_dequant_moving_avg(x: torch.Tensor, state_scale, decay: float = 0.9,
                             num_bits: int = 8):
    """fake_quantize_moving_average_abs_max analog; returns ``(out,
    new_scale)``: thread ``new_scale`` through the program state."""
    cur = torch.clamp_min(torch.amax(torch.abs(x)), 1e-8)
    new_scale = decay * state_scale + (1 - decay) * cur
    return fake_quant(x, new_scale, num_bits), new_scale


# -- post-training quantization (PTQ) ---------------------------------------


def quantize_params(params: Params, num_bits: int = 8,
                    predicate: Optional[Callable[[str, torch.Tensor], bool]] = None
                    ) -> Dict[str, Any]:
    """Per-output-channel symmetric quantization of weight matrices and
    filters: ``{name: {"q": int8 tensor, "scale": per-channel scales}}``
    for the selected params (default: names ending ``/w`` of rank 2 and
    up), the others passed through. As in the JAX package, the store
    alone is returned (its docstring promises a pair)."""
    if predicate is None:
        predicate = lambda name, v: name.endswith("/w") and v.dim() >= 2
    qmax = 2.0 ** (num_bits - 1) - 1
    store: Dict[str, Any] = {}
    for name, v in params.items():
        if predicate(name, v):
            red = tuple(range(1, v.dim()))
            a = torch.abs(v)
            scale = torch.clamp_min(torch.amax(a, dim=red) if red else a, 1e-8)
            sshape = (v.shape[0],) + (1,) * (v.dim() - 1)
            q = torch.clamp(torch.round(v / scale.reshape(sshape) * qmax), -qmax, qmax
                            ).to(torch.int8)
            store[name] = {"q": q, "scale": scale}
        else:
            store[name] = v
    return store


def dequantize_params(store: Dict[str, Any], dtype=torch.float32) -> Params:
    """Expand a quantized store back to dense params. Like the JAX
    package it divides by 127 whatever ``num_bits`` the store was made
    with, so a 4-bit store comes back at 7/127 of its size."""
    dtype = convert_dtype(dtype)
    qmax = 2.0 ** (8 - 1) - 1
    out: Params = {}
    for name, v in store.items():
        if isinstance(v, dict) and "q" in v:
            q, scale = v["q"], v["scale"]
            sshape = (q.shape[0],) + (1,) * (q.dim() - 1)
            out[name] = (q.to(torch.float32) * scale.reshape(sshape) / qmax).to(dtype)
        else:
            out[name] = v
    return out


# -- real int8 compute (serving) ---------------------------------------------

_int8_mode = threading.local()


@contextlib.contextmanager
def int8_serving(enabled: bool = True):
    """While active, the ``fc`` and ``conv2d`` layers of programs run in
    the block compute their products in int8 (:func:`int8_dynamic_matmul`,
    :func:`int8_dynamic_conv`). Wrap the export of an inference program::

        with quantize.int8_serving():
            io.save_inference_model(dir, program, params, state, feed)

    The artifact records the switch, so the loaded Predictor serves int8
    with no switch set."""
    old = getattr(_int8_mode, "on", False)
    _int8_mode.on = bool(enabled)
    try:
        yield
    finally:
        _int8_mode.on = old


def in_int8_serving() -> bool:
    return getattr(_int8_mode, "on", False)


# int8 products run, by route ("matmul": fc, "conv": conv2d); chip_smoke
# reads them to show which layers a served call took through int8
_route_lock = threading.Lock()
_route_counts = {"matmul": 0, "conv": 0}


def int8_route_counts() -> Dict[str, int]:
    """How many int8 matmuls and convs ran since the last reset."""
    with _route_lock:
        return dict(_route_counts)


def reset_int8_route_counts() -> None:
    with _route_lock:
        for k in _route_counts:
            _route_counts[k] = 0


def _count_route(kind: str) -> None:
    with _route_lock:
        _route_counts[kind] += 1


def _quant_dynamic(x: torch.Tensor, axes, qmax: float = 127.0):
    """Symmetric abs-max quantization over ``axes`` -> (int8, f32 scale).

    The JAX function's order of operations, so the int8 values are
    bit-equal to it: the abs-max in ``x``'s dtype floored at 1e-8, cast
    to f32, then ``round(x.f32 / scale * qmax)`` clipped to ±qmax
    (``torch.round`` rounds half to even, as ``jnp.round`` does)."""
    axes = tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)
    scale = torch.clamp_min(torch.amax(torch.abs(x), dim=axes, keepdim=True), 1e-8)
    scale = scale.float()
    q = torch.clamp(torch.round(x.float() / scale * qmax), -qmax, qmax).to(torch.int8)
    return q, scale


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _padded_int_mm(a: torch.Tensor, b: torch.Tensor, mm=None) -> torch.Tensor:
    """``a [M, K] @ b [K, N]`` of int8 operands into int32 through
    ``mm`` (default ``torch._int_mm``), padded with int8 zeros to what
    cuBLASLt's int8 GEMM takes: at least 32 rows (it refuses 16 or fewer)
    and every width a multiple of 8, ``a`` row-major and ``b``
    column-major (on an H100 a row-major ``b`` is refused at some row
    counts, CUBLAS_STATUS_NOT_SUPPORTED at 17). The padding adds zero
    products only, so the accumulators of the ``[M, N]`` result are the
    unpadded product's."""
    mm = torch._int_mm if mm is None else mm
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(32, _round_up(m, 8)), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    out = mm(a.contiguous(), b.t().contiguous().t())
    return out[:m, :n] if (mp, np_) != (m, n) else out


def _int8_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 ``a @ b`` of int8 operands: cuBLASLt's int8 GEMM on the card,
    the plain int32 matmul of the same operands on the CPU."""
    if a.is_cuda:
        return _padded_int_mm(a, b)
    return torch.matmul(a.to(torch.int32), b.to(torch.int32))


def _div_qmax2(t: torch.Tensor, qmax: float) -> torch.Tensor:
    # divided by a tensor: CUDA multiplies by the reciprocal of a Python
    # scalar divisor, one ulp from the CPU's (and the JAX package's) quotient
    return t / torch.full((), qmax * qmax, dtype=t.dtype, device=t.device)


def int8_dynamic_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in int8: ``x`` quantized per tensor, ``w`` ([in, out])
    per output column, the product accumulated in int32, then
    ``acc·(sx·sw/127²)`` in f32, cast to ``x``'s and ``w``'s promoted
    dtype."""
    qmax = 127.0
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    xq, sx = _quant_dynamic(x, axes=tuple(range(x.dim())))
    wq, sw = _quant_dynamic(w, axes=(0,))  # [1, n] per out column
    acc = _int8_product(xq.reshape(-1, xq.shape[-1]), wq).reshape(*x.shape[:-1], w.shape[1])
    _count_route("matmul")
    return (acc.to(torch.float32) * _div_qmax2(sx * sw, qmax)).to(out_dtype)


def _conv_int32(x: torch.Tensor, w: torch.Tensor, strides, padding, dilation,
                groups: int) -> torch.Tensor:
    """int32 conv of int8 ``x`` [N, H, W, C] with int8 ``w`` [O, kh, kw,
    C/groups]: zero padding, im2col through a strided view of the padded
    input, and one int8 product a group. Returns [N, OH, OW, O]."""
    (ph_lo, ph_hi), (pw_lo, pw_hi) = padding
    x = F.pad(x, (0, 0, pw_lo, pw_hi, ph_lo, ph_hi)).contiguous()
    n, hp, wp, c = x.shape
    o, kh, kw, cg = w.shape
    (sh, sw), (dh, dw) = strides, dilation
    oh = (hp - ((kh - 1) * dh + 1)) // sh + 1
    ow = (wp - ((kw - 1) * dw + 1)) // sw + 1
    s_n, s_h, s_w, s_c = x.stride()
    patches = x.as_strided((n, oh, ow, kh, kw, c),
                           (s_n, s_h * sh, s_w * sw, s_h * dh, s_w * dw, s_c))
    og = o // groups
    outs = []
    for g in range(groups):
        a = patches[..., g * cg:(g + 1) * cg].reshape(n * oh * ow, kh * kw * cg)
        b = w[g * og:(g + 1) * og].reshape(og, kh * kw * cg).t()
        outs.append(_int8_product(a, b))
    acc = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return acc.reshape(n, oh, ow, o)


def int8_dynamic_conv(x: torch.Tensor, w: torch.Tensor, window_strides: Sequence[int],
                      padding: Sequence[Tuple[int, int]], rhs_dilation: Sequence[int],
                      dimension_numbers: Tuple[str, str, str],
                      feature_group_count: int = 1) -> torch.Tensor:
    """``lax.conv_general_dilated`` in int8, as the JAX function: the
    activation quantized per tensor, the filter per output channel (over
    every axis but its ``O``), an int32 conv, then ``acc·(sx·sw/127²)``
    with ``sw`` laid along the output's channel axis.

    ``dimension_numbers`` names the layouts as strings, the JAX package's
    ``(lhs, rhs, out)`` specs: ``("NCHW", "OIHW", "NCHW")`` or ``("NHWC",
    "HWIO", "NHWC")`` (any order of those letters is read); ``padding`` is
    ``[(lo, hi), (lo, hi)]`` for H and W."""
    qmax = 127.0
    lhs, rhs, out_spec = dimension_numbers
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    xq, sx = _quant_dynamic(x, axes=tuple(range(x.dim())))
    oc_axis = rhs.index("O")
    wq, sw = _quant_dynamic(w, axes=tuple(a for a in range(w.dim()) if a != oc_axis))
    acc = _conv_int32(xq.permute(*(lhs.index(d) for d in "NHWC")),
                      wq.permute(*(rhs.index(d) for d in "OHWI")),
                      tuple(window_strides), tuple(tuple(p) for p in padding),
                      tuple(rhs_dilation), int(feature_group_count))
    acc = acc.permute(*("NHWC".index(d) for d in out_spec))
    _count_route("conv")
    sw_vec = sw.reshape(-1)
    sshape = [1] * acc.dim()
    sshape[out_spec.index("C")] = sw_vec.shape[0]
    scale = _div_qmax2(sx * sw_vec.reshape(sshape), qmax)
    return (acc.to(torch.float32) * scale).to(out_dtype)


# -- low-precision inference (float16_transpiler analog) ---------------------


def cast_params_for_inference(params: Params, dtype=torch.bfloat16) -> Params:
    """Cast the floating params for low-precision inference (pair with
    ``framework.amp_guard`` for the compute); other params pass through."""
    dtype = convert_dtype(dtype)
    return {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in params.items()}


# -- BN folding (inference_transpiler analog) --------------------------------


def fold_batch_norms(params: Params, state: Dict[str, torch.Tensor],
                     conv_bn_pairs) -> Params:
    """Fold BN (scale, bias, moving mean and variance) into the preceding
    bias-free conv's weights, inference_transpiler.py's conv+BN fuse:
    ``conv_bn_pairs`` lists (conv prefix, bn prefix), e.g. ("conv2d_0",
    "batch_norm_0"); each conv gets ``w·inv`` and a ``folded_bias`` of
    ``beta − mean·inv``, where ``inv = gamma·rsqrt(var + 1e-5)``."""
    out = dict(params)
    for conv, bn in conv_bn_pairs:
        w = params[f"{conv}/w"]
        gamma = params[f"{bn}/scale"]
        beta = params[f"{bn}/bias"]
        mean = state[f"{bn}/moving_mean"]
        var = state[f"{bn}/moving_variance"]
        inv = gamma * torch.rsqrt(var + 1e-5)
        out[f"{conv}/w"] = w * inv.reshape((-1,) + (1,) * (w.dim() - 1))
        out[f"{conv}/folded_bias"] = beta - mean * inv
    return out


__all__ = ["cast_params_for_inference", "dequantize_params", "fake_quant",
           "fake_quant_abs_max", "fold_batch_norms", "in_int8_serving",
           "int8_dynamic_conv", "int8_dynamic_matmul", "int8_route_counts",
           "int8_serving", "quant_dequant_moving_avg", "quantize_params",
           "reset_int8_route_counts"]
