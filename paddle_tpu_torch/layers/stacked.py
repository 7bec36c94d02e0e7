"""Stacked transformer blocks (counterpart of ``paddle_tpu.layers.stacked``).

Per-layer parameters live stacked on a leading ``[num_layers, ...]``
axis, under the JAX package's names (``ln1/scale``, ``qkv/w`` ...), owned
by :class:`EncoderStack`. The block functions are plain functions of
``(activation, layer_params)`` as in the JAX package, with the compute
dtype passed in (``framework.cast_compute``) instead of read from a flag.
Weights stay ``[in, out]``; the fused qkv weight stays ``[d, 3, d]``.

Training runs :func:`apply_stacked` over :func:`make_encoder_block`
sequentially, one Python loop over the layers in place of the JAX
``lax.scan``, with ``remat=True`` as per-layer
``framework.maybe_remat``. Dropout in training sits at the JAX package's
four sites of a block (the attention probabilities, the two residual
branches and the FFN's inner activation, ``upscale_in_train``), drawn in
turn from the running program's rng stream, so the layers draw
different masks and a recomputed layer draws its forward's.

Incremental decoding (:func:`decode_block`, and :func:`decode_block_q8`
over the int8 KV cache of :func:`quantize_kv`) takes the cache index as a
0-dim integer tensor on the caches' device, or a Python int. A tensor
index is used on the device only (the cache write, the mask and, in the
generator, the positional row), never read back to the host, so a decode
step can be captured as a CUDA graph and replayed with the index advanced
on the card.

Not carried yet, each raising :class:`NotYetPorted`: the
sequence-parallel branch of ``_sdpa`` and tensor-parallel psums.
``apply_stacked``'s pipeline path is entered through
``DistStrategy.pp_microbatches``, which the port's ``Trainer`` does not
take yet.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..core.errors import NotYetPorted
from ..framework import cast_compute, maybe_remat
from .. import initializer as init
from .nn import dropout

NEG_INF = -1e9


class StackedInit(init.Initializer):
    """Apply a base initializer per layer over the leading stack axis, so
    a ``[L, d, k]`` leaf gets L independent ``[d, k]`` inits (fan-in/out
    computed per layer, matching the unstacked model exactly)."""

    def __init__(self, base: init.Initializer):
        self.base = base

    def __call__(self, generator, shape, dtype):
        return torch.stack([self.base(generator, shape[1:], dtype)
                            for _ in range(shape[0])])


# JAX name inside the stack -> (module attribute, initializer); the one
# table that maps the JAX package's names onto this module
STACK_PARAMS = {
    "ln1/scale": ("ln1_scale", init.Constant(1.0)),
    "ln1/bias": ("ln1_bias", init.Constant(0.0)),
    "qkv/w": ("qkv_w", StackedInit(init.Xavier())),
    "qkv/b": ("qkv_b", init.Constant(0.0)),
    "out/w": ("out_w", StackedInit(init.Xavier())),
    "out/b": ("out_b", init.Constant(0.0)),
    "ln2/scale": ("ln2_scale", init.Constant(1.0)),
    "ln2/bias": ("ln2_bias", init.Constant(0.0)),
    "ffn_in/w": ("ffn_in_w", StackedInit(init.Xavier())),
    "ffn_in/b": ("ffn_in_b", init.Constant(0.0)),
    "ffn_out/w": ("ffn_out_w", StackedInit(init.Xavier())),
    "ffn_out/b": ("ffn_out_b", init.Constant(0.0)),
}
_MATMUL_WEIGHTS = ("qkv/w", "out/w", "ffn_in/w", "ffn_out/w")


def encoder_stack_shapes(num_layers: int, d_model: int, d_inner: int):
    """{JAX name: shape} of ``encoder_stack_params`` (all float32)."""
    L, d, di = num_layers, d_model, d_inner
    return {
        "ln1/scale": (L, d), "ln1/bias": (L, d),
        "qkv/w": (L, d, 3, d), "qkv/b": (L, 3, d),
        "out/w": (L, d, d), "out/b": (L, d),
        "ln2/scale": (L, d), "ln2/bias": (L, d),
        "ffn_in/w": (L, d, di), "ffn_in/b": (L, di),
        "ffn_out/w": (L, di, d), "ffn_out/b": (L, d),
    }


class EncoderStack(nn.Module):
    """The stacked params of ``num_layers`` pre-LN self-attention blocks
    (``encoder_stack_params``): float32 tensors ``[L, ...]`` under the
    attributes of :data:`STACK_PARAMS`, trainable when ``trainable``."""

    def __init__(self, num_layers: int, d_model: int, d_inner: int,
                 device=None, trainable: bool = False):
        super().__init__()
        self.num_layers = num_layers
        for name, shape in encoder_stack_shapes(num_layers, d_model,
                                                d_inner).items():
            self.register_parameter(STACK_PARAMS[name][0], nn.Parameter(
                torch.empty(shape, dtype=torch.float32, device=device),
                requires_grad=trainable))

    def get(self, name: str) -> torch.Tensor:
        return getattr(self, STACK_PARAMS[name][0])

    def params(self) -> Dict[str, torch.Tensor]:
        """{JAX name inside the stack: [L, ...] tensor}, as
        ``encoder_stack_params`` returns them."""
        return {name: self.get(name) for name in STACK_PARAMS}

    def layer(self, i: int, compute_dtype=None) -> Dict[str, torch.Tensor]:
        """Layer ``i``'s params by JAX name. With ``compute_dtype`` the
        matmul weights come already cast, so a decode loop casts them
        once per call rather than once per step (the same values
        ``cast_compute`` gives inside each block)."""
        out = {name: self.get(name)[i] for name in STACK_PARAMS}
        if compute_dtype is not None:
            for name in _MATMUL_WEIGHTS:
                out[name] = cast_compute(compute_dtype, out[name])
        return out


def _ln(x, scale, bias, eps: float = 1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps)
    return out * scale + bias


def _drop(x, rate: float, training: bool):
    """Residual/inner dropout (``upscale_in_train``, as the unrolled
    transformer layer); a no-op at rate 0 or outside training."""
    if rate == 0.0:
        return x
    return dropout(x, rate, is_test=not training,
                   dropout_implementation="upscale_in_train")


def _sdpa(q, k, v, key_bias, causal: bool, use_flash: bool, sp_cfg=None,
          dropout_rate: float = 0.0, training: bool = False):
    """[b,h,s,hd] attention with an additive [b,s_k] key bias. The flash
    kernel when ``use_flash`` and dropout is a no-op (the routing rule of
    layers/attention.py), else the dense path with dropout on the
    probabilities."""
    if sp_cfg is not None:
        raise NotYetPorted("sequence-parallel attention (multi-GPU slice)")
    if use_flash and (dropout_rate == 0.0 or not training):
        from ..ops.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=causal, key_bias=key_bias)
    from ..ops.attention_scores import scores_mxu
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = scores_mxu(q, k, scale)
    if key_bias is not None:
        logits = logits + key_bias[:, None, None, :]
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        cm = torch.ones((sq, sk), dtype=torch.bool,
                        device=logits.device).tril(sk - sq)
        logits = logits.masked_fill(~cm, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    probs = _drop(probs, dropout_rate, training)
    return torch.matmul(probs, v)


def _split_heads(x, head_dim):
    b, s, d = x.shape
    return x.reshape(b, s, d // head_dim, head_dim).transpose(1, 2)


def _merge_heads(x):
    b, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, h * hd)


def _attn_qkv(x, p, num_heads, compute_dtype):
    b, s, d = x.shape
    head_dim = d // num_heads
    h = _ln(x, p["ln1/scale"], p["ln1/bias"])
    h, w = cast_compute(compute_dtype, h, p["qkv/w"])
    # einsum "bsd,dke->bske" as one [d, 3d] matmul
    qkv = torch.matmul(h, w.reshape(w.shape[0], -1)).view(b, s, 3, -1) \
        + p["qkv/b"].to(h.dtype)
    return tuple(_split_heads(qkv[:, :, i], head_dim) for i in range(3))


def _attn_out(x, p, o, compute_dtype, dropout_rate: float = 0.0,
              training: bool = False):
    o, ow = cast_compute(compute_dtype, _merge_heads(o), p["out/w"])
    o = torch.matmul(o, ow)
    return x + _drop(o + p["out/b"].to(o.dtype), dropout_rate, training)


def _ffn(x, p, compute_dtype, dropout_rate: float = 0.0, training: bool = False):
    h = _ln(x, p["ln2/scale"], p["ln2/bias"])
    h, w1, w2 = cast_compute(compute_dtype, h, p["ffn_in/w"], p["ffn_out/w"])
    h = torch.relu(torch.matmul(h, w1) + p["ffn_in/b"].to(h.dtype))
    h = _drop(h, dropout_rate, training)
    h = torch.matmul(h, w2)
    return x + _drop(h + p["ffn_out/b"].to(h.dtype), dropout_rate, training)


def _self_attention(x, p, num_heads, causal, use_flash, key_bias,
                    compute_dtype, dropout_rate: float = 0.0,
                    training: bool = False):
    q, k, v = _attn_qkv(x, p, num_heads, compute_dtype)
    o = _sdpa(q, k, v, key_bias, causal, use_flash, dropout_rate=dropout_rate,
              training=training)
    return _attn_out(x, p, o, compute_dtype, dropout_rate, training)


def make_encoder_block(num_heads: int, use_flash: bool = False,
                       causal: bool = False, tp_axis: Optional[str] = None,
                       sp_cfg: Optional[dict] = None,
                       dropout_rate: float = 0.0,
                       compute_dtype=torch.float32,
                       training: bool = False) -> Callable:
    """``layer_fn(x, layer_params, key_bias=None)``: pre-LN self-attention
    then the FFN (layers/stacked.py:224), with ``dropout_rate`` at the
    four dropout sites in training. The compute dtype and whether this is
    a training pass are arguments here, where the JAX package reads them
    from its build context; a training pass with dropout draws its masks
    from the running program's rng (:func:`framework.next_rng_key`)."""
    if tp_axis is not None:
        raise NotYetPorted("tensor-parallel stacked blocks (multi-GPU slice)")
    if sp_cfg is not None:
        raise NotYetPorted("sequence-parallel attention (multi-GPU slice)")

    def block(x, p, key_bias=None):
        x = _self_attention(x, p, num_heads, causal, use_flash, key_bias,
                            compute_dtype, dropout_rate, training)
        return _ffn(x, p, compute_dtype, dropout_rate, training)

    return block


def apply_stacked(x, stacked: Dict[str, torch.Tensor], make_block: Callable,
                  extras=None, num_heads: int = 8, use_flash: bool = False,
                  causal: bool = False, remat: bool = False,
                  dropout_rate: float = 0.0, compute_dtype=torch.float32,
                  training: bool = False):
    """Run a parameter stack ``{name: [L, ...]}`` over ``x``, layer by
    layer (the JAX package's sequential ``lax.scan``). Each layer's
    dropout masks differ from the other layers' because the program's rng
    stream advances at every draw (the JAX package folds the layer index
    into its key, stacked.py:432-439). ``remat=True`` runs each
    layer under :func:`framework.maybe_remat`: its activations are
    recomputed in the backward instead of kept, with the running
    program's context (names, rng, layout) replayed."""
    block = make_block(num_heads=num_heads, use_flash=use_flash,
                       causal=causal, tp_axis=None, sp_cfg=None,
                       dropout_rate=dropout_rate, compute_dtype=compute_dtype,
                       training=training)

    def layer(a, lp):
        return block(a, lp) if extras is None else block(a, lp, extras)

    layer = maybe_remat(layer, enabled=remat)
    num_layers = next(iter(stacked.values())).shape[0]
    for i in range(num_layers):
        lp = {name: t[i] for name, t in stacked.items()}
        x = layer(x, lp)
    return x


def prefill_block(x, p, num_heads: int, use_flash: bool = False,
                  compute_dtype=torch.float32):
    """Causal block that also returns its (k, v) for cache seeding."""
    q, k, v = _attn_qkv(x, p, num_heads, compute_dtype)
    x = _attn_out(x, p, _sdpa(q, k, v, None, True, use_flash), compute_dtype)
    return _ffn(x, p, compute_dtype), (k, v)


def quantize_kv(x):
    """Symmetric per-vector int8 quantization of a cache entry over the
    head_dim axis (``quantize._quant_dynamic``), with the scale converted
    to the multiply-direct convention the decode products factor out
    (dequant = q·scale, ``scale / 127``). Returns (int8, [..., 1] f32);
    zero vectors dequantize to exact 0."""
    from ..quantize import _quant_dynamic

    q, scale = _quant_dynamic(x, axes=(-1,))
    return q, scale / 127.0


def _write_at(cache, index, value):
    """``cache[:, :, index] = value`` in place, ``index`` a Python int or a
    0-dim integer tensor on the cache's device (no host read)."""
    idx = torch.as_tensor(index, device=cache.device).reshape(1).long()
    cache.index_copy_(2, idx, value.to(cache.dtype))


def decode_block_q8(x, p, k_q, k_s, v_q, v_s, index, num_heads: int,
                    compute_dtype=torch.float32):
    """:func:`decode_block` over an int8 KV cache: ``k_q``/``v_q`` int8
    [rows, h, T, hd] with per-position f32 scales ``k_s``/``v_s`` [rows,
    h, T, 1], written in place at ``index``. The scales factor out of
    both products, as in the JAX function (stacked.py:341-348): the
    logits are ``(q · k_q) · k_s · 1/√hd``, the output ``(probs · v_s) ·
    v_q``. Plain PyTorch: the int8 → compute-dtype converts are copies of
    the cache here, where XLA fuses them into the dots. Returns (x, k_q,
    k_s, v_q, v_s)."""
    q, k1, v1 = _attn_qkv(x, p, num_heads, compute_dtype)
    k1q, k1s = quantize_kv(k1)
    v1q, v1s = quantize_kv(v1)
    _write_at(k_q, index, k1q)
    _write_at(k_s, index, k1s)
    _write_at(v_q, index, v1q)
    _write_at(v_s, index, v1s)
    scale = 1.0 / math.sqrt(q.shape[-1])
    # int8 and bf16 values are exact in f32: the f32 product is the JAX
    # einsum's bf16 x bf16 -> f32 (preferred_element_type) product
    logits = torch.matmul(q.float(), k_q.float().transpose(-1, -2))
    logits = logits * k_s[..., 0][:, :, None, :] * scale
    pos = torch.arange(k_q.shape[2], device=logits.device)
    logits = logits.masked_fill(pos > index, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    pv = (probs * v_s[..., 0][:, :, None, :]).to(q.dtype)
    o = torch.matmul(pv, v_q.to(q.dtype))
    x = _attn_out(x, p, o, compute_dtype)
    return _ffn(x, p, compute_dtype), k_q, k_s, v_q, v_s


def decode_block(x, p, k_cache, v_cache, index, num_heads: int,
                 compute_dtype=torch.float32):
    """One-token step: x [rows, 1, d]; caches [rows, h, T, hd]; attends
    to cache positions <= index (a Python int or a 0-dim integer tensor on
    the caches' device). Returns (x, k_cache, v_cache).

    Unlike the JAX package's functional ``dynamic_update_slice``, the
    caches are updated IN PLACE at position ``index`` (the generator
    owns them; a copy per step would move the whole cache)."""
    q, k1, v1 = _attn_qkv(x, p, num_heads, compute_dtype)
    _write_at(k_cache, index, k1)
    _write_at(v_cache, index, v1)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k_cache.float().transpose(-1, -2)) * scale
    pos = torch.arange(k_cache.shape[2], device=logits.device)
    logits = logits.masked_fill(pos > index, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    o = torch.matmul(probs, v_cache)
    x = _attn_out(x, p, o, compute_dtype)
    return _ffn(x, p, compute_dtype), k_cache, v_cache


__all__ = ["EncoderStack", "STACK_PARAMS", "StackedInit", "apply_stacked",
           "decode_block", "decode_block_q8", "encoder_stack_shapes",
           "make_encoder_block", "prefill_block", "quantize_kv"]
