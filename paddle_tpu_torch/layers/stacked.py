"""Stacked transformer blocks (counterpart of ``paddle_tpu.layers.stacked``).

Per-layer parameters live stacked on a leading ``[num_layers, ...]``
axis, under the JAX package's names (``ln1/scale``, ``qkv/w`` ...):
created through ``LayerHelper`` by :func:`encoder_stack_params` and
:func:`decoder_stack_params` inside a ``build`` program. The block functions
are plain functions of ``(activation, layer_params[, extra])`` as in the
JAX package, with the compute dtype passed in
(``framework.cast_compute``) instead of read from a flag. Weights stay
``[in, out]``; the fused qkv weight stays ``[d, 3, d]`` and the cross
attention's K/V weight ``[d, 2, d]``, each applied as one 2-D product
(``aten.mm``), so a remat policy that keeps products with no batch
dimensions keeps them.

Training runs :func:`apply_stacked` over :func:`make_encoder_block` or
:func:`make_decoder_block` sequentially, one Python loop over the layers
in place of the JAX ``lax.scan``, each layer under
``framework.maybe_remat`` (``remat=True`` forces it, False defers to the
ambient ``remat_mode``). Dropout in training sits at the JAX package's
sites of a block (the attention probabilities, the residual branches and
the FFN's inner activation, ``upscale_in_train``), drawn in turn from the
running program's rng stream, so the layers draw different masks and a
recomputed layer draws its forward's.

Incremental decoding (:func:`decode_block`, and :func:`decode_block_q8`
over the int8 KV cache of :func:`quantize_kv`) takes the cache index as a
0-dim integer tensor on the caches' device, or a Python int. A tensor
index is used on the device only (the cache write, the mask and, in the
generator, the positional row), never read back to the host, so a decode
step can be captured as a CUDA graph and replayed with the index advanced
on the card.

Under ``framework.sp_mode`` (the Trainer's ``DistStrategy(
sequence_parallel=True)``) the self-attention of :func:`apply_stacked`'s
blocks runs as ring or Ulysses attention over the mesh's sp axis
(``_sdpa``'s sp route). Under ``framework.pipeline_mode`` (the Trainer's
``DistStrategy(pp_microbatches=...)``) the stack runs through
``parallel.pipeline.pipeline_apply`` over the mesh's pp axis, and on a
mesh with a tp axis the blocks take ``tp_axis``: their heads and FFN
columns are the rank's tp shards (:func:`stack_tp_specs`) and the output
projections sum their partials over tp (``parallel.pipeline.psum``), the
Megatron pattern inside a stage.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from ..core.errors import enforce
from ..framework import (LayerHelper, cast_compute, compute_dtype as _compute_dtype,
                         current_context, in_training, maybe_remat, pipeline_config,
                         sp_config)
from ..parallel.sharding import PartitionSpec as P
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


# JAX name inside the stack -> its initializer, in the JAX package's order
STACK_PARAMS = {
    "ln1/scale": init.Constant(1.0),
    "ln1/bias": init.Constant(0.0),
    "qkv/w": StackedInit(init.Xavier()),
    "qkv/b": init.Constant(0.0),
    "out/w": StackedInit(init.Xavier()),
    "out/b": init.Constant(0.0),
    "ln2/scale": init.Constant(1.0),
    "ln2/bias": init.Constant(0.0),
    "ffn_in/w": StackedInit(init.Xavier()),
    "ffn_in/b": init.Constant(0.0),
    "ffn_out/w": StackedInit(init.Xavier()),
    "ffn_out/b": init.Constant(0.0),
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


def _create_stack(name: str, specs) -> Dict[str, torch.Tensor]:
    """``{param: (shape, initializer)}`` created (init) or fetched (apply)
    in f32 under ``LayerHelper(name)``."""
    helper = LayerHelper(name, name=name)
    return {k: helper.create_parameter(k, shape, torch.float32, initializer=i)
            for k, (shape, i) in specs.items()}


def encoder_stack_params(num_layers: int, d_model: int, d_inner: int,
                         name: str = "encoder_stack") -> Dict[str, torch.Tensor]:
    """The stacked f32 params of ``num_layers`` pre-LN self-attention
    blocks through ``LayerHelper``, under ``<scope>/<name>/ln1/scale`` ...
    (layers/stacked.py:150)."""
    shapes = encoder_stack_shapes(num_layers, d_model, d_inner)
    return _create_stack(name, {k: (shapes[k], i) for k, i in STACK_PARAMS.items()})


def decoder_stack_params(num_layers: int, d_model: int, d_inner: int,
                         name: str = "decoder_stack") -> Dict[str, torch.Tensor]:
    """:func:`encoder_stack_params` plus the cross attention's
    (layers/stacked.py:178): ``lnx/*``, ``xq/*``, ``xkv/w`` ``[L, d, 2,
    d]``, ``xkv/b`` ``[L, 2, d]`` and ``xout/*``."""
    L, d = num_layers, d_model
    ones, zeros, xavier = init.Constant(1.0), init.Constant(0.0), StackedInit(init.Xavier())
    p = encoder_stack_params(num_layers, d_model, d_inner, name=name)
    p.update(_create_stack(name, {
        "lnx/scale": ((L, d), ones), "lnx/bias": ((L, d), zeros),
        "xq/w": ((L, d, d), xavier), "xq/b": ((L, d), zeros),
        "xkv/w": ((L, d, 2, d), xavier), "xkv/b": ((L, 2, d), zeros),
        "xout/w": ((L, d, d), xavier), "xout/b": ((L, d), zeros)}))
    return p


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
        # the sequence-parallel route (stacked.py:85-110): ring attention
        # over the sp axis in the layout the model set ("zigzag" when it
        # permuted its own activations, as models/gpt.py does), or Ulysses
        enforce(key_bias is None,
                "sequence-parallel attention does not take a padding bias "
                "(pack full sequences; pad-free is the long-context contract)")
        enforce(dropout_rate == 0.0 or not training,
                "sequence-parallel attention has no softmax-dropout site "
                "(ring/ulysses kernels); train sp stacks with dropout 0")
        if sp_cfg.get("impl", "ring") == "ulysses":
            from ..parallel.ulysses import ulysses_attention

            def inner(qh, kh, vh, caus):
                if use_flash:
                    from ..ops.flash_attention import flash_attention
                    return flash_attention(qh, kh, vh, causal=caus)
                return _sdpa(qh, kh, vh, None, caus, False)

            return ulysses_attention(q, k, v, sp_cfg["mesh"], axis_name=sp_cfg["axis"],
                                     causal=causal, attn_fn=inner)
        from ..parallel.ring_attention import ring_attention
        layout = sp_cfg.get("layout", "natural")
        return ring_attention(q, k, v, sp_cfg["mesh"], axis_name=sp_cfg["axis"],
                              causal=causal,
                              schedule="zigzag" if (causal and layout == "zigzag") else "auto",
                              layout=layout)
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


def _fused_projection(h, w, bias):
    """einsum "bsd,dke->bske" (a fused projection ``[d, k, e]``) as one
    ``[d, k·e]`` product. A DTensor weight whose k or e dim is sharded (a tp
    rule's) cannot be flattened in place: DTensor of torch 2.11 refuses to
    redistribute inside the reshape, so such a weight runs one product per
    k, each keeping its shard."""
    if any(getattr(pl, "dim", 0) in (1, 2) for pl in getattr(w, "placements", ())):
        return torch.stack([torch.matmul(h, w[:, i]) + bias[i] for i in range(w.shape[1])],
                           dim=2)
    b, s, _ = h.shape
    return torch.matmul(h, w.reshape(w.shape[0], -1)).view(b, s, w.shape[1], -1) + bias


def _attn_qkv(x, p, num_heads, compute_dtype):
    b, s, d = x.shape
    head_dim = d // num_heads
    h = _ln(x, p["ln1/scale"], p["ln1/bias"])
    h, w = cast_compute(compute_dtype, h, p["qkv/w"])
    qkv = _fused_projection(h, w, p["qkv/b"].to(h.dtype))
    return tuple(_split_heads(qkv[:, :, i], head_dim) for i in range(3))


def _tp_sum(h, tp_axis):
    """The partial sums of a row-parallel product summed over ``tp_axis``
    (the JAX blocks' ``psum``); nothing without tensor parallelism."""
    if not tp_axis:
        return h
    from ..parallel.pipeline import psum
    return psum(h, tp_axis)


def _attn_out(x, p, o, compute_dtype, dropout_rate: float = 0.0,
              training: bool = False, tp_axis=None):
    o, ow = cast_compute(compute_dtype, _merge_heads(o), p["out/w"])
    o = _tp_sum(torch.matmul(o, ow), tp_axis)
    return x + _drop(o + p["out/b"].to(o.dtype), dropout_rate, training)


def _ffn(x, p, compute_dtype, dropout_rate: float = 0.0, training: bool = False,
         tp_axis=None):
    h = _ln(x, p["ln2/scale"], p["ln2/bias"])
    h, w1, w2 = cast_compute(compute_dtype, h, p["ffn_in/w"], p["ffn_out/w"])
    h = torch.relu(torch.matmul(h, w1) + p["ffn_in/b"].to(h.dtype))
    h = _drop(h, dropout_rate, training)
    h = _tp_sum(torch.matmul(h, w2), tp_axis)
    return x + _drop(h + p["ffn_out/b"].to(h.dtype), dropout_rate, training)


def _self_attention(x, p, num_heads, causal, use_flash, key_bias,
                    compute_dtype, dropout_rate: float = 0.0,
                    training: bool = False, sp_cfg=None, tp_axis=None):
    q, k, v = _attn_qkv(x, p, num_heads, compute_dtype)
    o = _sdpa(q, k, v, key_bias, causal, use_flash, sp_cfg, dropout_rate=dropout_rate,
              training=training)
    return _attn_out(x, p, o, compute_dtype, dropout_rate, training, tp_axis)


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
    from the running program's rng (:func:`framework.next_rng_key`).
    With ``tp_axis`` the layer params are the rank's tp shards
    (:func:`stack_tp_specs`: whole heads, FFN columns) and the attention's
    and FFN's output products sum their partials over that axis inside a
    ``parallel.pipeline`` region."""

    def block(x, p, key_bias=None):
        x = _self_attention(x, p, num_heads, causal, use_flash, key_bias,
                            compute_dtype, dropout_rate, training, sp_cfg, tp_axis)
        return _ffn(x, p, compute_dtype, dropout_rate, training, tp_axis)

    return block


def make_decoder_block(num_heads: int, use_flash: bool = False,
                       causal: bool = True, tp_axis: Optional[str] = None,
                       sp_cfg: Optional[dict] = None,
                       dropout_rate: float = 0.0,
                       compute_dtype=torch.float32,
                       training: bool = False) -> Callable:
    """``layer_fn(x, layer_params, extra)`` with ``extra = {"enc": the
    encoder's output [b, s, d], "enc_bias": its additive [b, s] padding
    bias}`` (layers/stacked.py:245): causal self-attention, the cross
    attention, then the FFN. The cross attention runs through
    :func:`_sdpa` non-causal under ``enc_bias`` with ``use_flash``, so
    where dropout is a no-op it takes the flash kernels, queries from the
    decoder and keys from the encoder. ``tp_axis`` as in
    :func:`make_encoder_block`; the cross attention's output sums over it
    too."""
    enforce(sp_cfg is None,
            "sequence parallelism is wired for the self-attention-only "
            "stack (models/gpt.py); the encoder-decoder cross-attention "
            "path does not support it")

    def block(x, p, extra):
        head_dim = x.shape[-1] // num_heads
        x = _self_attention(x, p, num_heads, causal, use_flash, None, compute_dtype,
                            dropout_rate, training, tp_axis=tp_axis)
        h = _ln(x, p["lnx/scale"], p["lnx/bias"])
        h, wq, wkv, enc = cast_compute(compute_dtype, h, p["xq/w"], p["xkv/w"], extra["enc"])
        q = torch.matmul(h, wq) + p["xq/b"].to(h.dtype)
        kv = _fused_projection(enc, wkv, p["xkv/b"].to(h.dtype))
        q = _split_heads(q, head_dim)
        k, v = (_split_heads(kv[:, :, i], head_dim) for i in range(2))
        o = _merge_heads(_sdpa(q, k, v, extra.get("enc_bias"), False, use_flash,
                               dropout_rate=dropout_rate, training=training))
        o, ow = cast_compute(compute_dtype, o, p["xout/w"])
        o = _tp_sum(torch.matmul(o, ow), tp_axis)
        x = x + _drop(o + p["xout/b"].to(o.dtype), dropout_rate, training)
        return _ffn(x, p, compute_dtype, dropout_rate, training, tp_axis)

    return block


# -- tensor-parallel specs (the non-layer dims; pipeline_apply's param_specs) -

_ENCODER_TP_SPECS = {
    "ln1/scale": P(), "ln1/bias": P(),
    "qkv/w": P(None, None, "tp"), "qkv/b": P(None, "tp"),
    "out/w": P("tp"), "out/b": P(),
    "ln2/scale": P(), "ln2/bias": P(),
    "ffn_in/w": P(None, "tp"), "ffn_in/b": P("tp"),
    "ffn_out/w": P("tp"), "ffn_out/b": P(),
}

_DECODER_TP_SPECS = dict(_ENCODER_TP_SPECS, **{
    "lnx/scale": P(), "lnx/bias": P(),
    "xq/w": P(None, "tp"), "xq/b": P("tp"),
    "xkv/w": P(None, None, "tp"), "xkv/b": P(None, "tp"),
    "xout/w": P("tp"), "xout/b": P(),
})


def stack_tp_specs(stacked: Dict[str, torch.Tensor]) -> Dict[str, P]:
    """The tp spec of each stacked leaf's non-layer dims (stacked.py:390)."""
    table = _DECODER_TP_SPECS if "xq/w" in stacked else _ENCODER_TP_SPECS
    return {k: table[k] for k in stacked}


def apply_stacked(x, stacked: Dict[str, torch.Tensor], make_block: Callable,
                  extras=None, num_heads: int = 8, use_flash: bool = False,
                  causal: bool = False, remat: bool = False,
                  dropout_rate: float = 0.0):
    """Run a parameter stack ``{name: [L, ...]}`` over ``x``: pipelined
    across the mesh's pp axis when the Trainer has entered
    :func:`framework.pipeline_mode` (``DistStrategy.pp_microbatches``),
    layer by layer otherwise (the JAX package's sequential ``lax.scan``).

    Layer by layer, each layer's dropout masks differ from the other
    layers' because the program's rng stream advances at every draw (the
    JAX package folds the layer index into its key, stacked.py:432-439),
    and each layer runs under :func:`framework.maybe_remat`: ``remat=True``
    forces the recompute, False defers to the ambient ``remat_mode`` and
    its policy (as stacked.py:436), with the running program's context
    (names, rng, layout) replayed.

    Pipelined (stacked.py:441-466), ``parallel.pipeline.pipeline_apply``
    runs the blocks, with ``tp_axis`` when the mesh has a tp axis larger
    than 1 (``num_heads`` divisible by it) and the rank's tp shards of
    :func:`stack_tp_specs`; with dropout in training each (layer,
    microbatch, data shard) draws from a generator of its own tag. The
    pipeline and sequence parallelism cannot wrap the same stack. The
    blocks compute in the running program's dtype and mode
    (``framework.compute_dtype``, ``in_training``)."""
    cfg = pipeline_config()
    sp = sp_config()
    enforce(not (cfg is not None and sp is not None),
            "pipeline and sequence parallelism cannot wrap the same stack "
            "(ring attention's shard_map cannot nest inside the pipeline's)")
    if cfg is not None:
        return _apply_pipelined(x, stacked, make_block, extras, num_heads, use_flash,
                                causal, dropout_rate, cfg)
    block = make_block(num_heads=num_heads, use_flash=use_flash,
                       causal=causal, tp_axis=None, sp_cfg=sp,
                       dropout_rate=dropout_rate, compute_dtype=_compute_dtype(),
                       training=in_training())

    def layer(a, lp):
        return block(a, lp) if extras is None else block(a, lp, extras)

    # remat=False defers to the ambient switch
    layer = maybe_remat(layer, enabled=remat or None)
    num_layers = next(iter(stacked.values())).shape[0]
    for i in range(num_layers):
        lp = {name: t[i] for name, t in stacked.items()}
        x = layer(x, lp)
    return x


def _apply_pipelined(x, stacked, make_block, extras, num_heads, use_flash, causal,
                     dropout_rate, cfg):
    from ..initializer import mix_seed
    from ..parallel.pipeline import pipeline_apply

    mesh = cfg["mesh"]
    tp = "tp" if ("tp" in mesh.axis_names and mesh.shape["tp"] > 1) else None
    if tp:
        enforce(num_heads % mesh.shape["tp"] == 0,
                f"stacked blocks with tp={mesh.shape['tp']} need num_heads "
                f"({num_heads}) divisible by tp")
    training = in_training()
    block = make_block(num_heads=num_heads, use_flash=use_flash, causal=causal,
                       tp_axis=tp, sp_cfg=None, dropout_rate=dropout_rate,
                       compute_dtype=_compute_dtype(), training=training)
    layer_fn = block if extras is not None else (lambda a, lp: block(a, lp))
    # dropout: one tag a stack a run, folded per (layer, microbatch, data
    # shard) in the schedule; eval draws nothing
    rng_key = None
    if dropout_rate > 0.0 and training:
        rng_key = mix_seed(0x9191, current_context().unique_name("pipeline_rng"))
    return pipeline_apply(
        x, stacked, layer_fn, mesh, axis_name=cfg["axis"],
        microbatches=cfg["microbatches"], interleave=cfg.get("interleave", 1),
        param_specs=stack_tp_specs(stacked) if tp else None, extras=extras,
        param_layout=cfg.get("param_layout", "stacked"), rng_key=rng_key)


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


__all__ = ["STACK_PARAMS", "StackedInit",
           "apply_stacked", "decode_block", "decode_block_q8", "decoder_stack_params",
           "encoder_stack_params", "encoder_stack_shapes", "make_decoder_block",
           "make_encoder_block", "prefill_block", "quantize_kv", "stack_tp_specs"]
