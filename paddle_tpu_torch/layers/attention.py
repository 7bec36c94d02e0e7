"""Attention layers (counterpart of ``paddle_tpu.layers.attention``):
``scaled_dot_product_attention``, ``multi_head_attention``, ``ffn``,
``positional_encoding`` and ``padding_mask``.

``multi_head_attention`` and ``ffn`` create their parameters through
``LayerHelper`` under the JAX package's names (``mha_0/q_proj/w``,
``mha_0/qkv_proj/w``, ``ffn_0/ffn_in/w`` ...): f32 Xavier weights
``[in, out]`` (``[in, 3, d]`` / ``[in, 2, d]`` when ``fuse_qkv``) and
zero biases, cast to the program's compute dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import initializer as init
from ..core.errors import enforce
from ..framework import LayerHelper, cast_compute, compute_dtype, in_training
from ..ops.attention_scores import scores_mxu as _scores_mxu
from .nn import dropout as _dropout
from .ops import apply_activation

NEG_INF = -1e9  # the additive-mask convention (finite to stay bf16-safe)


def scaled_dot_product_attention(q, k, v,
                                 attn_mask: Optional[torch.Tensor] = None,
                                 causal: bool = False,
                                 dropout_rate: float = 0.0,
                                 use_flash: Optional[bool] = None):
    """SDPA over [batch, heads, seq, head_dim] tensors.

    ``attn_mask``: additive mask broadcastable to [b, h, sq, sk] (0 keep,
    NEG_INF drop). ``causal`` adds the bottom-right aligned
    ``tril(k=sk-sq)`` mask. The flash kernel has no dropout, so it is
    taken when ``use_flash`` and dropout is a no-op (rate 0, or not
    :func:`framework.in_training`), the JAX package's routing rule
    (attention.py:50); else the dense path: f32 scores
    (:func:`ops.attention_scores.scores_mxu`), f32 softmax,
    ``upscale_in_train`` dropout on the probabilities in training, then
    the probabilities in v's dtype times v.
    """
    training = in_training()
    if use_flash and (dropout_rate == 0.0 or not training):
        from ..ops.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=causal, attn_mask=attn_mask)

    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = _scores_mxu(q, k, scale)
    if attn_mask is not None:
        logits = logits + attn_mask
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        cm = torch.ones((sq, sk), dtype=torch.bool,
                        device=logits.device).tril(sk - sq)
        logits = logits.masked_fill(~cm, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0:
        probs = _dropout(probs, dropout_rate, is_test=not training,
                         dropout_implementation="upscale_in_train")
    return torch.matmul(probs.to(v.dtype), v)


def multi_head_attention(queries, keys=None, values=None, num_heads: int = 8,
                         d_model: Optional[int] = None,
                         attn_mask: Optional[torch.Tensor] = None,
                         causal: bool = False, dropout_rate: float = 0.0,
                         cache: Optional[dict] = None,
                         use_flash: Optional[bool] = None, fuse_qkv: bool = False,
                         name: Optional[str] = None):
    """Multi-head attention over [batch, seq, d_model] inputs
    (attention.py:70).

    - ``keys`` None is self-attention; ``values`` None reads the keys.
    - ``fuse_qkv``: self-attention projects Q, K and V in one product
      against a ``[d_in, 3, d_model]`` ``qkv_proj``; cross-attention keeps
      ``q_proj`` and projects K and V against a ``[d_in, 2, d_model]``
      ``kv_proj``. Each sub-projection keeps its own Xavier fan. The heads
      are strided views of the one product, so they reach the flash
      kernel without a copy.
    - ``cache`` ``{"k", "v": [b, h, T, hd], "index"}``: incremental
      decoding. This step's K/V are written at ``index`` and the step
      attends to the cache positions ``<= index`` (not causally). The
      JAX package updates the cache functionally; here the writes go
      into the given tensors IN PLACE (the decode loop owns them; a copy
      a step would move the whole cache), and the returned cache holds
      the same tensors with ``index`` advanced. ``index`` is a Python
      int, or a 0-dim integer tensor on the cache's device (the JAX
      package's traced index) that is never read to the host, so a
      captured step can hold it; the advanced index is then a tensor
      too. Returns ``(out, cache)``.
    """
    helper = LayerHelper("mha", name=name)
    self_attn = keys is None
    keys = queries if keys is None else keys
    values = keys if values is None else values
    d_model = d_model or queries.shape[-1]
    head_dim = d_model // num_heads
    cd = compute_dtype()

    def proj(x, pname, out_dim):
        w = helper.create_parameter(f"{pname}/w", (x.shape[-1], out_dim), torch.float32,
                                    initializer=init.Xavier())
        b = helper.create_parameter(f"{pname}/b", (out_dim,), torch.float32,
                                    initializer=init.Constant(0.0))
        x, w = cast_compute(cd, x, w)
        return torch.matmul(x, w) + b.to(x.dtype)

    def fused_proj(x, pname, n_out):
        # per-sub-projection Xavier fans: the variance of the unfused layout
        w = helper.create_parameter(
            f"{pname}/w", (x.shape[-1], n_out, d_model), torch.float32,
            initializer=init.Xavier(fan_in=x.shape[-1], fan_out=d_model))
        b = helper.create_parameter(f"{pname}/b", (n_out, d_model), torch.float32,
                                    initializer=init.Constant(0.0))
        x, w = cast_compute(cd, x, w)
        # einsum "bsd,dke->bske" as one [d, n·d_model] product
        out = torch.matmul(x, w.reshape(w.shape[0], -1)).view(
            *x.shape[:-1], n_out, d_model) + b.to(x.dtype)
        return tuple(out[:, :, i] for i in range(n_out))

    if fuse_qkv and self_attn:
        enforce(values is queries,
                "fuse_qkv self-attention reads Q/K/V from the same "
                "source; a distinct values tensor would be silently "
                "dropped — pass fuse_qkv=False")
        q, k, v = fused_proj(queries, "qkv_proj", 3)
    elif fuse_qkv:
        enforce(values is keys,
                "fuse_qkv cross-attention requires values to be keys "
                "(or omitted); pass fuse_qkv=False for distinct K/V "
                "sources")
        q = proj(queries, "q_proj", d_model)
        k, v = fused_proj(keys, "kv_proj", 2)
    else:
        q = proj(queries, "q_proj", d_model)
        k = proj(keys, "k_proj", d_model)
        v = proj(values, "v_proj", d_model)

    def split_heads(x):
        b, s, _ = x.shape
        return x.reshape(b, s, num_heads, head_dim).transpose(1, 2)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)

    new_cache = None
    if cache is not None:
        idx = cache["index"]
        ck, cv = cache["k"], cache["v"]
        if isinstance(idx, torch.Tensor):
            # a device index: written by index, never read to the host
            pos = idx.reshape(1).long() + torch.arange(k.shape[2], device=ck.device)
            ck.index_copy_(2, pos, k.to(ck.dtype))
            cv.index_copy_(2, pos, v.to(cv.dtype))
        else:
            idx = int(idx)
            ck[:, :, idx:idx + k.shape[2]] = k.to(ck.dtype)
            cv[:, :, idx:idx + v.shape[2]] = v.to(cv.dtype)
        k, v = ck, cv
        new_cache = {"k": ck, "v": cv, "index": idx + q.shape[2]}
        # mask out the cache positions beyond the current step
        kpos = torch.arange(ck.shape[2], device=ck.device)
        step_mask = torch.where(kpos <= idx, 0.0, NEG_INF).to(torch.float32)
        step_mask = step_mask[None, None, None, :]
        attn_mask = step_mask if attn_mask is None else attn_mask + step_mask
        causal = False

    out = scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, causal=causal,
                                       dropout_rate=dropout_rate, use_flash=use_flash)
    b, h, s, hd = out.shape
    out = out.transpose(1, 2).reshape(b, s, h * hd)
    out = proj(out, "out_proj", d_model)
    if cache is not None:
        return out, new_cache
    return out


def ffn(x, d_inner: int, dropout_rate: float = 0.0, activation: str = "relu",
        name: Optional[str] = None):
    """Position-wise feed-forward (attention.py:183): ``ffn_in`` [d,
    d_inner], the activation, ``upscale_in_train`` dropout, ``ffn_out``
    [d_inner, d]; f32 Xavier weights and zero biases in the compute
    dtype."""
    helper = LayerHelper("ffn", name=name)
    d_model = x.shape[-1]
    w1 = helper.create_parameter("ffn_in/w", (d_model, d_inner), torch.float32,
                                 initializer=init.Xavier())
    b1 = helper.create_parameter("ffn_in/b", (d_inner,), torch.float32,
                                 initializer=init.Constant(0.0))
    w2 = helper.create_parameter("ffn_out/w", (d_inner, d_model), torch.float32,
                                 initializer=init.Xavier())
    b2 = helper.create_parameter("ffn_out/b", (d_model,), torch.float32,
                                 initializer=init.Constant(0.0))
    x, w1, w2 = cast_compute(compute_dtype(), x, w1, w2)
    h = apply_activation(torch.matmul(x, w1) + b1.to(x.dtype), activation)
    if dropout_rate:
        h = _dropout(h, dropout_rate, dropout_implementation="upscale_in_train")
    return torch.matmul(h, w2) + b2.to(x.dtype)


def positional_encoding(seq_len: int, d_model: int, dtype=torch.float32,
                        device=None):
    """Sinusoidal position table [seq_len, d_model] (the reference
    transformer's position_encoding_init)."""
    pos = torch.arange(seq_len, device=device, dtype=torch.float32)[:, None]
    i = torch.arange(d_model // 2, device=device, dtype=torch.float32)[None, :]
    # the base filled in on the device: a copy from the host could not be
    # captured in a CUDA graph of the step
    base = torch.full((), 10000.0, dtype=torch.float32, device=device)
    angle = pos / torch.pow(base, 2 * i / d_model)
    pe = torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)
    return pe.to(dtype)


def padding_mask(ids: torch.Tensor, pad_id: int = 0) -> torch.Tensor:
    """[b, s] ids -> additive f32 mask [b, 1, 1, s]."""
    return torch.where(ids == pad_id, NEG_INF, 0.0).to(torch.float32)[:, None, None, :]


__all__ = ["NEG_INF", "ffn", "multi_head_attention", "padding_mask",
           "positional_encoding", "scaled_dot_product_attention"]
