"""Attention layers (counterpart of ``paddle_tpu.layers.attention``).

``multi_head_attention`` and ``ffn`` create parameters through
``framework.build`` and come with the slice that ports it (ROADMAP).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.errors import NotYetPorted
from ..ops.attention_scores import scores_mxu as _scores_mxu

NEG_INF = -1e9  # the additive-mask convention (finite to stay bf16-safe)


def scaled_dot_product_attention(q, k, v,
                                 attn_mask: Optional[torch.Tensor] = None,
                                 causal: bool = False,
                                 dropout_rate: float = 0.0,
                                 use_flash: Optional[bool] = None,
                                 training: bool = False):
    """SDPA over [batch, heads, seq, head_dim] tensors.

    ``attn_mask``: additive mask broadcastable to [b, h, sq, sk] (0 keep,
    NEG_INF drop). ``causal`` adds the bottom-right aligned
    ``tril(k=sk-sq)`` mask. The flash kernel has no dropout, so it is
    taken when ``use_flash`` and dropout is a no-op (rate 0, or not
    ``training``), the JAX package's routing rule. Training-time
    dropout comes with the Transformer/BERT slice (ROADMAP slice 6).
    """
    if use_flash and (dropout_rate == 0.0 or not training):
        from ..ops.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=causal, attn_mask=attn_mask)
    if dropout_rate > 0.0 and training:
        raise NotYetPorted("attention dropout in training (slice 6, ROADMAP "
                           "queue 1)")

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
    return torch.matmul(probs.to(v.dtype), v)


def positional_encoding(seq_len: int, d_model: int, dtype=torch.float32,
                        device=None):
    """Sinusoidal position table [seq_len, d_model] (the reference
    transformer's position_encoding_init)."""
    pos = torch.arange(seq_len, device=device, dtype=torch.float32)[:, None]
    i = torch.arange(d_model // 2, device=device, dtype=torch.float32)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * i / d_model)
    pe = torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)
    return pe.to(dtype)


def padding_mask(ids: torch.Tensor, pad_id: int = 0) -> torch.Tensor:
    """[b, s] ids -> additive f32 mask [b, 1, 1, s]."""
    return torch.where(ids == pad_id, NEG_INF, 0.0).to(torch.float32)[:, None, None, :]


__all__ = ["NEG_INF", "padding_mask", "positional_encoding",
           "scaled_dot_product_attention"]
