"""QKᵀ scores for the dense attention path (counterpart of
``paddle_tpu.ops.attention_scores``): a ``torch.autograd.Function`` with
the JAX package's custom VJP.

The forward is QKᵀ·scale with f32 products, f32 accumulation and an f32
output. The backward (``_scores_bwd``, attention_scores.py:37-44) folds
the scale into the f32 cotangent and rounds it to the input dtype before
both backward products, dq = ct·k and dk = ctᵀ·q, each accumulated in f32
and returned in the input dtype: the rounding the flash kernels apply to
dS. Autograd of the f32 forward would instead multiply the f32 cotangent
by the widened operands, and bf16 grads would round differently from the
reference's. For f32 inputs the two agree.

Both directions run ``fused_ce._mm_f32``: two bf16 CUDA operands go to
cuBLAS as they are with an f32 output; anything else is widened to f32
first, which is exact for bf16 (its products fit in f32).
"""

from __future__ import annotations

import torch

from . import _dtensor as _dt
from .fused_ce import _mm_f32


class _ScoresMxu(torch.autograd.Function):
    """``scores_mxu``'s custom VJP (attention_scores.py:25-47)."""

    @staticmethod
    def forward(ctx, q, k, scale):
        ctx.save_for_backward(q, k)
        ctx.scale = scale
        return _mm_f32(q, k.transpose(-1, -2)) * scale

    @staticmethod
    def backward(ctx, ct):
        q, k = ctx.saved_tensors
        ct = (ct * ctx.scale).to(q.dtype)
        dq = _mm_f32(ct, k).to(q.dtype)
        dk = _mm_f32(ct.transpose(-1, -2), q).to(k.dtype)
        return dq, dk, None


def scores_mxu(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """QKᵀ·scale over [b, h, s, d]: f32 out, f32 accumulation, and the
    input-dtype backward products of the JAX package's custom VJP.
    DTensors run on their local shards with a batch or head shard kept."""
    if _dt.is_dtensor(q):
        pl = _dt.kept_placements(q, (0, 1))
        out = _ScoresMxu.apply(_dt.local_at(q, q, pl), _dt.local_at(k, q, pl), float(scale))
        return _dt.wrap(out, q, pl)
    return _ScoresMxu.apply(q, k, float(scale))


__all__ = ["scores_mxu"]
