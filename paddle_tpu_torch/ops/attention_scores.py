"""QKᵀ scores for the dense attention path (counterpart of
``paddle_tpu.ops.attention_scores``). The JAX version is a custom VJP
whose forward is one f32-accumulating einsum; the port serves inference
only so far, so it is that forward in plain PyTorch. bf16 operands are
widened to f32 first: their products are exact in f32, as on the MXU."""

from __future__ import annotations

import torch


def scores_mxu(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """QKᵀ·scale over [b, h, s, d], f32 out, f32 accumulation."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
