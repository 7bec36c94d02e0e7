"""Shared causal-LM output head (counterpart of
``paddle_tpu.models.lm_head``): the vocab projection and next-token CE
over non-pad labels, with the chunked logits-free CE (``ops/fused_ce.py``)
as the production path. The caller owns the ``lm_head_N/w`` parameter
and passes it in (the port has no ``LayerHelper`` yet)."""

from __future__ import annotations

import torch

from ..ops.fused_ce import chunked_softmax_cross_entropy


def lm_head_loss(x: torch.Tensor, labels: torch.Tensor, w: torch.Tensor,
                 fused_ce: bool, ce_chunk: int, pad_id: int = 0):
    """(loss, token_count) for hidden states x [b, t, d] against labels
    [b, t] and the head weight w [d, vocab]: the mean CE over labels that
    are not ``pad_id``, token_count = max(non-pad count, 1) (f32)."""
    lab = labels.long()
    nonpad = (labels != pad_id).float()
    token_count = nonpad.sum().clamp_min(1.0)
    b, t, d = x.shape
    if fused_ce:
        ce = chunked_softmax_cross_entropy(
            x.reshape(b * t, d), w, None, lab.reshape(-1), 0.0,
            ce_chunk).reshape(b, t)
    else:
        # jnp.matmul promotes mixed dtypes (bf16 x, f32 w -> f32);
        # torch.matmul does not, so promote explicitly
        dt = torch.promote_types(x.dtype, w.dtype)
        logits = torch.matmul(x.to(dt), w.to(dt))
        logp = torch.log_softmax(logits.float(), dim=-1)
        ce = -torch.gather(logp, -1, lab[..., None])[..., 0]
    loss = (ce * nonpad).sum() / token_count
    return loss, token_count


__all__ = ["lm_head_loss"]
