"""Metrics (counterpart of the in-graph part of ``paddle_tpu.metrics``):
``accuracy``. The host-side accumulators come with the slices whose
models report them."""

from __future__ import annotations

import torch


def accuracy(input, label, k: int = 1):
    """Per-batch top-k accuracy (accuracy_op.cc analog), through
    ``torch.topk``. Where logits tie at the k-th place, ``torch.topk`` and
    ``jax.lax.top_k`` may keep different indices, so the two agree on
    logits without ties."""
    lab = label.long()
    if lab.dim() == input.dim() and lab.shape[-1] == 1:
        lab = lab[..., 0]
    idx = torch.topk(input, k, dim=-1).indices
    correct = torch.any(idx == lab.unsqueeze(-1), dim=-1)
    return correct.float().mean()


__all__ = ["accuracy"]
