"""Gradient clipping (counterpart of ``paddle_tpu.clip``): each clip is a
pure transform over the ``{name: grad}`` dict that the optimizer applies
after regularization. Norms are taken in f32 on the device; nothing here
reads a value back to the host."""

from __future__ import annotations

from typing import Dict

import torch


class GradientClipBase:
    def __call__(self, grads: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor]):
        raise NotImplementedError


class GradientClipByValue(GradientClipBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, grads, params):
        return {k: torch.clamp(g, self.min, self.max) for k, g in grads.items()}


class GradientClipByNorm(GradientClipBase):
    """Per-tensor L2-norm clip (clip_by_norm_op analog)."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def __call__(self, grads, params):
        out = {}
        for k, g in grads.items():
            norm = torch.sqrt(torch.sum(torch.square(g.float())))
            scale = torch.clamp(self.clip_norm / torch.clamp_min(norm, 1e-12), max=1.0)
            out[k] = (g.float() * scale).to(g.dtype)
        return out


class GradientClipByGlobalNorm(GradientClipBase):
    """Global-norm clip across all grads (clip.py GradientClipByGlobalNorm)."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def __call__(self, grads, params):
        gnorm = global_norm(list(grads.values()))
        scale = self.clip_norm / torch.clamp_min(gnorm, self.clip_norm)
        return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}


def global_norm(tensors):
    """sqrt of the sum of squares of every element of ``tensors``, in f32."""
    if not tensors:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(torch.stack([torch.sum(torch.square(t.float())) for t in tensors]).sum())
