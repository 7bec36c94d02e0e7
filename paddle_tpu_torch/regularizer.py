"""Weight-decay regularizers (counterpart of ``paddle_tpu.regularizer``):
pure ``(param, grad) -> grad`` transforms the optimizer applies in its
update. A regularizer set on a parameter's ``ParamAttr`` wins over the
optimizer's own (regularizer.py:36's precedence)."""

from __future__ import annotations

import torch


class WeightDecayRegularizer:
    def apply(self, param, grad):
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    """L2 weight decay: grad += coeff * param (L2DecayRegularizer)."""

    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = float(regularization_coeff)

    def apply(self, param, grad):
        return grad + self.coeff * param


class L1Decay(WeightDecayRegularizer):
    """L1 decay: grad += coeff * sign(param) (L1DecayRegularizer)."""

    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = float(regularization_coeff)

    def apply(self, param, grad):
        return grad + self.coeff * torch.sign(param)


# fluid aliases
L1DecayRegularizer = L1Decay
L2DecayRegularizer = L2Decay
