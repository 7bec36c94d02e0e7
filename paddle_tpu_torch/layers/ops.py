"""Elementwise and activation ops (counterpart of ``paddle_tpu.layers.ops``).

Each keeps the JAX package's form and constants: ``gelu(approximate=True)``
is the tanh form, ``softplus`` is ``logaddexp(x, 0)`` (no threshold),
``stanh``, ``soft_relu`` and ``brelu`` keep their defaults. ``ACTIVATIONS``
is the table of names ``act=`` accepts on fc and the other layers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def logsigmoid(x, name=None):
    return F.logsigmoid(x)


def exp(x, name=None):
    return torch.exp(x)


def tanh(x, name=None):
    return torch.tanh(x)


def tanh_shrink(x, name=None):
    return x - torch.tanh(x)


def softshrink(x, alpha=0.5, name=None):
    return torch.where(x > alpha, x - alpha, torch.where(x < -alpha, x + alpha, 0.0))


def sqrt(x, name=None):
    return torch.sqrt(x)


def rsqrt(x, name=None):
    return torch.rsqrt(x)


def abs(x, name=None):
    return torch.abs(x)


def ceil(x, name=None):
    return torch.ceil(x)


def floor(x, name=None):
    return torch.floor(x)


def cos(x, name=None):
    return torch.cos(x)


def sin(x, name=None):
    return torch.sin(x)


def round(x, name=None):
    return torch.round(x)  # half to even, as jnp.round


def reciprocal(x, name=None):
    return 1.0 / x


def square(x, name=None):
    return torch.square(x)


def log(x, name=None):
    return torch.log(x)


def relu(x, name=None):
    return torch.relu(x)


def relu6(x, threshold=6.0, name=None):
    return torch.clamp(x, 0.0, threshold)


def leaky_relu(x, alpha=0.02, name=None):
    return torch.where(x >= 0, x, alpha * x)


def elu(x, alpha=1.0, name=None):
    return torch.where(x > 0, x, alpha * (torch.exp(x) - 1.0))


def selu(x, name=None):
    return F.selu(x)


def gelu(x, approximate=True, name=None):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return torch.clamp(x, t_min, t_max)


def soft_relu(x, threshold=40.0, name=None):
    return torch.log1p(torch.exp(torch.clamp(x, -threshold, threshold)))


def softplus(x, name=None):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def softsign(x, name=None):
    return x / (1.0 + torch.abs(x))


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * x)


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hard_swish(x, threshold=6.0, scale=6.0, offset=3.0, name=None):
    return x * torch.clamp(x + offset, 0.0, threshold) / scale


def swish(x, beta=1.0, name=None):
    return x * torch.sigmoid(beta * x)


def mish(x, name=None):
    return x * torch.tanh(softplus(x))


def thresholded_relu(x, threshold=1.0, name=None):
    return torch.where(x > threshold, x, 0.0)


def pow(x, factor=1.0, name=None):
    return torch.pow(x, factor)


def erf(x, name=None):
    return torch.erf(x)


def maxout(x, groups, axis=1, name=None):
    """maxout_op.cc analog: out[:, k] = max over the ``groups``
    consecutive channels k*groups..(k+1)*groups; C_out = C/groups."""
    shape = list(x.shape)
    c = shape[axis]
    if c % groups != 0:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    new_shape = shape[:axis] + [c // groups, groups] + shape[axis + 1:]
    return torch.amax(x.reshape(new_shape), dim=axis + 1)


# names usable as ``act=`` on fc/conv2d/... (LayerHelper.append_activation)
ACTIVATIONS = {
    None: lambda x: x,
    "relu": relu,
    "relu6": relu6,
    "leaky_relu": leaky_relu,
    "sigmoid": sigmoid,
    "tanh": tanh,
    "elu": elu,
    "selu": selu,
    "gelu": gelu,
    "softplus": softplus,
    "softsign": softsign,
    "stanh": stanh,
    "hard_sigmoid": hard_sigmoid,
    "swish": swish,
    "mish": mish,
    "exp": exp,
    "square": square,
    "sqrt": sqrt,
    "abs": abs,
    "brelu": brelu,
    "soft_relu": soft_relu,
}


def apply_activation(x, act):
    if callable(act):
        return act(x)
    if act not in ACTIVATIONS:
        raise ValueError(f"Unknown activation {act!r}; known: "
                         f"{sorted(k for k in ACTIVATIONS if k)}")
    return ACTIVATIONS[act](x)


__all__ = [
    "ACTIVATIONS", "abs", "apply_activation", "brelu", "ceil", "cos", "elu", "erf",
    "exp", "floor", "gelu", "hard_sigmoid", "hard_swish", "leaky_relu", "log",
    "logsigmoid", "maxout", "mish", "pow", "reciprocal", "relu", "relu6", "round",
    "rsqrt", "selu", "sigmoid", "sin", "soft_relu", "softplus", "softshrink",
    "softsign", "sqrt", "square", "stanh", "swish", "tanh", "tanh_shrink",
    "thresholded_relu",
]
