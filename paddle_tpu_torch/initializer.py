"""Parameter initializers (counterpart of ``paddle_tpu.initializer``).

Each initializer is a callable ``(generator, shape, dtype) -> Tensor``
that draws from an explicit ``torch.Generator`` — the port's stand-in
for a ``jax.random`` key. The draws land on the generator's device. The
fans and limits are the JAX package's; the random streams are not (Philox
or the CPU's Mersenne Twister against threefry), so a parity test
initialises in ``paddle_tpu`` and carries the values across.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from .core.dtypes import convert_dtype


def _fan_in_out(shape: Sequence[int]):
    # the JAX package's fans: for [out_c, in_c, k...] filters the
    # receptive field multiplies in
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    fan_in = shape[1] * receptive if len(shape) > 2 else shape[0]
    fan_out = shape[0] * receptive if len(shape) > 2 else shape[1]
    return fan_in, fan_out


class Initializer:
    def __call__(self, generator: torch.Generator, shape, dtype) -> torch.Tensor:
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, generator, shape, dtype):
        return torch.full(tuple(shape), self.value, dtype=convert_dtype(dtype),
                          device=generator.device)


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, generator, shape, dtype):
        x = torch.empty(tuple(shape), dtype=torch.float32,
                        device=generator.device)
        x.uniform_(self.low, self.high, generator=generator)
        return x.to(convert_dtype(dtype))


class Normal(Initializer):
    def __init__(self, loc: float = 0.0, scale: float = 1.0):
        self.loc, self.scale = loc, scale

    def __call__(self, generator, shape, dtype):
        x = torch.empty(tuple(shape), dtype=torch.float32,
                        device=generator.device)
        x.normal_(self.loc, self.scale, generator=generator)
        return x.to(convert_dtype(dtype))


class Xavier(Initializer):
    """Glorot init (initializer.py XavierInitializer)."""

    def __init__(self, uniform: bool = True, fan_in: Optional[int] = None,
                 fan_out: Optional[int] = None):
        self.uniform, self.fan_in, self.fan_out = uniform, fan_in, fan_out

    def __call__(self, generator, shape, dtype):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            return Uniform(-limit, limit)(generator, shape, dtype)
        std = math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(generator, shape, dtype)
