"""Parameter initializers (counterpart of ``paddle_tpu.initializer``).

Each initializer is a callable ``(generator, shape, dtype) -> Tensor``
that draws from an explicit ``torch.Generator`` — the port's stand-in
for a ``jax.random`` key. The draws land on the generator's device. The
fans and limits are the JAX package's; the random streams are not (Philox
or the CPU's Mersenne Twister against threefry), so a parity test
initialises in ``paddle_tpu`` and carries the values across, and the
draws themselves are checked by their statistics.

A parameter draws from its own generator, :func:`param_generator`,
seeded from the program's seed and the parameter's full name, as the JAX
package folds the sha256 of the name into its key.
"""

from __future__ import annotations

import hashlib
import math
from typing import Optional, Sequence

import numpy as np
import torch

from .core.dtypes import convert_dtype


def mix_seed(seed: int, tag) -> int:
    """A 32-bit seed from ``seed`` and ``tag`` (a name or a counter): the
    first four bytes of the sha256 of ``"{seed}/{tag}"``. The CPU generator
    keeps only 32 bits of its seed, so the two are hashed together rather
    than packed side by side (``seed * 2**32 + h`` would draw the same
    numbers for every seed)."""
    h = hashlib.sha256(f"{seed}/{tag}".encode()).digest()
    return int.from_bytes(h[:4], "little")


def param_generator(seed: int, name: str) -> torch.Generator:
    """The CPU generator a parameter named ``name`` draws its initial
    values from: the same values on every device and whatever other
    parameters the program has."""
    return torch.Generator().manual_seed(mix_seed(seed, name))


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


class TruncatedNormal(Initializer):
    """A standard normal truncated to [-2, 2], then ``loc + scale·x``, as
    ``jax.random.truncated_normal`` draws it (here by inverting the CDF
    at uniform draws between the bounds' CDF values)."""

    def __init__(self, loc: float = 0.0, scale: float = 1.0):
        self.loc, self.scale = loc, scale

    def __call__(self, generator, shape, dtype):
        lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0))) for b in (-2.0, 2.0))
        u = torch.empty(tuple(shape), dtype=torch.float64, device=generator.device)
        u.uniform_(lo, hi, generator=generator)
        x = (torch.special.ndtri(u).clamp(-2.0, 2.0) * self.scale + self.loc)
        return x.to(convert_dtype(dtype))


class MSRA(Initializer):
    """He/Kaiming init (initializer.py MSRAInitializer): uniform within
    ±sqrt(6/fan_in), or normal with std sqrt(2/fan_in)."""

    def __init__(self, uniform: bool = True, fan_in: Optional[int] = None):
        self.uniform, self.fan_in = uniform, fan_in

    def __call__(self, generator, shape, dtype):
        fi, _ = _fan_in_out(shape)
        fi = self.fan_in or fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            return Uniform(-limit, limit)(generator, shape, dtype)
        return Normal(0.0, math.sqrt(2.0 / fi))(generator, shape, dtype)


class Bilinear(Initializer):
    """Bilinear upsampling filter for a transposed conv (initializer.py
    BilinearInitializer): every [out, in] slice of the 4-D filter holds
    the same bilinear kernel. Draws nothing."""

    def __call__(self, generator, shape, dtype):
        if len(shape) != 4:
            raise ValueError("Bilinear initializer expects a 4-D filter shape")
        weight = np.zeros(shape, dtype=np.float32)
        kh, kw = shape[2], shape[3]
        f_h, f_w = math.ceil(kh / 2.0), math.ceil(kw / 2.0)
        c_h, c_w = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h), (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        for i in range(kh):
            for j in range(kw):
                weight[:, :, i, j] = (1 - abs(i / f_h - c_h)) * (1 - abs(j / f_w - c_w))
        return torch.from_numpy(weight).to(generator.device, convert_dtype(dtype))


class NumpyArrayInitializer(Initializer):
    """The given array, cast to the parameter's dtype; its shape must be
    the parameter's."""

    def __init__(self, value: np.ndarray):
        self.value = np.asarray(value)

    def __call__(self, generator, shape, dtype):
        if tuple(self.value.shape) != tuple(shape):
            raise ValueError(f"NumpyArrayInitializer shape {self.value.shape} != {shape}")
        return torch.from_numpy(np.array(self.value)).to(generator.device,
                                                         convert_dtype(dtype))


# fluid-style aliases
ConstantInitializer = Constant
UniformInitializer = Uniform
NormalInitializer = Normal
TruncatedNormalInitializer = TruncatedNormal
XavierInitializer = Xavier
MSRAInitializer = MSRA
BilinearInitializer = Bilinear
