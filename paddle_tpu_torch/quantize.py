"""Quantization (counterpart of ``paddle_tpu.quantize``): so far the
``int8_serving`` switch, so that a layer asked to serve in int8 refuses
instead of quietly serving in float, and the symmetric abs-max quantizer
:func:`_quant_dynamic` that the int8 KV cache uses
(``layers/stacked.quantize_kv``).

The JAX package's dynamic int8 matmul and conv, its fake-quant ops and
its params rewrites (quantize/dequantize, bf16 casting, batch-norm
folding) come with the data and serving extras (ROADMAP queue 1, item
23); under ``int8_serving()`` the port's ``fc`` and ``conv2d`` raise
:class:`NotYetPorted`.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from .core.errors import NotYetPorted

_int8_mode = threading.local()


@contextlib.contextmanager
def int8_serving(enabled: bool = True):
    """While active, the fc/conv2d layers of programs run in the block
    would serve as dynamic int8 (the JAX package's switch)."""
    old = getattr(_int8_mode, "on", False)
    _int8_mode.on = bool(enabled)
    try:
        yield
    finally:
        _int8_mode.on = old


def in_int8_serving() -> bool:
    return getattr(_int8_mode, "on", False)


def _quant_dynamic(x: torch.Tensor, axes, qmax: float = 127.0):
    """Symmetric abs-max quantization over ``axes`` -> (int8, f32 scale).

    The JAX function's order of operations, so the int8 values are
    bit-equal to it: the abs-max in ``x``'s dtype floored at 1e-8, cast
    to f32, then ``round(x.f32 / scale * qmax)`` clipped to ±qmax
    (``torch.round`` rounds half to even, as ``jnp.round`` does)."""
    axes = tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)
    scale = torch.clamp_min(torch.amax(torch.abs(x), dim=axes, keepdim=True), 1e-8)
    scale = scale.float()
    q = torch.clamp(torch.round(x.float() / scale * qmax), -qmax, qmax).to(torch.int8)
    return q, scale


def refuse_int8(layer: str) -> None:
    """Raise :class:`NotYetPorted` when ``layer`` runs under
    :func:`int8_serving`."""
    if in_int8_serving():
        raise NotYetPorted(f"{layer} under quantize.int8_serving(): dynamic int8 "
                           "serving (ROADMAP queue 1, item 23 (c))")


__all__ = ["in_int8_serving", "int8_serving", "refuse_int8"]
