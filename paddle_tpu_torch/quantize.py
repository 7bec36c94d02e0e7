"""Quantization (counterpart of ``paddle_tpu.quantize``): so far only the
``int8_serving`` switch, so that a layer asked to serve in int8 refuses
instead of quietly serving in float.

The JAX package's dynamic int8 matmul and conv, its fake-quant ops and
its params rewrites (quantize/dequantize, bf16 casting, batch-norm
folding) come with the data and serving extras (ROADMAP queue 1, item
23); under ``int8_serving()`` the port's ``fc`` and ``conv2d`` raise
:class:`NotYetPorted`.
"""

from __future__ import annotations

import contextlib
import threading

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


def refuse_int8(layer: str) -> None:
    """Raise :class:`NotYetPorted` when ``layer`` runs under
    :func:`int8_serving`."""
    if in_int8_serving():
        raise NotYetPorted(f"{layer} under quantize.int8_serving(): dynamic int8 "
                           "serving (ROADMAP queue 1, item 23)")


__all__ = ["in_int8_serving", "int8_serving", "refuse_int8"]
