"""Feed wire formats: the narrower dtype a feed field crosses a link in,
and the decode that recovers its logical value on the device
(counterpart of ``paddle_tpu.data.wire``, with the same encodings byte
for byte).

A :class:`WireSpec` declares, per feed field, a WIRE dtype for the
transfer plus the decode back to the logical dtype:

- ``WireSpec.quantize("uint8", scale, zero_point)`` — affine
  quantization: the host encodes ``round(x/scale + zero_point)`` clipped
  to the wire dtype's range, the device decodes ``(w - zero_point) *
  scale``. A float32 image feed crosses as uint8, 4× fewer bytes.
- ``WireSpec.cast("bfloat16")`` — the host rounds to bf16 (or f16), the
  device casts back: 2× fewer bytes, ~3 decimal digits kept.
- ``WireSpec.passthrough()`` — an explicit no-op.

The host side (:meth:`WireSpec.encode`, :meth:`FeedWire.encode`) is
numpy. numpy has no bfloat16 of its own, so a bf16 wire field is carried
on the host as its 16-bit patterns (``uint16``, :attr:`WireSpec.wire_np`),
rounded from float32 to nearest with ties to even (a NaN becomes the
quiet NaN of its sign), the rounding ``ml_dtypes`` applies, so the bytes equal the JAX
package's. The device side (:meth:`WireSpec.decode`,
:meth:`FeedWire.decode`) is torch: it takes tensors (or numpy arrays,
which it moves into tensors) and returns tensors.

The serving fleet narrows SUBMIT payloads with these specs
(``fleet.remote.pack_tree(wire=...)``). ``Trainer(feed_wire=)`` and
``fit(feed_wire=)`` come with ROADMAP item 23 (c).

When NOT to quantize: label/id/index fields. Integer identities must
cross the link exactly: ``WireSpec.quantize`` and ``WireSpec.cast``
refuse a non-float decode dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.dtypes import convert_dtype, dtype_name
from ..core.errors import enforce


def _host_dtype(name: str) -> np.dtype:
    """The numpy dtype that holds a wire dtype's bytes on the host: the
    dtype itself, or ``uint16`` for bfloat16's bit patterns."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def bf16_bits(arr) -> np.ndarray:
    """``arr`` rounded to bfloat16 (from float32, to nearest, ties to
    even; a NaN becomes the quiet NaN of its sign), as its ``uint16`` bit
    patterns."""
    bits = np.ascontiguousarray(np.asarray(arr), dtype=np.float32).view(np.uint32)
    rounded = (bits + (np.uint32(0x7FFF) + ((bits >> 16) & 1))) >> 16
    quiet_nan = ((bits >> 16) & np.uint32(0x8000)) | np.uint32(0x7FC0)
    nan = (bits & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    return np.where(nan, quiet_nan, rounded).astype(np.uint16)


def bf16_tensor(bits) -> torch.Tensor:
    """A bfloat16 tensor over ``uint16`` bit patterns (no rounding)."""
    a = np.ascontiguousarray(np.asarray(bits, dtype=np.uint16))
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)


def _numpy_floating(dt: torch.dtype) -> bool:
    """The JAX package's ``np.issubdtype(dt, np.floating)`` test of a
    decode dtype: bfloat16 (an ``ml_dtypes`` type, not a numpy floating
    subtype) is refused there, so it is refused here too."""
    return dt.is_floating_point and dt != torch.bfloat16


@dataclasses.dataclass(frozen=True)
class WireSpec:
    """Per-field wire format: how one feed field crosses the link
    (``wire_dtype``) and how the device recovers the logical value
    (``decode_dtype`` plus the affine ``scale``/``zero_point`` of a
    quantized field). Construct through :meth:`quantize`, :meth:`cast` or
    :meth:`passthrough`, which validate."""

    kind: str
    wire_dtype: str = "float32"
    decode_dtype: str = "float32"
    scale: float = 1.0
    zero_point: float = 0.0

    # -- constructors -------------------------------------------------------
    @classmethod
    def passthrough(cls) -> "WireSpec":
        return cls(kind="passthrough")

    @classmethod
    def cast(cls, wire_dtype: str = "bfloat16",
             decode_dtype: str = "float32") -> "WireSpec":
        wd, dd = convert_dtype(wire_dtype), convert_dtype(decode_dtype)
        enforce(_numpy_floating(dd) or dd == wd,
                f"WireSpec.cast: decode dtype {decode_dtype!r} must be "
                "floating (cast wire formats are for float feeds)")
        enforce(wd != dd,
                f"WireSpec.cast: wire dtype {wire_dtype!r} equals the decode "
                "dtype — a no-op cast; use passthrough() to document that")
        enforce(wd.itemsize <= dd.itemsize,
                f"WireSpec.cast: wire dtype {wire_dtype!r} is wider than "
                f"decode dtype {decode_dtype!r} — that GROWS the transfer")
        return cls(kind="cast", wire_dtype=dtype_name(wd), decode_dtype=dtype_name(dd))

    @classmethod
    def quantize(cls, wire_dtype: str = "uint8", scale: float = 1.0,
                 zero_point: float = 0.0,
                 decode_dtype: str = "float32") -> "WireSpec":
        wd, dd = convert_dtype(wire_dtype), convert_dtype(decode_dtype)
        enforce(not wd.is_floating_point and not wd.is_complex and wd != torch.bool,
                f"WireSpec.quantize: wire dtype {wire_dtype!r} must be an "
                "integer type (uint8/int8/...)")
        enforce(_numpy_floating(dd),
                f"WireSpec.quantize: decode dtype {decode_dtype!r} must be "
                "floating — never quantize label/id/index fields (integer "
                "identities must cross the link exactly)")
        enforce(float(scale) > 0.0,
                f"WireSpec.quantize: scale must be > 0, got {scale}")
        return cls(kind="quantize", wire_dtype=dtype_name(wd),
                   decode_dtype=dtype_name(dd), scale=float(scale),
                   zero_point=float(zero_point))

    @classmethod
    def image_uint8(cls, mean: float = 127.0, std: float = 64.0,
                    decode_dtype: str = "float32") -> "WireSpec":
        """Raw uint8 pixels on the wire, ``(x - mean) / std`` normalized
        float on the device."""
        return cls.quantize("uint8", scale=1.0 / float(std),
                            zero_point=float(mean), decode_dtype=decode_dtype)

    # -- dtype views --------------------------------------------------------
    @property
    def wire_np(self) -> np.dtype:
        """The host numpy dtype of the wire bytes (``uint16`` for bf16)."""
        return _host_dtype(self.wire_dtype)

    @property
    def wire_torch(self) -> torch.dtype:
        return convert_dtype(self.wire_dtype)

    @property
    def decode_torch(self) -> torch.dtype:
        return convert_dtype(self.decode_dtype)

    # -- host encode (numpy) -------------------------------------------------
    def encode(self, arr) -> np.ndarray:
        """Host-side encode to the wire dtype. Idempotent: an array already
        in the wire's host dtype (raw uint8 pixels, bf16 bit patterns)
        passes through untouched — re-quantizing encoded data would
        corrupt it.

        Quantize refuses non-finite input: an integer wire dtype has no
        NaN/Inf, so a corrupt batch would otherwise be laundered into valid
        values. (Cast wire dtypes carry NaN/Inf through.)"""
        arr = np.asarray(arr)
        if self.kind == "passthrough" or arr.dtype == self.wire_np:
            return arr
        if self.kind == "cast":
            if self.wire_dtype == "bfloat16":
                return bf16_bits(arr)
            return arr.astype(self.wire_np)
        q = np.round(arr.astype(np.float32) / self.scale + self.zero_point)
        if not np.isfinite(q).all():
            raise FloatingPointError(
                f"WireSpec.quantize({self.wire_dtype}): input batch "
                "contains NaN/Inf — an integer wire format cannot carry "
                "them, and silently casting would hide the corruption")
        info = np.iinfo(self.wire_np)
        return np.clip(q, info.min, info.max).astype(self.wire_np)

    # -- device decode (torch) -----------------------------------------------
    def decode(self, x):
        """Dequantize or cast back to the logical value, as a tensor
        (elementwise, so a stacked ``(K, batch, ...)`` feed decodes
        unchanged). A numpy array is first taken as the wire's host bytes
        (bf16 bit patterns included).

        Dtype-guarded: a tensor already in the decode dtype passes through
        (pre-staged logical values must not be dequantized twice), and a
        dtype that is neither wire nor decode raises."""
        if self.kind == "passthrough":
            return x
        if isinstance(x, np.ndarray) or not isinstance(x, torch.Tensor):
            x = np.asarray(x)
            if self.wire_dtype == "bfloat16" and x.dtype == np.uint16:
                x = bf16_tensor(x)
            elif x.dtype.name == "bfloat16":  # an ml_dtypes array, if one is given
                x = bf16_tensor(x.view(np.uint16))
            else:
                x = torch.from_numpy(np.ascontiguousarray(x))
        elif self.wire_dtype == "bfloat16" and x.dtype in (torch.uint16, torch.int16):
            x = x.view(torch.bfloat16)  # bit patterns put on the device as they are
        if x.dtype == self.decode_torch:
            return x  # already logical: nothing to decode
        if self.kind == "cast":
            return x.to(self.decode_torch)
        enforce(x.dtype == self.wire_torch,
                f"WireSpec.decode: expected {self.wire_dtype} wire data or "
                f"{self.decode_dtype} logical data, got {dtype_name(x.dtype)} — "
                "pre-staged device feeds must be either wire-encoded or logical")
        return (x.to(self.decode_torch) - self.zero_point) * self.scale

    def wire_itemsize(self) -> int:
        return self.wire_torch.itemsize

    def logical_itemsize(self) -> int:
        return self.decode_torch.itemsize


class FeedWire:
    """A per-field table of :class:`WireSpec`s for one feed dict. Fields
    without a spec pass through untouched (labels, ids, already-narrow
    fields)."""

    def __init__(self, specs: Dict[str, WireSpec]):
        for name, spec in specs.items():
            enforce(isinstance(spec, WireSpec),
                    f"FeedWire: field {name!r} maps to {type(spec).__name__},"
                    " expected a WireSpec")
        self.specs = dict(specs)

    @classmethod
    def make(cls, obj) -> Optional["FeedWire"]:
        """Normalize ``None`` | ``FeedWire`` | ``{name: WireSpec}``."""
        if obj is None or isinstance(obj, FeedWire):
            return obj
        enforce(isinstance(obj, dict),
                f"feed_wire: expected a FeedWire or a dict of WireSpec, "
                f"got {type(obj).__name__}")
        return cls(obj)

    def __eq__(self, other) -> bool:
        return isinstance(other, FeedWire) and self.specs == other.specs

    def __repr__(self) -> str:
        return f"FeedWire({self.specs!r})"

    # -- host side ----------------------------------------------------------
    def encode(self, feed: Dict[str, Any]) -> Dict[str, Any]:
        """Encode every spec'd field to its wire dtype (numpy, host).
        Already-encoded fields pass through, and so do tensors (already
        placed: encode cannot reach them)."""
        out = {}
        for k, v in feed.items():
            spec = self.specs.get(k)
            out[k] = v if spec is None or isinstance(v, torch.Tensor) else spec.encode(v)
        return out

    # -- device side ---------------------------------------------------------
    def decode(self, feed: Dict[str, Any]) -> Dict[str, Any]:
        """Decode every spec'd field back to its logical dtype."""
        return {k: (self.specs[k].decode(v) if k in self.specs else v)
                for k, v in feed.items()}

    def logical_feed(self, feed: Dict[str, Any]) -> Dict[str, Any]:
        """Map a (possibly wire-typed) sample feed to its logical shapes
        and dtypes: a field arriving in the wire dtype becomes a ``meta``
        tensor of the decode dtype, same shape."""
        out = {}
        for k, v in feed.items():
            spec = self.specs.get(k)
            shape = tuple(getattr(v, "shape", np.shape(v)))
            if spec is not None and spec.kind != "passthrough" and _is_wire(v, spec):
                out[k] = torch.empty(shape, dtype=spec.decode_torch, device="meta")
            else:
                out[k] = v
        return out

    # -- byte accounting ------------------------------------------------------
    def wire_nbytes(self, feed: Dict[str, Any]) -> int:
        """Bytes this feed occupies ON THE WIRE (after encode)."""
        return _feed_nbytes(feed, self, lambda s: s.wire_itemsize())

    def logical_nbytes(self, feed: Dict[str, Any]) -> int:
        """Bytes of the decoded (logical) feed — what a passthrough
        transfer of the same values would have cost."""
        return _feed_nbytes(feed, self, lambda s: s.logical_itemsize())


def _is_wire(v, spec: WireSpec) -> bool:
    if isinstance(v, torch.Tensor):
        return v.dtype == spec.wire_torch
    return np.asarray(v).dtype == spec.wire_np


def _itemsize(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.element_size()
    dt = getattr(v, "dtype", None)
    return np.dtype(dt).itemsize if dt is not None else np.asarray(v).itemsize


def _feed_nbytes(feed, wire: Optional[FeedWire], itemsize_of) -> int:
    total = 0
    for k, v in feed.items():
        n = int(np.prod(tuple(getattr(v, "shape", np.shape(v))) or (1,)))
        spec = wire.specs.get(k) if wire is not None else None
        if spec is not None and spec.kind != "passthrough":
            total += n * itemsize_of(spec)
        else:
            total += n * _itemsize(v)
    return total


def feed_wire_nbytes(feed: Dict[str, Any],
                     wire: Optional[FeedWire] = None) -> int:
    """Bytes crossing the link for ``feed`` under ``wire`` (no wire table:
    the raw host bytes)."""
    return _feed_nbytes(feed, wire, lambda s: s.wire_itemsize())


def feed_logical_nbytes(feed: Dict[str, Any],
                        wire: Optional[FeedWire] = None) -> int:
    """Logical bytes of ``feed``: the denominator of a wire-reduction ratio
    (a raw-uint8 feed with a decode-to-f32 spec counts 4 bytes a pixel
    here, 1 in :func:`feed_wire_nbytes`)."""
    return _feed_nbytes(feed, wire, lambda s: s.logical_itemsize())


__all__ = ["FeedWire", "WireSpec", "bf16_bits", "bf16_tensor", "feed_logical_nbytes",
           "feed_wire_nbytes"]
