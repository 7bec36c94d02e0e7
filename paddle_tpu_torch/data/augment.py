"""On-device data augmentation inside the training step (counterpart of
``paddle_tpu.data.augment``).

The wire formats (:mod:`.wire`) move the decode onto the card; this
module moves the augmentation there too, so the link (or the dataset
cache, :mod:`.device_cache`) carries raw uint8 once, and crop, flip and
normalize run on the card right after the decode, inside the step that
``Trainer.run_steps`` captures as a CUDA graph.

An :class:`AugmentSpec` is an ordered pipeline of ops for one feed
field::

    aug = {"image": AugmentSpec()
               .random_crop(padding=4, axes=(1, 2))
               .random_flip(axis=2)
               .normalize(mean=127.0, std=64.0)}
    trainer = pt.Trainer(program, opt, augment=aug)

- ``normalize(mean, std)``: ``(x - mean) / std`` after a cast to the
  decode dtype, in training and in eval;
- ``random_flip(axis, p)``: one coin a sample, flipping along ``axis``
  (training only);
- ``random_crop(padding, axes)``: zero padding of ``padding`` on each
  side of the ``axes``, then a crop back to the original shape at an
  offset drawn per sample (training only). The crop is a gather
  (``take_along_dim``) at indices made on the card, so it reads nothing
  back to the host and the shapes stay static.

Random numbers. The draws come from the step's
:class:`~paddle_tpu_torch.framework.RngStream`: each random op takes a
derived side generator seeded from the step's seed and a tag made of the
field's name (its crc32, as the JAX package salts its key, never its
position in the table) and the op's index, salted with ``_AUG_SALT``.
So K captured steps augment exactly as K ``step()`` calls (a captured
step reseeds its side generators before each replay), a resumed run
draws what the uninterrupted one drew, and adding a field leaves the
other fields' draws alone. The streams are Philox's, not threefry's: the
port's crops and flips are other draws than the JAX package's, with the
same distribution.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dtypes import convert_dtype, dtype_name
from ..core.errors import enforce
from ..initializer import mix_seed
from .wire import _numpy_floating

# rng salt separating the augmentation stream from the model's own draws
_AUG_SALT = 0x41554730


@dataclasses.dataclass(frozen=True)
class _Op:
    kind: str
    params: Tuple[Tuple[str, Any], ...]

    def get(self, name):
        return dict(self.params)[name]


class AugmentSpec:
    """Ordered on-device augmentation pipeline for one feed field. The
    builder methods return a NEW spec (value semantics, like WireSpec)."""

    def __init__(self, ops: Tuple[_Op, ...] = ()):
        self.ops = tuple(ops)

    def _with(self, op: _Op) -> "AugmentSpec":
        return AugmentSpec(self.ops + (op,))

    # -- builders ------------------------------------------------------------
    def normalize(self, mean: float = 0.0, std: float = 1.0,
                  dtype: str = "float32") -> "AugmentSpec":
        enforce(float(std) != 0.0, "AugmentSpec.normalize: std must be != 0")
        dt = convert_dtype(dtype)
        enforce(_numpy_floating(dt),
                f"AugmentSpec.normalize: dtype {dtype!r} must be floating")
        return self._with(_Op("normalize", (("mean", float(mean)),
                                            ("std", float(std)),
                                            ("dtype", dtype_name(dt)))))

    def random_flip(self, axis: int = -2, p: float = 0.5) -> "AugmentSpec":
        enforce(axis != 0, "AugmentSpec.random_flip: axis 0 is the batch "
                           "dim — flipping it would shuffle samples")
        enforce(0.0 < float(p) <= 1.0,
                f"AugmentSpec.random_flip: p must be in (0, 1], got {p}")
        return self._with(_Op("random_flip", (("axis", int(axis)), ("p", float(p)))))

    def random_crop(self, padding: int, axes: Tuple[int, ...] = (1, 2)) -> "AugmentSpec":
        enforce(int(padding) > 0,
                f"AugmentSpec.random_crop: padding must be > 0, got {padding}")
        axes = tuple(int(a) for a in axes)
        enforce(axes and all(a > 0 for a in axes),
                "AugmentSpec.random_crop: axes are positive batch-relative "
                "dims (the batch dim 0 cannot be cropped)")
        return self._with(_Op("random_crop", (("padding", int(padding)), ("axes", axes))))

    # -- properties ----------------------------------------------------------
    @property
    def has_random(self) -> bool:
        return any(op.kind != "normalize" for op in self.ops)

    def logical_dtype(self, dtype) -> torch.dtype:
        """The dtype this field holds after augmentation: a normalize
        casts to its float dtype."""
        dt = convert_dtype(dtype)
        for op in self.ops:
            if op.kind == "normalize":
                dt = convert_dtype(op.get("dtype"))
        return dt

    # -- apply ---------------------------------------------------------------
    def apply(self, x: torch.Tensor, stream, training: bool,
              salt: int = _AUG_SALT) -> torch.Tensor:
        """Run the pipeline on one step's ``(batch, ...)`` tensor.
        ``stream`` (the step's RngStream) is required in training when the
        spec has random ops; eval applies only the deterministic ops.
        ``salt`` tags this field's draws (see the module)."""
        enforce(not (training and self.has_random and stream is None),
                "AugmentSpec.apply: random ops need the step rng")
        for i, op in enumerate(self.ops):
            if op.kind == "normalize":
                x = (x.to(convert_dtype(op.get("dtype"))) - op.get("mean")) / op.get("std")
                continue
            if not training:
                continue
            g = stream.generator(stream.derived(mix_seed(salt, _AUG_SALT + i)))
            b = x.shape[0]
            if op.kind == "random_flip":
                axis = op.get("axis") % x.dim()
                enforce(axis != 0, "random_flip resolved to the batch dim")
                coin = torch.rand((b,), generator=g, device=x.device) < op.get("p")
                x = torch.where(coin.reshape((-1,) + (1,) * (x.dim() - 1)),
                                torch.flip(x, (axis,)), x)
            elif op.kind == "random_crop":
                pad, axes = op.get("padding"), op.get("axes")
                enforce(max(axes) < x.dim(),
                        f"random_crop axes {axes} out of range for a rank-{x.dim()} feed")
                widths = [0] * (2 * x.dim())
                for a in axes:  # F.pad lists (lo, hi) from the last dim back
                    widths[2 * (x.dim() - 1 - a)] = widths[2 * (x.dim() - 1 - a) + 1] = pad
                out = F.pad(x, widths)
                offs = torch.randint(0, 2 * pad + 1, (b, len(axes)), generator=g,
                                     device=x.device)
                for j, a in enumerate(axes):
                    size = x.shape[a]
                    shape = [1] * x.dim()
                    shape[a] = size
                    idx = (offs[:, j].reshape((b,) + (1,) * (x.dim() - 1))
                           + torch.arange(size, device=x.device).reshape(shape))
                    out = torch.take_along_dim(out, idx, dim=a)
                x = out
        return x

    def __eq__(self, other) -> bool:
        return isinstance(other, AugmentSpec) and self.ops == other.ops

    def __hash__(self):
        return hash(self.ops)

    def __repr__(self):
        return f"AugmentSpec({[op.kind for op in self.ops]})"


def _field_salt(name: str) -> int:
    return _AUG_SALT ^ (zlib.crc32(name.encode("utf-8")) & 0x7FFFFFFF)


class FeedAugment:
    """A per-field table of :class:`AugmentSpec`s for one feed dict (the
    :class:`~paddle_tpu_torch.data.wire.FeedWire` shape), applied in the
    step right after the wire decode."""

    def __init__(self, specs: Dict[str, AugmentSpec]):
        for name, spec in specs.items():
            enforce(isinstance(spec, AugmentSpec),
                    f"FeedAugment: field {name!r} maps to "
                    f"{type(spec).__name__}, expected an AugmentSpec")
        self.specs = dict(specs)

    @classmethod
    def make(cls, obj) -> Optional["FeedAugment"]:
        """Normalize ``None`` | ``FeedAugment`` | ``{name: AugmentSpec}``."""
        if obj is None or isinstance(obj, FeedAugment):
            return obj
        enforce(isinstance(obj, dict),
                f"augment: expected a FeedAugment or a dict of "
                f"AugmentSpec, got {type(obj).__name__}")
        return cls(obj)

    def __eq__(self, other) -> bool:
        return isinstance(other, FeedAugment) and self.specs == other.specs

    def __repr__(self) -> str:
        return f"FeedAugment({self.specs!r})"

    def apply(self, feed: Dict[str, Any], stream, training: bool) -> Dict[str, Any]:
        """Augment every spec'd field; each field's draws are tagged by
        its name (see the module)."""
        out = dict(feed)
        for name in sorted(self.specs):
            if name in out:
                out[name] = self.specs[name].apply(out[name], stream, training,
                                                   salt=_field_salt(name))
        return out

    def logical_feed(self, feed: Dict[str, Any]) -> Dict[str, Any]:
        """A sample feed as the model sees it after augmentation: a field
        that a normalize casts becomes a ``meta`` tensor of its float
        dtype, same shape (crops and flips keep the shape)."""
        out = {}
        for k, v in feed.items():
            spec = self.specs.get(k)
            if spec is None:
                out[k] = v
                continue
            have = convert_dtype(v.dtype if isinstance(v, torch.Tensor) else np.asarray(v).dtype)
            ldt = spec.logical_dtype(have)
            out[k] = (torch.empty(tuple(np.shape(v)), dtype=ldt, device="meta") if ldt != have
                      else v)
        return out


__all__ = ["AugmentSpec", "FeedAugment"]
