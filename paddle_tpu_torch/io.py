"""Inference export and the Predictor (counterpart of the inference half
of ``paddle_tpu.io``).

An artifact directory holds what ``paddle_tpu.io.save_inference_model``
writes, minus the StableHLO: ``params.npz`` and ``state.npz`` under the
same key mangling (bfloat16 as a uint16 view with an ``@bfloat16``
suffix), and ``meta.json`` with ``feed_names``/``batch_size``/
``batched_feeds``/``batch_buckets``. The program is recorded by its
builder and arguments (``builder``, ``config``, ``max_new_tokens`` ...)
and rebuilt from them at load. The commit is atomic: everything is
written to a ``<dirname>.tmp.<pid>`` sibling, fsynced and renamed into
place. Not carried yet: the CRC manifest (``resilience.write_manifest``,
the checkpoint slice) and an exported graph (``torch.export`` cannot
trace a kernel called through ctypes).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.errors import EnforceError, enforce
from .core.place import default_device

SEP = "||"  # path separator for nested keys (param names use '/')
TMP_MARKER = ".tmp."


def _log():
    return logging.getLogger("paddle_tpu_torch.io")


class InvalidRequest(EnforceError, ValueError):
    """A serving/inference feed failed structural validation: missing or
    extra feed key, shape or dtype mismatch, off-bucket batch size, or a
    non-finite payload. Carries ``field`` (the offending feed name) and
    ``reason``."""

    def __init__(self, field: str, reason: str):
        super().__init__(f"invalid request: feed {field!r} {reason}")
        self.field = field
        self.reason = reason


# npz cannot store bfloat16: it is saved as its uint16 bit pattern under
# a "@bfloat16" key suffix, the JAX package's encoding
_EXOTIC_DTYPES = {"bfloat16": np.uint16}

# the JAX package runs with 64-bit types off: an int64/float64 feed is
# taken as its 32-bit canonical type
_CANONICAL = {np.dtype(np.int64): np.dtype(np.int32),
              np.dtype(np.uint64): np.dtype(np.uint32),
              np.dtype(np.float64): np.dtype(np.float32),
              np.dtype(np.complex128): np.dtype(np.complex64)}


def _canonical_dtype(dtype: np.dtype) -> np.dtype:
    dtype = np.dtype(dtype)
    return _CANONICAL.get(dtype, dtype)


# -- flat dict <-> npz -------------------------------------------------------


def _mangle_key(prefix: str, dtype_name: str, stored: np.dtype) -> str:
    """The npz member name of a leaf of logical dtype ``dtype_name``
    stored as ``stored`` (``paddle_tpu.io._mangle_key``'s rule)."""
    if dtype_name in _EXOTIC_DTYPES:
        return f"{prefix}@{dtype_name}"
    if (prefix.endswith("@raw")
            or any(prefix.endswith(f"@{dt}") and stored == enc
                   for dt, enc in _EXOTIC_DTYPES.items())):
        # an integer param literally named 'x@bfloat16' (or 'x@raw') is
        # escaped so load strips exactly one suffix
        return f"{prefix}@raw"
    return prefix


def _to_numpy(t) -> Tuple[str, np.ndarray]:
    """(logical dtype name, storable numpy array) of a tensor/array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy().view(np.uint16)
        a = t.numpy()
        return a.dtype.name, a
    a = np.asarray(t)
    if a.dtype.name == "bfloat16":
        return "bfloat16", a.view(np.uint16)
    return a.dtype.name, a


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{SEP}{k}" if prefix else str(k)))
    elif tree is not None:
        name, a = _to_numpy(tree)
        out[_mangle_key(prefix, name, a.dtype)] = a
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """npz members -> nested dict of CPU tensors (bfloat16 restored)."""
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        t = None
        if "@" in key:
            maybe_key, _, dtname = key.rpartition("@")
            if dtname == "raw":
                key = maybe_key
            elif dtname in _EXOTIC_DTYPES and v.dtype == _EXOTIC_DTYPES[dtname]:
                key = maybe_key
                t = torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
        if t is None:
            t = torch.from_numpy(np.array(v))
        parts = key.split(SEP)
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = t
    return out


def _load_npz(path: str) -> Dict[str, Any]:
    if not os.path.exists(path):
        return {}
    with np.load(path, allow_pickle=False) as z:
        return _unflatten({k: z[k] for k in z.files})


def _fsync_tree(dirname: str) -> None:
    for name in os.listdir(dirname):
        p = os.path.join(dirname, name)
        if not os.path.isfile(p):
            continue
        fd = os.open(p, os.O_RDONLY)
        try:
            os.fsync(fd)
        except OSError:
            pass  # fs without fsync support: best effort
        finally:
            os.close(fd)
    _fsync_dir(dirname)


def _fsync_dir(dirname: str) -> None:
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _recover_renamed_aside(path: str) -> None:
    """A save that died between moving the old artifact aside and
    committing the new one leaves the only good copy at
    ``<path>.tmp.<pid>.old``: put it back before anything else."""
    if os.path.isdir(path):
        return
    parent = os.path.dirname(path) or "."
    olds = [p for p in (os.path.join(parent, n) for n in os.listdir(parent))
            if p.startswith(f"{path}{TMP_MARKER}") and p.endswith(".old")
            and os.path.isdir(p)]
    if olds:
        newest = max(olds, key=os.path.getmtime)
        os.rename(newest, path)
        _log().warning("recovered artifact %s from interrupted overwrite (%s)",
                       path, os.path.basename(newest))


def _infer_batch_info(example_feed: Dict[str, Any]) -> Tuple[int, List[str]]:
    """(batch_size, batched feed names): the batch is the leading dim of
    the first (sorted) non-scalar feed; every feed sharing it is batched."""
    batch = 0
    for k in sorted(example_feed):
        v = np.asarray(example_feed[k])
        if v.ndim >= 1:
            batch = int(v.shape[0])
            break
    batched = [k for k in sorted(example_feed)
               if np.asarray(example_feed[k]).ndim >= 1
               and np.asarray(example_feed[k]).shape[0] == batch]
    return batch, batched


# -- export ------------------------------------------------------------------


def save_inference_model(dirname: str, program, params: Dict[str, Any],
                         state: Dict[str, Any], example_feed: Dict[str, Any],
                         batch_buckets: Optional[Sequence[int]] = None) -> None:
    """Export ``program`` (a module with ``spec()``, e.g. a
    ``models.gpt.make_generator`` program) with its weights as an
    inference artifact. ``batch_buckets`` adds batch sizes the
    :class:`Predictor` serves besides the example feed's own."""
    enforce(callable(getattr(program, "spec", None)),
            "save_inference_model: the program must have spec() "
            "(a port program such as models.gpt.make_generator's)")
    feed_names = sorted(example_feed)
    batch, batched_feeds = _infer_batch_info(example_feed)
    buckets = sorted(set(int(b) for b in (batch_buckets or [])) | {batch})
    enforce(all(b > 0 for b in buckets),
            f"batch_buckets must be positive, got {buckets}")
    feeds = {}
    for k in feed_names:
        v = np.asarray(example_feed[k])
        feeds[k] = {"shape": list(v.shape),
                    "dtype": _canonical_dtype(v.dtype).name}
    meta = {"feed_names": feed_names, "batch_size": batch,
            "batched_feeds": batched_feeds, "batch_buckets": buckets,
            "feeds": feeds, **program.spec()}

    path = os.path.abspath(dirname)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    _recover_renamed_aside(path)
    tmp = f"{path}{TMP_MARKER}{os.getpid()}"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "params.npz"), **_flatten(params))
    np.savez(os.path.join(tmp, "state.npz"), **_flatten(state or {}))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    _fsync_tree(tmp)
    old = None
    if os.path.isdir(path):
        # move the committed artifact aside (one rename) instead of
        # deleting it first: a crash in the two-rename window leaves it
        # recoverable (_recover_renamed_aside)
        old = f"{path}{TMP_MARKER}{os.getpid()}.old"
        os.rename(path, old)
    os.rename(tmp, path)
    _fsync_dir(parent)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


def _builders():
    from .models import gpt
    return {gpt.BUILDER: gpt.build_from_spec}


def load_inference_model(dirname: str, device=None) -> "Predictor":
    """Rebuild the program recorded in ``dirname``, load its weights onto
    ``device`` (the CUDA card by default) and warm every bucket once."""
    dev = default_device(device, "load_inference_model")
    with open(os.path.join(dirname, "meta.json")) as f:
        meta = json.load(f)
    builder = _builders().get(meta.get("builder"))
    enforce(builder is not None,
            f"load_inference_model: {dirname!r} records builder "
            f"{meta.get('builder')!r}, which this port cannot rebuild")
    program = builder(meta, device=dev)
    program.load_params(_load_npz(os.path.join(dirname, "params.npz")))
    return Predictor(program, meta["feed_names"], meta["feeds"],
                     batch_size=meta["batch_size"],
                     batched_feeds=meta["batched_feeds"],
                     batch_buckets=meta["batch_buckets"])


class Predictor:
    """Loaded inference model: ``run(feed) -> outputs`` (tensors on the
    program's device); ``clone()`` is free (the program and its weights
    are shared and stateless across calls).

    ``run`` validates the feed first — a missing/extra key or a
    shape/dtype mismatch raises a typed :class:`InvalidRequest` naming
    the offending field — and dispatches only exact bucket sizes
    (padding ragged batches up to a bucket is the server's job).
    Construction runs every bucket once, the port's stand-in for the
    JAX package's AOT compile."""

    def __init__(self, program, feed_names: Sequence[str],
                 feeds: Dict[str, Dict[str, Any]], batch_size: int,
                 batched_feeds: Sequence[str], batch_buckets: Sequence[int],
                 warmup: bool = True):
        self._program = program
        self.feed_names = list(feed_names)
        self._feeds = {k: (tuple(v["shape"]), np.dtype(v["dtype"]))
                       for k, v in feeds.items()}
        self.batch_size = int(batch_size)
        self.batched_feeds = frozenset(batched_feeds)
        self._buckets = sorted(int(b) for b in batch_buckets)
        if warmup:
            for b in self._buckets:
                _block_on(self.run({k: np.zeros(shape, dtype) for k, (shape, dtype)
                                    in self.feed_spec(b).items()}))

    @property
    def program(self):
        return self._program

    @property
    def device(self) -> torch.device:
        return self._program.device

    @property
    def batch_buckets(self) -> List[int]:
        """Served batch sizes, ascending."""
        return list(self._buckets)

    def feed_spec(self, batch: Optional[int] = None) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
        """{feed name: (shape, numpy dtype)} at bucket ``batch`` (default:
        the export's own batch size)."""
        batch = self.batch_size if batch is None else int(batch)
        out = {}
        for k, (shape, dtype) in self._feeds.items():
            if k in self.batched_feeds:
                shape = (batch,) + shape[1:]
            out[k] = (shape, dtype)
        return out

    def validate_feed(self, feed: Dict[str, Any],
                      allow_padding: bool = False) -> Tuple[int, int]:
        """Structural request validation. Returns ``(n, bucket)`` — the
        request's batch size and the bucket that serves it (``n ==
        bucket`` unless ``allow_padding``, where the smallest bucket >= n
        is chosen). Raises :class:`InvalidRequest` naming the offending
        field for missing/extra keys, shape or dtype mismatches, and
        off-bucket batch sizes."""
        for k in self.feed_names:
            if k not in feed:
                raise InvalidRequest(k, "is missing from the feed "
                                     f"(expected keys: {self.feed_names})")
        for k in sorted(feed):
            if k not in self._feeds:
                raise InvalidRequest(
                    k, "is not a feed of this model "
                    f"(expected keys: {self.feed_names})")
        buckets = self.batch_buckets
        first_batched = (sorted(self.batched_feeds)[0] if self.batched_feeds
                         else self.feed_names[0])
        n = None
        arrs = {k: np.asarray(feed[k]) for k in self.feed_names}
        for k in self.feed_names:
            if k not in self.batched_feeds:
                continue
            v = arrs[k]
            if v.ndim < 1:
                raise InvalidRequest(k, "must be batched (got a scalar)")
            if n is None:
                n = int(v.shape[0])
            elif int(v.shape[0]) != n:
                raise InvalidRequest(
                    k, f"batch dim {v.shape[0]} disagrees with the "
                    f"request's batch size {n}")
        if n is None:
            n = self.batch_size
        if n == 0:
            raise InvalidRequest(first_batched, "has an empty batch")
        if allow_padding:
            fits = [b for b in buckets if b >= n]
            if not fits:
                raise InvalidRequest(
                    first_batched, f"batch size {n} exceeds the largest "
                    f"precompiled bucket (buckets: {buckets})")
            bucket = fits[0]
        else:
            if n not in buckets:
                raise InvalidRequest(
                    first_batched, f"batch size {n} is not a precompiled "
                    f"bucket (buckets: {buckets})")
            bucket = n
        spec = self.feed_spec(n)
        for k in self.feed_names:
            v = arrs[k]
            want_shape, want_dtype = spec[k]
            if tuple(v.shape) != want_shape:
                raise InvalidRequest(
                    k, f"has shape {tuple(v.shape)}, expected {want_shape}")
            if v.dtype != want_dtype and _canonical_dtype(v.dtype) != want_dtype:
                raise InvalidRequest(
                    k, f"has dtype {v.dtype}, expected {want_dtype}")
        return n, bucket

    def run(self, feed: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        self.validate_feed(feed, allow_padding=False)
        spec = self.feed_spec()
        dev = self.device
        vals = {k: torch.from_numpy(np.ascontiguousarray(
                    np.asarray(feed[k]).astype(spec[k][1], copy=False))).to(dev)
                for k in self.feed_names}
        with torch.inference_mode():
            return self._program(**vals)

    def clone(self) -> "Predictor":
        """A predictor over the same program and weights (no warmup)."""
        return Predictor(self._program, self.feed_names,
                         {k: {"shape": list(s), "dtype": d.name}
                          for k, (s, d) in self._feeds.items()},
                         self.batch_size, self.batched_feeds, self._buckets,
                         warmup=False)


def _block_on(out) -> None:
    """Wait until the device has produced ``out`` (the JAX
    ``block_until_ready`` analog)."""
    values = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (list, tuple)) else [out])
    for v in values:
        if isinstance(v, torch.Tensor) and v.device.type == "cuda":
            torch.cuda.synchronize(v.device)
            return


__all__ = ["InvalidRequest", "Predictor", "load_inference_model",
           "save_inference_model"]
