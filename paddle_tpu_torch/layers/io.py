"""Graph-embedded IO surface (counterpart of ``paddle_tpu.layers.io``;
reference python/paddle/fluid/layers/io.py).

The reference embeds the data pipeline in the program (py_reader blocking
queues, recordio reader ops, shuffle/batch/double-buffer decorator ops —
operators/reader/*). Here, as in the JAX package, the pipeline is
host-side (``data/reader.py`` combinators + ``data/feeder.py``'s device
prefetch), and these functions keep the fluid API names, delegating to
it. ``data()`` returns a meta tensor: the sample placeholder that
``Trainer.startup(sample_feed=...)`` takes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.dtypes import convert_dtype
from ..core.errors import enforce
from ..data import reader as _reader
from ..data.feeder import DeviceFeeder
from .. import recordio as _recordio


def data(name: str, shape: Sequence[int], dtype="float32", lod_level: int = 0,
         append_batch_size: bool = True) -> torch.Tensor:
    """fluid.layers.data analog: a typed placeholder, a tensor on the
    ``meta`` device (shape and dtype, no storage), which
    ``Trainer.startup(sample_feed={name: data(...)})`` takes as a sample
    input. A leading batch dim of 1 stands in for the runtime batch
    (append_batch_size)."""
    full = ([1] if append_batch_size else []) + [abs(s) if s != -1 else 1 for s in shape]
    return torch.empty(tuple(full), dtype=convert_dtype(dtype), device="meta")


def batch(reader, batch_size: int, drop_last: bool = False):
    """layers.io.batch = reader-level batching (batch_op analog)."""
    return _reader.batch(reader, batch_size, drop_last=drop_last)


def shuffle(reader, buffer_size: int):
    """layers.io.shuffle (shuffle_reader op analog)."""
    return _reader.shuffle(reader, buffer_size)


def double_buffer(reader, place=None, name=None):
    """double_buffer_reader analog: host→device prefetch of one batch
    ahead. ``reader`` yields feed dicts; returns a :class:`DeviceFeeder`
    on ``place`` (the card when None) whose iterator yields them on the
    device."""
    return DeviceFeeder(reader, device=place)


def py_reader(capacity: int, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer: bool = True, place=None):
    """create_py_reader analog (lod_tensor_blocking_queue.h): a
    background-thread feeding queue. Returns a PyReader with
    decorate_paddle_reader/start/reset, yielding ready device batches."""
    return PyReader(capacity, use_double_buffer=use_double_buffer, place=place)


class PyReader:
    """Python-fed async reader (reader/create_py_reader_op.cc capability):
    a bounded queue filled by a background thread, drained by the train
    loop — the host-side overlap the reference got from the blocking
    queue + double_buffer ops. With ``use_double_buffer``, :meth:`start`
    returns a :class:`DeviceFeeder` on ``place`` (the card when None)."""

    def __init__(self, capacity: int, use_double_buffer: bool = True, place=None):
        self.capacity = capacity
        self.use_double_buffer = use_double_buffer
        self.place = place
        self._reader = None

    def decorate_paddle_reader(self, reader):
        self._reader = reader

    decorate_sample_list_generator = decorate_paddle_reader
    decorate_batch_generator = decorate_paddle_reader

    def start(self):
        r = _reader.buffered(self._reader, self.capacity)
        if self.use_double_buffer:
            return DeviceFeeder(r, device=self.place)
        return r()

    def __call__(self):
        return self.start()

    def reset(self):
        pass


def open_files(filenames: Sequence[str], shapes=None, dtypes=None, lod_levels=None,
               thread_num: int = 1, buffer_size: Optional[int] = None):
    """open_files/open_recordio_file analog: a reader over recordio
    shards, round-robin by file, decoded to numpy tuples."""
    def _r():
        for fn in filenames:
            for rec in _recordio.reader_creator(fn)():
                yield rec
    if buffer_size:
        return _reader.buffered(_r, buffer_size)
    return _r


def read_file(reader):
    """read_file op analog: pull one batch from a started reader."""
    it = reader() if callable(reader) else iter(reader)
    return next(it)


def random_data_generator(low: float, high: float, shapes, lod_levels=None, name=None):
    """create_random_data_generator_op analog — the synthetic in-graph
    data source the reference uses widely in tests/benchmarks."""
    rng = np.random.RandomState(0)

    def _r():
        while True:
            yield tuple(rng.uniform(low, high, s).astype(np.float32) for s in shapes)
    return _r


class Preprocessor:
    """reader/create_custom_reader_op analog: attach a per-sample
    transform to a reader: ``Preprocessor(reader)(fn)``."""

    def __init__(self, reader, name=None):
        self.reader = reader

    def __call__(self, fn):
        return _reader.map_readers(fn, self.reader)


def load(out, file_path, load_as_fp16=None) -> torch.Tensor:
    """load_op analog (reference layers/io.py:1070, operators/load_op.cc):
    read one saved array from ``file_path`` (``.npy`` via numpy, or a
    single-entry ``.npz``). The reference mutates ``out`` in place; here
    the loaded array is returned as a CPU tensor (pass ``out=None`` or an
    exemplar whose dtype the result is cast to)."""
    arr = np.load(file_path, allow_pickle=False)
    if hasattr(arr, "files"):  # npz archive: exactly one entry
        enforce(len(arr.files) == 1,
                f"load: {file_path!r} holds {len(arr.files)} arrays; expected 1")
        arr = arr[arr.files[0]]
    if load_as_fp16:
        arr = arr.astype(np.float16)
    t = torch.from_numpy(np.array(arr))
    if out is not None and hasattr(out, "dtype") and not load_as_fp16:
        t = t.to(convert_dtype(out.dtype))
    return t
