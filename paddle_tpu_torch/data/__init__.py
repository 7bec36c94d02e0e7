"""Data pipeline (counterpart of ``paddle_tpu.data``): reader
combinators, datasets and feeders."""

from . import datasets, feeder, reader
from .feeder import DataFeeder, DeviceFeeder
from .reader import (Fake, PipeReader, batch, buffered, cache, chain, compose,
                     fake, firstn, map_readers, multiprocess_reader, shuffle,
                     xmap_readers)

__all__ = [
    "datasets", "feeder", "reader", "DataFeeder", "DeviceFeeder",
    "batch", "buffered", "cache", "chain", "compose", "firstn",
    "map_readers", "shuffle", "xmap_readers",
]
