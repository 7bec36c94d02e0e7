"""Data pipeline (counterpart of ``paddle_tpu.data``): reader
combinators, datasets, feeders and the feed wire formats."""

from . import datasets, feeder, reader, wire
from .feeder import DataFeeder, DeviceFeeder, PipelineMetrics, iter_chunked, stack_batches
from .reader import (Fake, PipeReader, batch, buffered, cache, chain, compose,
                     fake, firstn, map_readers, multiprocess_reader, shuffle,
                     xmap_readers)
from .wire import FeedWire, WireSpec

__all__ = [
    "datasets", "feeder", "reader", "wire", "DataFeeder", "DeviceFeeder", "PipelineMetrics",
    "iter_chunked", "stack_batches", "FeedWire", "WireSpec",
    "batch", "buffered", "cache", "chain", "compose", "firstn",
    "map_readers", "shuffle", "xmap_readers",
]
