"""Data pipeline (counterpart of ``paddle_tpu.data``): reader
combinators, datasets, feeders, the feed wire formats, on-device
augmentation, image helpers and the device dataset cache."""

from . import augment, datasets, device_cache, feeder, image, reader, wire
from .augment import AugmentSpec, FeedAugment
from .device_cache import DeviceCache
from .feeder import DataFeeder, DeviceFeeder, PipelineMetrics, iter_chunked, stack_batches
from .reader import (Fake, PipeReader, batch, buffered, cache, chain, compose,
                     fake, firstn, map_readers, multiprocess_reader, shuffle,
                     xmap_readers)
from .wire import FeedWire, WireSpec

__all__ = [
    "augment", "datasets", "device_cache", "feeder", "image", "reader", "wire",
    "DataFeeder", "DeviceFeeder", "PipelineMetrics", "iter_chunked", "stack_batches",
    "FeedWire", "WireSpec", "AugmentSpec", "FeedAugment", "DeviceCache",
    "batch", "buffered", "cache", "chain", "compose", "firstn",
    "map_readers", "shuffle", "xmap_readers",
]
