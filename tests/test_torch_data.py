"""The port's data path against the JAX package's: the MNIST reader (its
synthetic fallback here: no dataset files), the reader decorators and
``DataFeeder.feed`` give bit-identical arrays; ``DeviceFeeder``'s fill
thread re-raises a reader's exception after the batches it delivered and
stops on ``close``. The copy on a side CUDA stream needs the card and
runs in ``chip_smoke.py`` (phase 8 holds fit with prefetch against fit
without, bit for bit); here ``put_fn`` stands in for it."""

import threading
import time

import numpy as np
import pytest

from paddle_tpu import data as jdata

from paddle_tpu_torch import data as tdata
from paddle_tpu_torch.core.errors import NotYetPorted


def _same(a, b):
    """Bit-identical: the same structure, dtypes and bytes."""
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("split", ["train", "test"])
def test_mnist_reader_is_bit_identical(split):
    j, t = jdata.datasets.mnist(split), tdata.datasets.mnist(split)
    assert j.synthetic == t.synthetic
    _same(list(j()), list(t()))


def _numbers(n=23):
    def reader():
        for i in range(n):
            yield np.float32(i) * 0.5, np.int64(i % 3)
    return reader


DECORATORS = {
    "shuffle_seed0_batch": lambda D: D.batch(D.shuffle(D.datasets.mnist("train"), 512, seed=0),
                                             64),
    "batch_keep_last": lambda D: D.batch(_numbers(), 5, drop_last=False),
    "batch_drop_last": lambda D: D.batch(_numbers(), 5, drop_last=True),
    "shuffle_small_buffer": lambda D: D.shuffle(_numbers(), 4, seed=3),
    "map_readers": lambda D: D.map_readers(lambda a, b: (a[0] + b[0], a[1]),
                                           _numbers(), _numbers()),
    "chain": lambda D: D.chain(_numbers(3), _numbers(4)),
    "compose": lambda D: D.compose(_numbers(5), _numbers(5)),
    "buffered": lambda D: D.buffered(_numbers(), 3),
    "firstn": lambda D: D.firstn(_numbers(), 7),
    "cache": lambda D: D.cache(_numbers()),
    "xmap_ordered": lambda D: D.xmap_readers(lambda s: (s[0] * 2, s[1]), _numbers(), 3, 4,
                                             order=True),
    "fake": lambda D: D.fake(_numbers(), 4),
}


@pytest.mark.parametrize("name", sorted(DECORATORS))
def test_reader_decorator_is_bit_identical(name):
    j, t = DECORATORS[name](jdata), DECORATORS[name](tdata)
    _same(list(j()), list(t()))
    _same(list(j()), list(t()))  # and again: readers are re-iterable


def test_multiprocess_reader_gives_every_sample():
    j = jdata.multiprocess_reader([_numbers(5), _numbers(6)])
    t = tdata.multiprocess_reader([_numbers(5), _numbers(6)])
    key = lambda s: (float(s[0]), int(s[1]))  # noqa: E731 (arrival order is free)
    _same(sorted(j(), key=key), sorted(t(), key=key))


@pytest.mark.parametrize("dtypes", [None, ["float32", "int64"], ["float32", "int32"]])
def test_data_feeder_gives_the_same_dicts(dtypes):
    samples = next(iter(DECORATORS["shuffle_seed0_batch"](tdata)()))
    j = jdata.DataFeeder(["image", "label"], dtypes).feed(samples)
    t = tdata.DataFeeder(["image", "label"], dtypes).feed(samples)
    _same(j, t)
    with pytest.raises(ValueError, match="arity"):
        tdata.DataFeeder(["image"], None).feed(samples)


class _ReaderDied(RuntimeError):
    pass


def _failing_batches(n_good):
    def batches():
        for i in range(n_good):
            yield {"x": np.full((2,), i, np.float32)}
        raise _ReaderDied("reader failed")
    return batches


def test_device_feeder_reraises_after_the_delivered_batches():
    feeder = tdata.DeviceFeeder(_failing_batches(3), put_fn=lambda b: b)
    got = []
    with pytest.raises(_ReaderDied, match="reader failed"):
        for b in feeder:
            got.append(float(b["x"][0]))
    assert got == [0.0, 1.0, 2.0]
    feeder.close()
    assert not any(t.is_alive() for t in feeder._threads)


def test_device_feeder_close_stops_a_blocked_fill_thread():
    """The consumer takes one batch and stops reading: the fill thread
    parks on the full queue until close() cancels it."""
    started = threading.Event()

    def endless():
        started.set()
        i = 0
        while True:
            yield {"x": np.full((2,), i, np.float32)}
            i += 1

    feeder = tdata.DeviceFeeder(endless, capacity=2, put_fn=lambda b: b)
    it = iter(feeder)
    assert float(next(it)["x"][0]) == 0.0
    assert started.wait(timeout=10)
    time.sleep(0.3)  # let it fill the queue and block
    fill = feeder._threads[0]
    assert fill.is_alive()
    feeder.close()
    assert not fill.is_alive()


def test_device_feeder_abandoned_iterator_stops_its_thread():
    feeder = tdata.DeviceFeeder(_failing_batches(50), put_fn=lambda b: b)
    for _ in zip(range(2), feeder):
        pass  # zip closes nothing: the generator is dropped here
    deadline = time.time() + 10
    while any(t.is_alive() for t in feeder._threads) and time.time() < deadline:
        time.sleep(0.05)
    assert not any(t.is_alive() for t in feeder._threads)


@pytest.mark.parametrize("kw", [{"journal": object()}, {"overlap_depth": 1},
                                {"wait_fn": lambda dev, t0: None}])
def test_device_feeder_options_of_later_slices_raise(kw):
    with pytest.raises(NotYetPorted):
        tdata.DeviceFeeder(_failing_batches(1), put_fn=lambda b: b, **kw)
