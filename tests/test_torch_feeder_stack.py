"""The K-batch feed path of the port (``data/feeder.py``) on the CPU, as
tests/test_fused_steps.py:289-386 pins the JAX package's: ``DeviceFeeder``
stacks full K-chunks and sends remainders and odd-shaped batches singly,
its fill thread is released by an abandoned iterator, a close from
another thread and an idempotent close, and re-raises a reader's error;
``iter_chunked`` is the same chunking without the thread. ``encode_fn``
runs on the fill thread before stacking, and ``PipelineMetrics.report()``
gives the JAX class's fields and values for the same recorded stages. The
copy on a side CUDA stream needs the card (chip_smoke.py phase 12 runs
``fit(steps_per_dispatch=16)`` with it); here ``put_fn`` stands in."""

import threading
import time

import numpy as np
import pytest

from paddle_tpu.data.feeder import PipelineMetrics as JMetrics
from paddle_tpu.data.feeder import stack_batches as jstack

from paddle_tpu_torch.data import feeder as tfeeder
from paddle_tpu_torch.data.feeder import (DeviceFeeder, PipelineMetrics, host_feed_nbytes,
                                          iter_chunked, stack_batches)


def _ident(b):
    return b


def test_stack_batches_matches_paddle_tpu():
    batches = [{"x": np.full((2, 3), i, np.float32), "y": np.arange(2) + i}
               for i in range(3)]
    mine, theirs = stack_batches(batches), jstack(batches)
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(mine[k], np.asarray(theirs[k]))


def test_device_feeder_stacks_full_chunks_and_singles_remainder():
    batches = [{"x": np.full((2,), i, np.float32)} for i in range(7)]
    items = list(DeviceFeeder(lambda: iter(batches), stack_k=3, put_fn=_ident))
    assert [(n, np.asarray(d["x"]).shape) for n, d in items] == \
        [(3, (3, 2)), (3, (3, 2)), (1, (2,))]
    np.testing.assert_array_equal(items[0][1]["x"][:, 0], [0.0, 1.0, 2.0])


def test_device_feeder_shape_mismatch_flushes_singly():
    batches = [{"x": np.zeros((4, 2))}, {"x": np.zeros((4, 2))},
               {"x": np.zeros((3, 2))}, {"x": np.zeros((4, 2))}]
    assert [n for n, _ in DeviceFeeder(lambda: iter(batches), stack_k=3,
                                       put_fn=_ident)] == [1, 1, 1, 1]


def test_device_feeder_puts_chunks_with_put_stacked_fn():
    seen = []
    batches = [{"x": np.zeros((2,))} for _ in range(5)]
    f = DeviceFeeder(lambda: iter(batches), stack_k=2,
                     put_fn=lambda b: seen.append("one") or b,
                     put_stacked_fn=lambda b: seen.append("chunk") or b)
    assert [n for n, _ in f] == [2, 2, 1]
    assert seen == ["chunk", "chunk", "one"]


def test_device_feeder_abandoned_iterator_releases_fill_thread():
    def endless():
        i = 0
        while True:
            yield {"x": np.full((2,), i, np.float32)}
            i += 1

    f = DeviceFeeder(endless, capacity=2, stack_k=2, put_fn=_ident)
    for _ in f:
        break
    f.close()
    for t in f._threads:
        t.join(timeout=5.0)
        assert not t.is_alive(), "fill thread still blocked after close()"


def test_device_feeder_cross_thread_close_unblocks_parked_consumer():
    gate = threading.Event()

    def reader():
        yield {"x": np.zeros((2,))}
        gate.wait(timeout=10.0)  # park the fill thread inside the reader

    f = DeviceFeeder(lambda: reader(), capacity=2, put_fn=_ident)
    got = []
    consumer = threading.Thread(target=lambda: [got.append(i) for i in f])
    consumer.start()
    time.sleep(0.3)  # the consumer takes item 1 and parks in q.get()
    closer = threading.Thread(target=f.close)
    closer.start()
    time.sleep(0.2)
    gate.set()
    consumer.join(timeout=5.0)
    closer.join(timeout=10.0)
    assert not consumer.is_alive(), "consumer hung after a cross-thread close()"
    assert len(got) == 1


def test_device_feeder_close_is_idempotent_and_reiterable():
    f = DeviceFeeder(lambda: iter([{"x": np.zeros((2,))}] * 3), put_fn=_ident)
    assert len(list(f)) == 3
    f.close()
    f.close()
    assert len(list(f)) == 3


def test_device_feeder_propagates_reader_errors_from_a_chunk():
    def bad():
        for _ in range(3):
            yield {"x": np.zeros((2,))}
        raise ValueError("reader broke")

    got = []
    with pytest.raises(ValueError, match="reader broke"):
        for item in DeviceFeeder(lambda: bad(), stack_k=2, put_fn=_ident):
            got.append(item[0])
    assert got == [2]  # the full chunk came first; the pending single died with the reader


def test_iter_chunked_sync_path():
    batches = [{"x": np.full((2,), i, np.float32)} for i in range(5)]
    items = list(iter_chunked(iter(batches), 2, put_fn=_ident, put_stacked_fn=_ident))
    assert [n for n, _ in items] == [2, 2, 1]
    np.testing.assert_array_equal(items[1][1]["x"][:, 0], [2.0, 3.0])


def test_encode_runs_on_the_fill_thread_before_stacking():
    threads = []

    def encode(b):
        threads.append(threading.current_thread().name)
        return {"x": b["x"].astype(np.float16)}

    m = PipelineMetrics()
    batches = [{"x": np.ones((4,), np.float32)} for _ in range(4)]
    items = list(DeviceFeeder(lambda: iter(batches), stack_k=2, put_fn=_ident,
                              encode_fn=encode, metrics=m))
    assert [d["x"].dtype for _, d in items] == [np.float16, np.float16]
    assert set(threads) == {"DeviceFeeder.fill"}
    rep = m.report()
    assert rep["batches"] == 4 and rep["chunks"] == 2
    assert rep["h2d_bytes"] == 4 * 4 * 2 and rep["logical_bytes"] == 4 * 4 * 4
    assert rep["wire_reduction"] == 2.0


def test_pipeline_metrics_report_matches_paddle_tpu():
    """The same recorded stages give the JAX class's report: the same
    fields and values."""
    mine, theirs = PipelineMetrics(), JMetrics()
    for m in (mine, theirs):
        m.record_batch(0.25)
        m.record_batch(0.5)
        m.record_encode(0.125, 1000, 250)
        m.add("stack", 0.0625)
        m.record_h2d(4000, 0.5)
        m.record_h2d(2000, 0.25)
        m.add("dispatch", 1.5)
        m.record_starved(0.75)
    assert mine.report() == theirs.report()
    for m in (mine, theirs):
        m.reset()
    assert mine.report() == theirs.report()


def test_host_feed_nbytes_counts_host_bytes_only():
    import torch
    feed = {"a": np.zeros((3, 4), np.float32), "b": torch.zeros(5, dtype=torch.int64)}
    assert host_feed_nbytes(feed) == 48 + 40
    assert tfeeder.host_feed_nbytes({}) == 0
