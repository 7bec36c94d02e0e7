"""DataFeeder and device prefetch (counterpart of ``paddle_tpu.data.feeder``).

``DataFeeder.feed`` turns a list of per-sample tuples into a named feed
dict of batched numpy arrays (data_feeder.py:167). ``DeviceFeeder`` is
the double-buffered host→device prefetch (py_reader + double_buffer): a
fill thread stages each batch into pinned host tensors and copies it to
the card with ``non_blocking=True`` on a side CUDA stream, at most
``capacity`` batches ahead. The consumer's stream waits on an event
recorded after the copy, and each delivered tensor is marked
(``record_stream``) as used by the consumer's stream, so the allocator
never hands its memory to the side stream while the step still reads
it. Not carried yet, each raising :class:`NotYetPorted`: K-step stacking
(``stack_k``), the wire encode on the fill thread (``encode_fn``), the
stage metrics (``PipelineMetrics``) and the staging ring (the fused-step
slice, ROADMAP queue 1 item 18).
"""

from __future__ import annotations

import queue as _queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..core.dtypes import convert_dtype, dtype_name
from ..core.errors import EnforceError, NotYetPorted
from ..core.place import default_device


class DataFeeder:
    """Convert reader samples (tuples) into a named feed dict of batched
    numpy arrays (DataFeeder.feed analog, data_feeder.py:167)."""

    def __init__(self, feed_list: Sequence[str], dtypes: Optional[Sequence[Any]] = None):
        self.feed_list = list(feed_list)
        self.dtypes = list(dtypes) if dtypes is not None else [None] * len(self.feed_list)

    def feed(self, samples: Sequence[Tuple]) -> Dict[str, np.ndarray]:
        cols = list(zip(*samples))
        if len(cols) != len(self.feed_list):
            raise ValueError(
                f"sample arity {len(cols)} != feed_list arity {len(self.feed_list)}")
        out = {}
        for name, dt, col in zip(self.feed_list, self.dtypes, cols):
            arr = np.stack([np.asarray(v) for v in col])
            if dt is not None:
                arr = arr.astype(np.dtype(dtype_name(convert_dtype(dt))))
            out[name] = arr
        return out


class _Staged:
    """A batch in flight to the card: its device tensors, the event
    recorded on the side stream after their copies, and the pinned
    sources (kept alive until the consumer takes the batch)."""

    def __init__(self, tensors: Dict[str, torch.Tensor], ready: "torch.cuda.Event",
                 pinned: Dict[str, torch.Tensor]):
        self.tensors, self.ready, self.pinned = tensors, ready, pinned


class DeviceFeeder:
    """Double-buffered host→device prefetch. Wraps a callable returning an
    iterator of feed dicts; ``__iter__`` yields dicts of tensors on the
    card while the next ``capacity`` batches are copied in the background.

    ``device`` is the CUDA card (the default); a CPU target is refused,
    since it has no stream to copy on and a synchronous copy would hide
    nothing. ``put_fn`` replaces the pinned side-stream copy with another
    transform of each batch, run on the fill thread (the CPU tests drive
    the thread's contract that way).

    The fill thread is cancellable: abandoning the iterator (break,
    exception, gc) or calling :meth:`close` stops it even while it waits
    on a full queue. An exception on the fill thread (the reader's, or a
    copy's) is re-raised at ``__next__`` after the batches already
    delivered to the queue, never a silent end of the epoch."""

    def __init__(self, batches: Callable[[], Iterator[Dict[str, Any]]], device=None,
                 capacity: int = 2, put_fn: Optional[Callable] = None, stack_k: int = 1,
                 encode_fn: Optional[Callable] = None, metrics=None):
        for arg, value, default in (("stack_k", stack_k, 1), ("encode_fn", encode_fn, None),
                                    ("metrics", metrics, None)):
            if value != default:
                raise NotYetPorted(f"DeviceFeeder({arg}=...): the fused-step "
                                   "slice (ROADMAP queue 1, item 18)")
        self.batches = batches
        self.capacity = max(1, int(capacity))
        self._stream = None
        if put_fn is None:
            self.device = default_device(device, "DeviceFeeder")
            if self.device.type != "cuda":
                raise EnforceError(
                    f"DeviceFeeder copies each batch on a side CUDA stream; "
                    f"device {self.device} has none, and a synchronous copy "
                    "would prefetch nothing (feed the batches directly)")
            self._stream = torch.cuda.Stream(self.device)
            put_fn = self._stage
        self.put_fn = put_fn
        self._stops: List[threading.Event] = []
        self._threads: List[threading.Thread] = []

    def _stage(self, host_feed: Dict[str, Any]) -> _Staged:
        """Fill thread: pin the batch and start its copies on the side
        stream; the event marks their end. A profile shows the work as the
        ``DeviceFeeder.stage`` range."""
        with record_function("DeviceFeeder.stage"):
            pinned = {}
            for k, v in host_feed.items():
                t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
                pinned[k] = t if t.is_cuda else t.pin_memory()  # a pinned t comes back as is
            with torch.cuda.stream(self._stream):
                tensors = {k: t.to(self.device, non_blocking=True) for k, t in pinned.items()}
                ready = torch.cuda.Event()
                ready.record(self._stream)
            return _Staged(tensors, ready, pinned)

    def _deliver(self, item):
        """Consumer thread: make its stream wait for the batch's copies."""
        if not isinstance(item, _Staged):
            return item
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(item.ready)
        for t in item.tensors.values():
            t.record_stream(stream)
        return item.tensors

    def close(self):
        """Cancel every live fill thread (idempotent)."""
        for ev in self._stops:
            ev.set()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = [t for t in self._threads if t.is_alive()]

    def __iter__(self):
        q: _queue.Queue = _queue.Queue(maxsize=self.capacity)
        END = object()
        err: List[BaseException] = []
        stop = threading.Event()
        self._stops.append(stop)

        def put(item) -> bool:
            # a bounded wait: a consumer that stopped must not strand this
            # thread (and the batches it holds) forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        def fill():
            try:
                for b in self.batches():
                    if stop.is_set() or not put(self.put_fn(b)):
                        return
            except BaseException as e:  # re-raised on the consumer's side
                err.append(e)
            finally:
                if not put(END):
                    try:  # stopped: wake a consumer parked in q.get()
                        q.put_nowait(END)
                    except _queue.Full:
                        pass

        t = threading.Thread(target=fill, name="DeviceFeeder.fill", daemon=True)
        t.start()
        self._threads.append(t)
        try:
            while True:
                try:
                    item = q.get(timeout=0.5)
                except _queue.Empty:
                    if t.is_alive():
                        continue
                    # the thread ended without END reaching the queue: drain
                    # what it delivered, then surface its error
                    while True:
                        try:
                            item = q.get_nowait()
                        except _queue.Empty:
                            break
                        if item is END:
                            break
                        yield self._deliver(item)
                    if err:
                        raise err[0]
                    return
                if item is END:
                    if err:
                        raise err[0]
                    return
                yield self._deliver(item)
        finally:
            stop.set()


__all__ = ["DataFeeder", "DeviceFeeder"]
