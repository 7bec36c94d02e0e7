"""DataFeeder, K-batch stacking and device prefetch (counterpart of
``paddle_tpu.data.feeder``).

``DataFeeder.feed`` turns a list of per-sample tuples into a named feed
dict of batched numpy arrays (data_feeder.py:167). ``DeviceFeeder`` is
the double-buffered host→device prefetch (py_reader + double_buffer): a
fill thread stages each batch into pinned host tensors and copies it to
the card with ``non_blocking=True`` on a side CUDA stream, at most
``capacity`` batches ahead. The consumer's stream waits on an event
recorded after the copy, and each delivered tensor is marked
(``record_stream``) as used by the consumer's stream, so the allocator
never hands its memory to the side stream while the step still reads
it; whatever the consumer then does on its stream (a step, or the copy
into a captured step's feed slot) runs after the copy.

``DeviceFeeder(stack_k=K)`` assembles K host batches into one stacked
super-batch ``{name: (K, batch, ...)}`` and stages it in one transfer —
the feed side of ``Trainer.run_steps`` / ``fit(steps_per_dispatch=K)``;
remainder and odd-shaped batches come singly. :class:`PipelineMetrics`
attributes the fill thread's time to its stages (reader, encode, stack,
h2d, dispatch wait) and the consumer's to starvation, and exports them
as the JAX package's registry families; with a journal each chunk's fill
is a ``feeder.fill`` event with a span the dispatch reuses.

The staging ring (the JAX package's ``overlap_depth``): with
``overlap_depth >= 2`` and metrics or a ``wait_fn``, the fill thread
submits each copy and goes on reading, encoding and stacking while up to
``overlap_depth`` copies are in flight; a waiter thread waits on each
copy's CUDA event in submission order (never on the whole device),
records its submit-to-complete time and only then hands the batch on.
``overlap_depth=1`` is the blocking put. ``wait_fn(item, t_submit)``
replaces the completion wait (``testing.faults.slow_h2d`` makes a slow
link that way).
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..core.dtypes import convert_dtype, dtype_name
from ..core.errors import EnforceError
from ..core.place import default_device


class PipelineMetrics:
    """Input-pipeline stage accounting (thread-safe), the JAX package's
    class (data/feeder.py:30): per-stage wall time and byte counters accumulated by
    :class:`DeviceFeeder` (fill thread: reader / encode / stack / h2d /
    dispatch-wait) and by ``Trainer._put_feed`` on direct-step paths,
    surfaced through :meth:`report` / ``Trainer.pipeline_report()``.

    Stages: ``reader`` (waiting on the host reader for the next batch),
    ``encode`` (the ``encode_fn`` of host arrays), ``stack`` (assembling
    K batches into a super-batch), ``h2d`` (the device put: on the fill
    thread the completed transfer, the staging event waited on; on the
    direct-step paths its submission), ``dispatch`` (the fill thread
    blocked on a full prefetch queue: the compute-bound signal).
    ``consumer_starved_s`` is the time the training loop waited for a
    batch (the input-bound signal). ``h2d_bytes`` counts the bytes that
    crossed the link; ``encode_saved_bytes`` logical minus wire;
    ``overlap_hidden_s`` the transfer time the staging ring hid under
    other work; ``cache_hit_bytes``/``cache_hits`` the chunks the device
    dataset cache served (they count neither h2d bytes nor h2d time).
    :meth:`telemetry_families` exports the same accumulators as the JAX
    package's ``paddle_tpu_feeder_*`` families."""

    _STAGES = ("reader", "encode", "stack", "h2d", "dispatch")

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self.stage_s = {s: 0.0 for s in self._STAGES}
            self.h2d_bytes = 0
            self.encode_saved_bytes = 0
            self.consumer_starved_s = 0.0
            self.batches = 0
            self.chunks = 0
            self.overlap_hidden_s = 0.0
            self.cache_hit_bytes = 0
            self.cache_hits = 0

    def add(self, stage: str, seconds: float):
        with self._lock:
            self.stage_s[stage] += seconds

    def record_encode(self, seconds: float, logical_nbytes: int, wire_nbytes: int):
        with self._lock:
            self.stage_s["encode"] += seconds
            self.encode_saved_bytes += max(0, logical_nbytes - wire_nbytes)

    def record_h2d(self, nbytes: int, seconds: float, exposed_s: Optional[float] = None):
        """One completed transfer of ``nbytes``: ``seconds`` from its
        submission to its completion. ``exposed_s`` (the staging ring) is
        how long the fill thread stalled for it; the rest ran hidden and
        adds to ``overlap_hidden_s``. None (the blocking put, the direct
        step) counts it all as exposed."""
        with self._lock:
            self.stage_s["h2d"] += seconds
            if exposed_s is not None:
                self.overlap_hidden_s += max(0.0, seconds - exposed_s)
            self.h2d_bytes += nbytes
            self.chunks += 1

    def record_cache_hit(self, nbytes: int):
        """A chunk the device dataset cache served device to device:
        ``nbytes`` of wire data that did not cross the link (neither the
        h2d bytes nor the h2d clock move)."""
        with self._lock:
            self.cache_hit_bytes += nbytes
            self.cache_hits += 1

    def record_batch(self, reader_seconds: float):
        with self._lock:
            self.stage_s["reader"] += reader_seconds
            self.batches += 1

    def record_starved(self, seconds: float):
        with self._lock:
            self.consumer_starved_s += seconds

    def telemetry_families(self, inst: str = "0") -> list:
        """The same accumulators as registry metric families under the
        ``paddle_tpu_feeder_*`` names (scrape-time: the Trainer's
        telemetry collector calls this, so the exported series can
        never disagree with :meth:`report`)."""
        from ..telemetry.registry import counter_family

        with self._lock:
            stages = dict(self.stage_s)
            h2d_bytes, saved = self.h2d_bytes, self.encode_saved_bytes
            starved = self.consumer_starved_s
            batches, chunks = self.batches, self.chunks
            hidden = self.overlap_hidden_s
            cache_b, cache_n = self.cache_hit_bytes, self.cache_hits
        labels = {"inst": inst}
        return [
            counter_family(
                "paddle_tpu_feeder_stage_seconds_total",
                "Input-pipeline seconds per stage "
                "(reader/encode/stack/h2d/dispatch wait)",
                [({**labels, "stage": s}, round(v, 6))
                 for s, v in sorted(stages.items())]),
            counter_family(
                "paddle_tpu_feeder_batches_total",
                "Host batches pulled from the reader", [(labels, batches)]),
            counter_family(
                "paddle_tpu_feeder_chunks_total",
                "Device transfers (fused chunks count once)",
                [(labels, chunks)]),
            counter_family(
                "paddle_tpu_feeder_h2d_bytes_total",
                "Wire bytes moved host-to-device", [(labels, h2d_bytes)]),
            counter_family(
                "paddle_tpu_feeder_encode_saved_bytes_total",
                "Logical-minus-wire bytes the feed wire encode saved",
                [(labels, saved)]),
            counter_family(
                "paddle_tpu_feeder_consumer_starved_seconds_total",
                "Training-loop seconds spent waiting for input",
                [(labels, round(starved, 6))]),
            counter_family(
                "paddle_tpu_feeder_overlap_hidden_seconds_total",
                "Transfer seconds hidden under host work / compute by "
                "the double-buffered staging ring",
                [(labels, round(hidden, 6))]),
            counter_family(
                "paddle_tpu_feeder_cache_hit_bytes_total",
                "Wire bytes served device-to-device from the HBM "
                "dataset cache (never crossed the host link)",
                [(labels, cache_b)]),
            counter_family(
                "paddle_tpu_feeder_cache_hits_total",
                "Chunks served from the HBM dataset cache",
                [(labels, cache_n)]),
        ]

    def report(self) -> Dict[str, Any]:
        """Per-stage attribution and an effective-link estimate:
        ``h2d_mbps`` is bytes over transfer wall time; ``bottleneck``
        names the stage with the most time, and ``input_bound`` says
        whether the training loop starved for data more than the fill
        thread waited on it."""
        with self._lock:
            stages = dict(self.stage_s)
            h2d_bytes = self.h2d_bytes
            saved = self.encode_saved_bytes
            starved = self.consumer_starved_s
            batches, chunks = self.batches, self.chunks
            hidden = self.overlap_hidden_s
            cache_b, cache_n = self.cache_hit_bytes, self.cache_hits
        logical = h2d_bytes + saved
        h2d_s = stages["h2d"]
        return {
            "stages_s": {k: round(v, 6) for k, v in stages.items()},
            "h2d_bytes": int(h2d_bytes),
            "logical_bytes": int(logical),
            "wire_reduction": round(logical / h2d_bytes, 3) if h2d_bytes else None,
            "h2d_mbps": (round(h2d_bytes / 1e6 / h2d_s, 2)
                         if h2d_s > 0 and h2d_bytes else None),
            "overlap_hidden_s": round(hidden, 6),
            "h2d_exposed_s": round(max(0.0, h2d_s - hidden), 6),
            "cache_hit_bytes": int(cache_b),
            "cache_hits": cache_n,
            "batches": batches,
            "chunks": chunks,
            "consumer_starved_s": round(starved, 6),
            "bottleneck": max(stages, key=stages.get) if any(
                v > 0 for v in stages.values()) else None,
            "input_bound": starved > stages["dispatch"],
        }


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


def stack_batches(bufs: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Stack K same-shape feed dicts into one ``{name: (K, ...)}``
    super-batch."""
    return {k: np.stack([np.asarray(b[k]) for b in bufs]) for k in bufs[0]}


def host_feed_nbytes(feed: Dict[str, Any]) -> int:
    """Bytes of the host arrays of a feed: what a put of it moves to the
    card (a tensor already on the card counts zero)."""
    total = 0
    for v in feed.values():
        if isinstance(v, torch.Tensor):
            total += 0 if v.is_cuda else v.numel() * v.element_size()
        else:
            total += np.asarray(v).nbytes
    return total


def _shape_dtype(v):
    if isinstance(v, torch.Tensor):
        return tuple(v.shape), v.dtype
    v = np.asarray(v)
    return v.shape, v.dtype


def _stackable(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
    """Two batches can share a super-batch: same keys, shapes and dtypes
    (a short final reader batch must not poison the stack)."""
    if a.keys() != b.keys():
        return False
    return all(_shape_dtype(a[k]) == _shape_dtype(b[k]) for k in a)


def _host_chunks(batches: Iterator[Dict[str, Any]], k: int,
                 metrics: Optional[PipelineMetrics] = None):
    """The chunking both feed paths share: yields ``(n, host_feed)``,
    full K-chunks stacked (``n == k``), remainder and odd-shaped batches
    singly (``n == 1``, unstacked) so they fall through to ``step()``.
    ``metrics`` takes the stack time."""
    buf: List[Dict[str, Any]] = []
    for b in batches:
        if buf and not _stackable(buf[0], b):
            for s in buf:
                yield 1, s
            buf = []
        buf.append(b)
        if len(buf) == k:
            t0 = time.perf_counter()
            stacked = stack_batches(buf)
            if metrics is not None:
                metrics.add("stack", time.perf_counter() - t0)
            yield k, stacked
            buf = []
    for s in buf:
        yield 1, s


def iter_chunked(batches: Iterator[Dict[str, Any]], k: int, put_fn: Callable,
                 put_stacked_fn: Callable):
    """The synchronous chunker (``fit(steps_per_dispatch=K,
    prefetch=False)``): :func:`_host_chunks` plus the put, yielding
    ``(n, device_feed)``."""
    for n, hb in _host_chunks(batches, k):
        yield n, (put_stacked_fn(hb) if n > 1 else put_fn(hb))


class _Staged:
    """A batch in flight to the card: its device tensors, the event
    recorded on the side stream after their copies, and the pinned
    sources (kept alive until the consumer takes the batch)."""

    def __init__(self, tensors: Dict[str, torch.Tensor], ready: "torch.cuda.Event",
                 pinned: Dict[str, torch.Tensor]):
        self.tensors, self.ready, self.pinned = tensors, ready, pinned


def wait_staged(item) -> None:
    """Wait until a batch staged by :class:`DeviceFeeder` has reached the
    card: its copies' CUDA event (the copy alone, never the whole
    device). Anything else (a ``put_fn``'s result) is taken as done."""
    if isinstance(item, _Staged):
        item.ready.synchronize()


class _StagingRing:
    """Depth-bounded asynchronous staging (paddle_tpu/data/feeder.py:315):
    :meth:`submit` starts a chunk's put and returns, so the fill thread
    prepares the next chunk while this one copies; a waiter thread waits
    each put to completion in submission order (``wait_fn``, by default
    the copy's CUDA event) and only then delivers it, so the consumer
    never gets a half-arrived batch and the recorded h2d time is the
    transfer's submit-to-complete wall. At most ``depth`` puts are in
    flight; the fill thread's stall for a slot plus the submit call is the
    exposed time, the rest accumulates as ``overlap_hidden_s``. An error
    of the wait goes to ``on_error``, sets the stop flag and frees a slot,
    so neither the fill thread nor the consumer stays blocked."""

    _END = object()

    def __init__(self, depth: int, deliver: Callable, stop: threading.Event,
                 metrics: Optional[PipelineMetrics] = None,
                 wait_fn: Optional[Callable] = None, journal=None,
                 on_error: Optional[Callable] = None):
        self.depth = max(1, int(depth))
        self._deliver = deliver      # (item, n, span) -> bool (False: stop)
        self._stop = stop
        self._metrics = metrics
        self._wait_fn = wait_fn or (lambda item, t_submit: wait_staged(item))
        self._journal = journal
        self._on_error = on_error
        self._sem = threading.Semaphore(self.depth)
        self._q: _queue.Queue = _queue.Queue()
        self._lock = threading.Lock()
        self._stall_s = 0.0          # fill-thread seconds blocked here
        self._thread = threading.Thread(target=self._drain, name="DeviceFeeder.wait",
                                        daemon=True)
        self._thread.start()

    def _take_stall(self) -> float:
        with self._lock:
            s, self._stall_s = self._stall_s, 0.0
            return s

    def submit(self, n: int, host_feed, putter: Callable) -> bool:
        """Start one chunk's put. False when the stop flag fired first."""
        t_a = time.perf_counter()
        while not self._sem.acquire(timeout=0.1):
            if self._stop.is_set():
                return False
        stall = time.perf_counter() - t_a
        span = self._journal.new_span() if self._journal is not None else None
        nbytes = host_feed_nbytes(host_feed)
        t0 = time.perf_counter()
        item = putter(host_feed)
        with self._lock:
            # the submit call is exposed too: the fill thread paid it
            self._stall_s += stall + (time.perf_counter() - t0)
        self._q.put((item, n, span, t0, nbytes))
        return True

    def finish(self):
        """End of stream: let the puts in flight deliver, then return (at
        once when the stop flag fires)."""
        self._q.put(self._END)
        while self._thread.is_alive():
            self._thread.join(timeout=0.1)
            if self._stop.is_set():
                return

    def _drain(self):
        while True:
            try:
                entry = self._q.get(timeout=0.1)
            except _queue.Empty:
                if self._stop.is_set():
                    return
                continue
            if entry is self._END:
                return
            item, n, span, t0, nbytes = entry
            try:
                self._wait_fn(item, t0)
            except BaseException as e:  # surfaced on the consumer's side
                if self._on_error is not None:
                    self._on_error(e)
                # a dead waiter frees no more slots: wake the fill thread
                # (parked in submit) and the consumer; the error then
                # propagates at __next__
                self._stop.set()
                self._sem.release()
                return
            seconds = time.perf_counter() - t0
            if self._metrics is not None:
                self._metrics.record_h2d(nbytes, seconds, exposed_s=self._take_stall())
            if self._journal is not None:
                self._journal.emit("feeder.fill", span=span, num_steps=n, nbytes=nbytes,
                                   put_s=round(seconds, 6))
            ok = self._deliver(item, n, span)
            self._sem.release()
            if not ok:
                return


class DeviceFeeder:
    """Double-buffered host→device prefetch. Wraps a callable returning an
    iterator of feed dicts; ``__iter__`` yields dicts of tensors on the
    card while the next ``capacity`` batches are copied in the background.

    ``device`` is the CUDA card (the default); a CPU target is refused,
    since it has no stream to copy on and a synchronous copy would hide
    nothing. ``put_fn`` replaces the pinned side-stream copy with another
    transform of each batch, run on the fill thread (the CPU tests drive
    the thread's contract that way); ``put_stacked_fn`` (default:
    ``put_fn``) puts a K-batch chunk.

    With ``stack_k=K > 1`` the fill thread stacks K host batches into a
    super-batch and the iterator yields ``(n, feed)`` pairs: ``n == K``
    for full chunks, ``n == 1`` (unstacked) for remainder or
    shape-mismatched batches. ``encode_fn`` runs on the fill thread, per
    batch, before stacking. ``metrics`` (a :class:`PipelineMetrics`)
    takes each stage's time: the reader wait, the encode (with
    ``logical_nbytes_fn``'s bytes against the encoded ones), the stack,
    the transfer to its completion (the fill thread waits on the staging
    event, so ``h2d_mbps`` measures the link) and the dispatch wait; the
    consumer's waits count as starvation.

    ``overlap_depth`` (default 2) puts, with metrics or a ``wait_fn``, go
    through the staging ring (see the module): up to that many copies in
    flight, each waited on by ``wait_fn(item, t_submit)`` (default: its
    CUDA event) on a waiter thread; ``overlap_depth=1`` is the blocking
    put, which waits inline (``wait_fn``, else the event) before the next
    batch is read.

    ``journal`` (a :class:`paddle_tpu_torch.telemetry.RunJournal`) mints one
    span a chunk on the fill thread and emits a ``feeder.fill`` event once
    its transfer is put (``num_steps``, ``nbytes``, ``put_s``);
    :attr:`last_span` holds the span of the item last yielded, which
    ``fit`` passes to ``trainer.step``/``run_steps``.

    The fill thread is cancellable: abandoning the iterator (break,
    exception, gc) or calling :meth:`close` stops it even while it waits
    on a full queue. An exception on the fill thread (the reader's, or a
    copy's) is re-raised at ``__next__`` after the batches already
    delivered to the queue, never a silent end of the epoch."""

    def __init__(self, batches: Callable[[], Iterator[Dict[str, Any]]], device=None,
                 capacity: int = 2, put_fn: Optional[Callable] = None, stack_k: int = 1,
                 put_stacked_fn: Optional[Callable] = None,
                 encode_fn: Optional[Callable] = None,
                 metrics: Optional[PipelineMetrics] = None,
                 logical_nbytes_fn: Optional[Callable] = None, journal=None,
                 overlap_depth: int = 2, wait_fn: Optional[Callable] = None):
        self.batches = batches
        self.capacity = max(1, int(capacity))
        self.stack_k = max(1, int(stack_k))
        self.encode_fn = encode_fn
        self.metrics = metrics
        self.logical_nbytes_fn = logical_nbytes_fn or host_feed_nbytes
        self.journal = journal
        self.overlap_depth = max(1, int(overlap_depth))
        self.wait_fn = wait_fn
        # the span of the item the iterator last yielded (fit passes it to
        # the dispatch, so the feeder.fill and trainer.dispatch events of
        # one batch share it)
        self.last_span: Optional[str] = None
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
        self.put_stacked_fn = put_stacked_fn or put_fn
        self._stops: List[threading.Event] = []
        self._threads: List[threading.Thread] = []

    def pipeline_report(self) -> Optional[Dict[str, Any]]:
        """The accumulated :meth:`PipelineMetrics.report`, or None
        without metrics."""
        return self.metrics.report() if self.metrics is not None else None

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

    def _putter(self, n: int) -> Callable:
        return self.put_stacked_fn if n > 1 else self.put_fn

    def _put(self, n: int, host_feed: Dict[str, Any]):
        """Fill thread, the blocking put: one batch or chunk to the card,
        waited on to its completion under ``metrics`` or a ``wait_fn``."""
        put = self._putter(n)
        if self.metrics is None and self.wait_fn is None:
            return put(host_feed)
        nbytes = host_feed_nbytes(host_feed)
        t0 = time.perf_counter()
        item = put(host_feed)
        if self.wait_fn is not None:
            self.wait_fn(item, t0)
        else:
            wait_staged(item)
        if self.metrics is not None:
            self.metrics.record_h2d(nbytes, time.perf_counter() - t0)
        return item

    def _host_batches(self) -> Iterator[Dict[str, Any]]:
        """Fill thread: the reader's batches, its waits timed and each one
        encoded, before chunking."""
        m, enc = self.metrics, self.encode_fn
        it = iter(self.batches())
        while True:
            t0 = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                return
            if m is not None:
                m.record_batch(time.perf_counter() - t0)
            if enc is not None:
                t0 = time.perf_counter()
                logical = self.logical_nbytes_fn(b) if m is not None else 0
                b = enc(b)
                if m is not None:
                    m.record_encode(time.perf_counter() - t0, logical, host_feed_nbytes(b))
            yield b

    def _deliver(self, item):
        """Consumer thread: make its stream wait for the batch's copies."""
        n, item, self.last_span = item
        if isinstance(item, _Staged):
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(item.ready)
            for t in item.tensors.values():
                t.record_stream(stream)
            item = item.tensors
        return (n, item) if self.stack_k > 1 else item

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
        metrics = self.metrics

        def put(item, timed: bool = True) -> bool:
            # a bounded wait: a consumer that stopped must not strand this
            # thread (and the batches it holds) forever; the time blocked
            # here is the dispatch wait
            t0 = time.perf_counter()
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    if timed and metrics is not None:
                        metrics.add("dispatch", time.perf_counter() - t0)
                    return True
                except _queue.Full:
                    continue
            return False

        journal = self.journal

        def fill_event(n, hb):
            """One chunk's transfer and its ``feeder.fill`` event (the span
            minted here, on the fill thread; the consumer reuses it for the
            dispatch)."""
            if journal is None:
                return self._put(n, hb), None
            span = journal.new_span()
            t0 = time.perf_counter()
            item = self._put(n, hb)
            journal.emit("feeder.fill", span=span, num_steps=n, nbytes=host_feed_nbytes(hb),
                         put_s=round(time.perf_counter() - t0, 6))
            return item, span

        ring = None
        if self.overlap_depth >= 2 and (metrics is not None or self.wait_fn is not None):
            ring = _StagingRing(self.overlap_depth, lambda item, n, span: put((n, item, span)),
                                stop, metrics=metrics, wait_fn=self.wait_fn,
                                journal=journal, on_error=err.append)
            self._threads.append(ring._thread)

        def fill():
            try:
                chunks = (_host_chunks(self._host_batches(), self.stack_k, metrics)
                          if self.stack_k > 1 else ((1, b) for b in self._host_batches()))
                for n, hb in chunks:
                    if stop.is_set():
                        return
                    if ring is not None:
                        if not ring.submit(n, hb, self._putter(n)):
                            return
                    elif not put((n, *fill_event(n, hb))):
                        return
            except BaseException as e:  # re-raised on the consumer's side
                err.append(e)
            finally:
                # END trails every put still in flight in the ring
                if ring is not None:
                    ring.finish()
                if not put(END, timed=False):
                    try:  # stopped: wake a consumer parked in q.get()
                        q.put_nowait(END)
                    except _queue.Full:
                        pass

        t = threading.Thread(target=fill, name="DeviceFeeder.fill", daemon=True)
        t.start()
        self._threads.append(t)
        try:
            while True:
                t_wait = time.perf_counter()
                try:
                    item = q.get(timeout=0.5)
                    if metrics is not None and item is not END:
                        metrics.record_starved(time.perf_counter() - t_wait)
                except _queue.Empty:
                    if metrics is not None:
                        metrics.record_starved(time.perf_counter() - t_wait)
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


__all__ = ["DataFeeder", "DeviceFeeder", "PipelineMetrics", "host_feed_nbytes",
           "iter_chunked", "stack_batches", "wait_staged"]
