"""Serving runtime: bounded-queue predictor server with request
validation, shape bucketing, deadlines and continuous batching (the core
of ``paddle_tpu.serving.PredictorServer``).

- **Typed request validation** — a malformed request (missing/extra feed
  key, shape/dtype mismatch, non-finite payload) raises
  :class:`InvalidRequest` naming the offending field at ``submit`` time,
  before it can occupy queue capacity.
- **Shape bucketing** — requests are padded up to the exported bucket
  set (``save_inference_model(batch_buckets=...)``); off-bucket shapes
  that fit no bucket are rejected.
- **Bounded queue + deadlines** — saturation raises
  :class:`ServerOverloaded`; a request whose deadline passes while
  queued is dropped without executing.
- **Continuous batching** — with a ``batch_policy``
  (:class:`paddle_tpu_torch.fleet.BatchPolicy`) workers coalesce queued
  requests into one bucket-sized dispatch and slice the outputs back per
  caller.
- **Drain** — :meth:`PredictorServer.close(drain=True)` finishes queued
  work before stopping; :class:`ServingMetrics` holds the latency/queue/
  error counters behind :meth:`PredictorServer.report`.
- **Telemetry** — every request carries a span minted at submit
  (:attr:`PendingResult.span`) through its journal events
  (``serving.submit``, ``serving.reject``, ``serving.expired``,
  ``serving.dispatch``, ``serving.complete``, ``serving.error``); the
  server's counters, latency histogram and queue gauges publish into the
  process registry under the JAX package's names, behind
  :meth:`PredictorServer.serve_metrics` and :meth:`PredictorServer.ship_to`.

The circuit breaker, watchdog and hot reload of the JAX package, and the
journal events and flight dumps they write, come with ROADMAP item 23.
"""

from __future__ import annotations

import bisect
import logging
import queue as _queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from .core.errors import EnforceError
from .fleet import batching as _batching
from .io import InvalidRequest, _block_on


def _log():
    return logging.getLogger("paddle_tpu_torch.serving")


# -- typed serving errors -----------------------------------------------------


class ServingError(EnforceError):
    """Base of every typed serving-runtime error."""


class ServerOverloaded(ServingError):
    """The bounded work queue is full — shed load instead of growing
    memory. Carries ``queue_depth``/``capacity`` for the reject reply."""

    def __init__(self, queue_depth: int, capacity: int):
        super().__init__(f"server overloaded: queue depth {queue_depth} at "
                         f"capacity {capacity}")
        self.queue_depth = queue_depth
        self.capacity = capacity


class DeadlineExceeded(ServingError, TimeoutError):
    """The request's deadline passed before a result was produced."""


class ServerClosed(ServingError):
    """submit() after close()/drain started — also the outcome of a
    request that was accepted but never dispatched when its server
    stopped."""


# -- latency histogram --------------------------------------------------------

# log-spaced upper bounds, 50us .. ~80s, ratio ~1.3 (55 buckets): fixed
# memory, ~15% percentile resolution
_HIST_BOUNDS = tuple(50e-6 * (1.3 ** i) for i in range(55))


class LatencyHistogram:
    """Fixed-bucket log-scale latency histogram (seconds in, percentiles
    out). Not thread-safe on its own — ServingMetrics holds the lock."""

    def __init__(self):
        self.counts = [0] * (len(_HIST_BOUNDS) + 1)
        self.total = 0
        self.sum_s = 0.0
        self.max_s = 0.0

    def record(self, seconds: float) -> None:
        self.counts[bisect.bisect_left(_HIST_BOUNDS, seconds)] += 1
        self.total += 1
        self.sum_s += seconds
        self.max_s = max(self.max_s, seconds)

    def percentile(self, p: float) -> Optional[float]:
        """Upper bound of the bucket holding the p-th percentile (p in
        [0, 100]); None when empty."""
        if not self.total:
            return None
        rank = p / 100.0 * self.total
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return (_HIST_BOUNDS[i] if i < len(_HIST_BOUNDS)
                        else self.max_s)
        return self.max_s


# -- metrics ------------------------------------------------------------------


class ServingMetrics:
    """Thread-safe serving counters + latency histogram, surfaced via
    :meth:`PredictorServer.report`."""

    _COUNTERS = ("submitted", "completed", "rejected_invalid",
                 "rejected_overload", "timeouts", "errors",
                 "coalesced_batches", "coalesced_requests")

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            for c in self._COUNTERS:
                setattr(self, c, 0)
            self.hist = LatencyHistogram()

    def bump(self, counter: str, by: int = 1):
        with self._lock:
            setattr(self, counter, getattr(self, counter) + by)

    def record_latency(self, seconds: float):
        with self._lock:
            self.hist.record(seconds)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out = {c: getattr(self, c) for c in self._COUNTERS}
            h = self.hist
            out["latency_ms"] = {
                "p50": _ms(h.percentile(50)), "p95": _ms(h.percentile(95)),
                "p99": _ms(h.percentile(99)), "max": _ms(h.max_s or None),
                "mean": _ms(h.sum_s / h.total if h.total else None),
                "count": h.total,
            }
            # the raw histogram (upper bounds in seconds, per-bucket counts
            # with one overflow bucket): the registry's histogram family
            out["latency_hist"] = {"bounds_s": list(_HIST_BOUNDS), "counts": list(h.counts),
                                   "sum_s": h.sum_s, "count": h.total}
            return out

    def telemetry_families(self, inst: str = "0") -> list:
        """The same counters and histogram as the JAX package's
        ``paddle_tpu_serving_*`` registry families (serving.py:348), read
        from :meth:`snapshot` at scrape time, so they agree with
        :meth:`PredictorServer.report`."""
        from .telemetry.registry import counter_family, histogram_family

        snap = self.snapshot()
        labels = {"inst": inst}
        fams = [
            counter_family("paddle_tpu_serving_submitted_total",
                           "Requests accepted into the queue", [(labels, snap["submitted"])]),
            counter_family("paddle_tpu_serving_completed_total",
                           "Requests completed successfully", [(labels, snap["completed"])]),
            counter_family("paddle_tpu_serving_rejected_total",
                           "Requests rejected at submit (by reason)",
                           [({**labels, "reason": r}, snap[f"rejected_{r}"])
                            for r in ("invalid", "overload")]),
            counter_family("paddle_tpu_serving_timeouts_total",
                           "Requests dropped at their deadline", [(labels, snap["timeouts"])]),
            counter_family("paddle_tpu_serving_errors_total",
                           "Requests failed by an executable error", [(labels, snap["errors"])]),
            counter_family("paddle_tpu_serving_coalesced_batches_total",
                           "Dispatches that coalesced >1 request",
                           [(labels, snap["coalesced_batches"])]),
            counter_family("paddle_tpu_serving_coalesced_requests_total",
                           "Requests served inside a coalesced dispatch",
                           [(labels, snap["coalesced_requests"])]),
        ]
        h = snap["latency_hist"]
        fams.append(histogram_family(
            "paddle_tpu_serving_latency_seconds",
            "End-to-end served latency (queue wait included)",
            labels, h["bounds_s"], h["counts"], h["sum_s"], h["count"]))
        return fams


def _ms(seconds: Optional[float]) -> Optional[float]:
    return None if seconds is None else round(seconds * 1e3, 4)


# -- requests -----------------------------------------------------------------


class _Request:
    __slots__ = ("feed", "n", "bucket", "deadline", "done", "value", "error",
                 "submitted", "completed", "span")

    def __init__(self, feed, n, bucket, deadline, span=None):
        self.feed = feed
        self.n = n
        self.bucket = bucket
        self.deadline = deadline      # absolute monotonic, or None
        self.done = threading.Event()
        self.value = None
        self.error: Optional[BaseException] = None
        self.submitted = time.monotonic()
        self.completed: Optional[float] = None
        self.span = span              # trace id minted at submit


class PendingResult:
    """Handle returned by :meth:`PredictorServer.submit`."""

    def __init__(self, req: _Request):
        self._req = req

    def done(self) -> bool:
        return self._req.done.is_set()

    @property
    def span(self) -> Optional[str]:
        """The request's trace id (minted at submit): every journal event
        of its life carries it."""
        return self._req.span

    @property
    def latency(self) -> Optional[float]:
        """End-to-end seconds (queue wait included) once complete."""
        r = self._req
        return None if r.completed is None else r.completed - r.submitted

    def result(self, timeout: Optional[float] = None):
        """Block for the outcome; raises the request's typed error, or
        :class:`DeadlineExceeded` when ``timeout``/the request deadline
        passes first (the request itself is then dropped unexecuted by
        the worker that dequeues it)."""
        r = self._req
        if timeout is None and r.deadline is not None:
            timeout = max(0.0, r.deadline - time.monotonic()) + 1.0
        if not r.done.wait(timeout):
            raise DeadlineExceeded(
                f"no result within {timeout:.2f}s (request still queued or "
                "executing; it will be dropped at its deadline)")
        if r.error is not None:
            raise r.error
        return r.value


# -- the server ---------------------------------------------------------------


class _Worker:
    __slots__ = ("thread", "busy_since", "carry", "index")

    def __init__(self, index: int):
        self.index = index
        self.thread: Optional[threading.Thread] = None
        self.busy_since: Optional[float] = None
        # requests pulled while coalescing that could not join the
        # forming batch — served FIRST on the next loop iteration
        self.carry: List[_Request] = []


class PredictorServer:
    """Bounded-queue serving runtime over a pool of ``Predictor.clone()``
    workers (one clone per worker thread; the program and its device
    weights are shared).

    ``predictor`` needs the :class:`paddle_tpu_torch.io.Predictor`
    surface: ``clone()``, ``run(feed)``, ``feed_names``,
    ``batch_buckets``, ``batched_feeds``, ``feed_spec(b)``,
    ``validate_feed(feed, allow_padding=)``.

    Request flow: :meth:`submit` validates structurally (typed
    :class:`InvalidRequest`) and enqueues (reject
    :class:`ServerOverloaded` when full) → a worker pads the batch up to
    its bucket, executes, slices the outputs back to the request's batch
    size, and completes the :class:`PendingResult`. :meth:`run` is the
    synchronous wrapper.

    ``batch_policy`` (a :class:`paddle_tpu_torch.fleet.BatchPolicy`)
    turns on continuous batching: workers coalesce queued requests into
    the largest bucket that fits within the policy's wait budget and
    slice outputs back per caller by row span."""

    def __init__(self, predictor, workers: int = 2, queue_size: int = 32,
                 batch_policy=None, warmup: bool = True):
        self._predictor = predictor
        self.num_workers = int(workers)
        self.queue_size = int(queue_size)
        self.batch_policy = batch_policy
        self._queue: _queue.Queue = _queue.Queue(maxsize=self.queue_size)
        self._complete_lock = threading.Lock()
        self.metrics = ServingMetrics()
        self._workers: List[_Worker] = []
        self._stop = threading.Event()
        self._state = "starting"
        self._state_lock = threading.Lock()
        self._started_at = time.monotonic()
        # telemetry: journal spans a request, a scrape-time collector in the
        # process registry (the inst label keeps servers apart), the
        # PDTPU_TELEMETRY_ADDR shipper
        from .telemetry import get_journal, get_registry
        from .telemetry.shipper import maybe_auto_ship
        self.journal = get_journal()
        self.telemetry_inst = get_registry().next_instance("serving")
        self._telemetry_server = None
        maybe_auto_ship()
        # spawn the workers, run every bucket once (``warmup``), then
        # accept requests
        for i in range(self.num_workers):
            self._spawn_worker(i)
        if warmup:
            clone = predictor.clone()
            for b in predictor.batch_buckets:
                _block_on(clone.run({k: np.zeros(shape, dtype) for k, (shape, dtype)
                                     in predictor.feed_spec(b).items()}))
        # registered last: a scrape must never see a half-built server
        self._telemetry_cid = get_registry().add_collector(
            PredictorServer.telemetry_families, owner=self)
        with self._state_lock:
            self._state = "ready"

    # -- lifecycle -----------------------------------------------------------

    def close(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Stop the server. ``drain=True`` finishes every queued request
        first; ``drain=False`` fails queued requests fast with
        :class:`ServerClosed`. Idempotent."""
        with self._state_lock:
            if self._state == "stopped":
                return
            self._state = "draining" if drain else "stopping"
        deadline = None if timeout is None else time.monotonic() + timeout
        if drain:
            # carried (coalescer-deferred) requests count as pending work
            while not self._queue.empty() or any(
                    w.busy_since is not None or w.carry
                    for w in self._workers):
                if deadline is not None and time.monotonic() > deadline:
                    break
                time.sleep(0.005)
        self._stop.set()
        # fail anything STILL queued: workers exit without dequeuing once
        # the stop flag is set, and a stranded request would block its
        # client's result() forever
        while True:
            try:
                req = self._queue.get_nowait()
            except _queue.Empty:
                break
            self._complete(req, error=ServerClosed("server stopping"))
        for w in self._workers:
            if w.thread is not None and w.thread is not threading.current_thread():
                w.thread.join(timeout=5.0)
        for w in self._workers:
            for r in w.carry:
                self._complete(r, error=ServerClosed("server stopping"))
            w.carry = []
        with self._state_lock:
            self._state = "stopped"
        if self._telemetry_server is not None:
            self._telemetry_server.close()
            self._telemetry_server = None
        # a closed server stops exporting live-looking queue and worker gauges
        from .telemetry import get_registry
        get_registry().remove_collector(self._telemetry_cid)

    def __enter__(self) -> "PredictorServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=True)

    # -- request path --------------------------------------------------------

    def submit(self, feed: Dict[str, Any], deadline: Optional[float] = None,
               span: Optional[str] = None) -> PendingResult:
        """Validate + enqueue one request; returns a
        :class:`PendingResult`. ``deadline`` is seconds from now (None:
        no deadline); raises :class:`InvalidRequest` (also for a
        non-finite float payload), :class:`ServerOverloaded` or
        :class:`ServerClosed`. ``span`` adopts a trace id minted elsewhere
        instead of minting one."""
        with self._state_lock:
            state = self._state
        if state != "ready":
            raise ServerClosed(f"server is {state}")
        span = span or self.journal.new_span()
        try:
            n, bucket = self._predictor.validate_feed(feed, allow_padding=True)
            _check_finite(feed, self._predictor.feed_names)
        except InvalidRequest as e:
            self.metrics.bump("rejected_invalid")
            self.journal.emit("serving.reject", span=span, inst=self.telemetry_inst,
                              reason="invalid", field=getattr(e, "field", None))
            raise
        req = _Request(feed, n, bucket,
                       None if deadline is None else time.monotonic() + deadline, span=span)
        # journaled before the enqueue: a worker may dispatch it at once,
        # and a span's timeline must never read dispatch before submit
        self.journal.emit("serving.submit", span=span, inst=self.telemetry_inst, n=n,
                          bucket=bucket, deadline_s=deadline,
                          queue_depth=self._queue.qsize())
        # state re-check + enqueue are atomic under the state lock: close()
        # flips the state under the same lock before draining, so a
        # request can never slip into the queue after the drain loop
        # decided it was empty
        with self._state_lock:
            if self._state != "ready":
                raise ServerClosed(f"server is {self._state}")
            try:
                self._queue.put_nowait(req)
            except _queue.Full:
                self.metrics.bump("rejected_overload")
                self.journal.emit("serving.reject", span=span, inst=self.telemetry_inst,
                                  reason="overload", queue_depth=self._queue.qsize())
                raise ServerOverloaded(self._queue.qsize(),
                                       self.queue_size) from None
        self.metrics.bump("submitted")
        return PendingResult(req)

    def run(self, feed: Dict[str, Any], timeout: Optional[float] = None):
        """Synchronous submit+wait (``timeout`` doubles as the request
        deadline)."""
        return self.submit(feed, deadline=timeout).result(timeout)

    # -- worker machinery ----------------------------------------------------

    def _spawn_worker(self, index: int) -> _Worker:
        w = _Worker(index)
        w.thread = threading.Thread(target=self._worker_loop, args=(w,),
                                    daemon=True,
                                    name=f"pdtorch-serving-worker-{index}")
        w.thread.start()
        self._workers.append(w)
        return w

    def _admit(self, req: _Request) -> Optional[_Request]:
        """Dequeue-time admission: a request whose deadline passed while
        queued is dropped WITHOUT executing. Returns the request, or None
        after completing it with :class:`DeadlineExceeded`."""
        now = time.monotonic()
        if req.deadline is not None and now > req.deadline:
            self.metrics.bump("timeouts")
            self.journal.emit("serving.expired", span=req.span, inst=self.telemetry_inst,
                              late_s=round(now - req.deadline, 6))
            self._complete(req, error=DeadlineExceeded(
                f"deadline passed {now - req.deadline:.3f}s before "
                "dispatch"))
            return None
        return req

    def _coalesce(self, w: _Worker, first: _Request) -> List[_Request]:
        """Form a coalesced group seeded by ``first``: already-queued
        requests are taken for free, then the worker waits up to the
        policy's ``max_wait_ms`` past ``first``'s submit (never past the
        tightest deadline in the forming group) for more. Stops at the
        largest bucket, the policy's ``max_requests``, or the first
        incompatible candidate (different non-batched feed bytes, or it
        would overflow the bucket) — which is CARRIED and seeds this
        worker's next dispatch, never reordered behind later traffic."""
        pol = self.batch_policy
        pred = self._predictor
        max_rows, wait_ms = pol.plan(self._queue.qsize(), first.n,
                                     pred.batch_buckets)
        group = [first]
        total = first.n
        key = _batching.nonbatched_key(first.feed, pred.feed_names,
                                       pred.batched_feeds)
        hold_until = first.submitted + wait_ms / 1e3
        while total < max_rows and not self._stop.is_set():
            if pol.max_requests is not None and \
                    len(group) >= pol.max_requests:
                break
            limit = hold_until
            for r in group:
                if r.deadline is not None:
                    limit = min(limit, r.deadline)
            wait = limit - time.monotonic()
            try:
                cand = (self._queue.get_nowait() if wait <= 0
                        else self._queue.get(timeout=min(wait, 0.02)))
            except _queue.Empty:
                if wait <= 0:
                    break
                continue
            cand = self._admit(cand)
            if cand is None:
                continue
            if total + cand.n > max_rows or _batching.nonbatched_key(
                    cand.feed, pred.feed_names,
                    pred.batched_feeds) != key:
                w.carry.append(cand)
                break
            group.append(cand)
            total += cand.n
        return group

    def _worker_loop(self, w: _Worker) -> None:
        pred = self._predictor
        clone = pred.clone()
        while not self._stop.is_set():
            if w.carry:
                req = w.carry.pop(0)
            else:
                try:
                    req = self._queue.get(timeout=0.05)
                except _queue.Empty:
                    continue
            req = self._admit(req)
            if req is None:
                continue
            group = ([req] if self.batch_policy is None
                     else self._coalesce(w, req))
            total = sum(r.n for r in group)
            bucket = (req.bucket if len(group) == 1
                      else _batching.pick_bucket(total, pred.batch_buckets))
            spans = _batching.row_spans(group)
            w.busy_since = now = time.monotonic()
            for (off, n), r in zip(spans, group):
                extra = {"coalesced": len(group), "row": off} if len(group) > 1 else {}
                self.journal.emit("serving.dispatch", span=r.span, inst=self.telemetry_inst,
                                  worker=w.index, n=n, bucket=bucket,
                                  queued_s=round(now - r.submitted, 6), **extra)
            try:
                feed = (self._pad(pred, req) if len(group) == 1
                        else _batching.merge_feeds(group, pred.feed_names,
                                                   pred.batched_feeds,
                                                   bucket))
                out = clone.run(feed)
                _block_on(out)
            except Exception as e:
                # a boundary that must keep serving: the failure goes to
                # each caller of the group, the worker lives on
                _log().exception("dispatch of %d request(s) failed",
                                 len(group))
                for r in group:
                    if self._complete(r, error=e):
                        self.metrics.bump("errors")
                        self.journal.emit("serving.error", span=r.span,
                                          inst=self.telemetry_inst, worker=w.index,
                                          error=f"{type(e).__name__}: {e}"[:300])
            else:
                if len(group) > 1:
                    self.metrics.bump("coalesced_batches")
                    self.metrics.bump("coalesced_requests", by=len(group))
                done_t = time.monotonic()
                for (off, n), r in zip(spans, group):
                    sliced = _batching.slice_rows(out, off, n, bucket)
                    if self._complete(r, value=sliced):
                        latency = done_t - r.submitted
                        self.metrics.bump("completed")
                        self.metrics.record_latency(latency)
                        extra = {"coalesced": len(group)} if len(group) > 1 else {}
                        self.journal.emit("serving.complete", span=r.span,
                                          inst=self.telemetry_inst, worker=w.index,
                                          latency_s=round(latency, 6), **extra)
            finally:
                w.busy_since = None
        # loop exit with requests still carried (the stop flag raced the
        # coalescer): they were never dispatched
        for r in w.carry:
            self._complete(r, error=ServerClosed("server stopping"))
        w.carry = []

    @staticmethod
    def _pad(predictor, req: _Request) -> Dict[str, Any]:
        """Pad batched feeds up to the bucket (zeros — the pad rows are
        sliced off the outputs)."""
        if req.n == req.bucket:
            return req.feed
        out = {}
        for k in predictor.feed_names:
            v = np.asarray(req.feed[k])
            if k in predictor.batched_feeds:
                pad = np.zeros((req.bucket - req.n,) + v.shape[1:], v.dtype)
                v = np.concatenate([v, pad], axis=0)
            out[k] = v
        return out

    def _complete(self, req: _Request, value=None,
                  error: Optional[BaseException] = None) -> bool:
        """First completion wins, atomically (a worker and close() may
        race to complete the same request)."""
        with self._complete_lock:
            if req.done.is_set():
                return False
            req.error = error
            req.value = value
            req.completed = time.monotonic()
            req.done.set()
            return True

    # -- observability -------------------------------------------------------

    def health(self) -> Dict[str, Any]:
        """Readiness/liveness: ``starting`` → ``ready`` (``overloaded``
        while the queue is full) → ``draining`` → ``stopped``."""
        with self._state_lock:
            state = self._state
        if state == "ready" and self._queue.full():
            state = "overloaded"
        alive = [w for w in self._workers
                 if w.thread is not None and w.thread.is_alive()]
        return {
            "live": state != "stopped" and bool(alive),
            "ready": state in ("ready", "overloaded"),
            "state": state,
            "queue_depth": self._queue.qsize(),
            "queue_capacity": self.queue_size,
            "workers": len(alive),
            "workers_busy": sum(1 for w in alive if w.busy_since is not None),
            "uptime_s": round(time.monotonic() - self._started_at, 3),
        }

    def telemetry_families(self) -> list:
        """This server's registry export (serving.py:1356): every
        :class:`ServingMetrics` counter and the latency histogram (the
        store :meth:`report` reads) plus the live queue and worker gauges.
        The process registry's collector calls it at scrape time."""
        from .telemetry.registry import gauge_family

        labels = {"inst": self.telemetry_inst}
        fams = self.metrics.telemetry_families(self.telemetry_inst)
        alive = [w for w in self._workers if w.thread is not None and w.thread.is_alive()]
        fams.extend([
            gauge_family("paddle_tpu_serving_queue_depth", "Requests currently queued",
                         [(labels, self._queue.qsize())]),
            gauge_family("paddle_tpu_serving_queue_capacity", "Bounded queue capacity",
                         [(labels, self.queue_size)]),
            gauge_family("paddle_tpu_serving_workers", "Live (non-abandoned) workers",
                         [(labels, len(alive))]),
            gauge_family("paddle_tpu_serving_workers_busy",
                         "Workers currently executing a dispatch",
                         [(labels, sum(1 for w in alive if w.busy_since is not None))]),
        ])
        return fams

    def serve_metrics(self, port: int = 0, host: str = "127.0.0.1"):
        """Start the ``GET /metrics`` (Prometheus text of the process
        registry; this server's series carry its ``inst`` label) and
        ``GET /healthz`` (this server's :meth:`health`; 503 once not live)
        endpoint. Port 0 picks a free port (``.port``); :meth:`close`
        stops it."""
        from .telemetry import serve_metrics as _serve

        if self._telemetry_server is None:
            self._telemetry_server = _serve(health_fn=self.health, port=port, host=host)
        return self._telemetry_server

    def ship_to(self, addr, origin=None, **kw):
        """Attach the process telemetry shipper to a collector at ``addr``
        (as ``Trainer.ship_to``). Returns the
        :class:`~paddle_tpu_torch.telemetry.shipper.Shipper`."""
        from .telemetry.shipper import ship_to as _ship_to

        return _ship_to(addr, origin=origin, **kw)

    def report(self) -> Dict[str, Any]:
        """Metrics + health in one dict: latency percentiles, queue depth,
        reject/timeout/error counters, coalescing counters."""
        out = self.metrics.snapshot()
        out["health"] = self.health()
        out["batch_buckets"] = list(self._predictor.batch_buckets)
        return out


# -- helpers ------------------------------------------------------------------


def _check_finite(feed: Dict[str, Any], feed_names) -> None:
    for k in feed_names:
        v = np.asarray(feed[k])
        if v.dtype.kind == "f" and not np.isfinite(v).all():
            raise InvalidRequest(k, "contains non-finite values "
                                 "(NaN/Inf payload rejected)")


__all__ = [
    "DeadlineExceeded", "InvalidRequest", "LatencyHistogram",
    "PendingResult", "PredictorServer", "ServerClosed", "ServerOverloaded",
    "ServingError", "ServingMetrics",
]
