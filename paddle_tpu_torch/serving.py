"""Serving runtime: bounded-queue predictor server with request
validation, shape bucketing, deadlines, continuous batching, a circuit
breaker, a dispatch watchdog, hot model reload and health signals
(counterpart of ``paddle_tpu.serving``).

- **Typed request validation** — a malformed request (missing/extra feed
  key, shape/dtype mismatch, non-finite payload) raises
  :class:`InvalidRequest` naming the offending field at ``submit`` time,
  before it can occupy queue capacity.
- **Shape bucketing** — requests are padded up to the exported bucket
  set (``save_inference_model(batch_buckets=...)``); off-bucket shapes
  that fit no bucket are rejected, and the process's preparation count
  (``io.aot_compile_count``) is pinned after warm-up
  (``report()["compiles_since_warmup"]`` stays 0).
- **Bounded queue + deadlines** — saturation raises
  :class:`ServerOverloaded`; a request whose deadline passes while
  queued is dropped without executing.
- **Continuous batching** — with a ``batch_policy``
  (:class:`paddle_tpu_torch.fleet.BatchPolicy`) workers coalesce queued
  requests into one bucket-sized dispatch and slice the outputs back per
  caller.
- **Watchdog + circuit breaker** — a dispatch that hangs past the
  watchdog timeout, or repeated failures, trip the breaker: later
  submits fail fast with :class:`CircuitOpen`, and after a cooldown a
  half-open probe request recovers the pool. A hung worker thread
  cannot be killed: it is abandoned (its requests fail with
  :class:`WorkerHung`, work it queued on the card may still run) and a
  new worker takes its place.
- **Kill** — :meth:`PredictorServer.kill` is the in-process stand-in for
  the serving process dying: queued requests fail :class:`ServerClosed`
  (a router may resubmit them), dispatched ones :class:`ReplicaDied`,
  at most once.
- **Hot reload** — :meth:`PredictorServer.reload` loads and
  CRC-validates a new artifact off-thread, canaries it on a golden feed
  and swaps it in; any failure rolls back with no request dropped.
- **Drain** — :meth:`PredictorServer.close(drain=True)` finishes queued
  work before stopping; :class:`ServingMetrics` holds the latency/queue/
  error counters behind :meth:`PredictorServer.report`.
- **Telemetry** — every request carries a span minted at submit
  (:attr:`PendingResult.span`) through its journal events
  (``serving.submit``, ``serving.reject``, ``serving.expired``,
  ``serving.dispatch``, ``serving.complete``, ``serving.error``,
  ``serving.hang``, ``serving.killed``); the breaker's trips
  (``serving.breaker_open``) and reloads (``serving.reload``) are
  journaled too, and a hang, a kill and a failure trip write a flight
  dump (``worker_hung``, ``replica_killed``, ``breaker_trip``). The
  server's counters, latency histogram, queue, breaker and generation
  gauges publish into the process registry under the JAX package's
  names, behind :meth:`PredictorServer.serve_metrics` and
  :meth:`PredictorServer.ship_to`.

On the card a dispatch waits for its own outputs (an event on its
thread's stream, ``io._block_on``), never for the whole device, so a
replica serving beside another replica's CUDA-graph capture (a warm-up,
a reload's candidate) neither waits on nor disturbs it.
"""

from __future__ import annotations

import bisect
import dataclasses
import logging
import queue as _queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

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


class CircuitOpen(ServingError):
    """The circuit breaker is open (recent failures/hangs): failing fast
    instead of queueing onto a broken executable. ``retry_after`` is the
    seconds until the next half-open probe is allowed."""

    def __init__(self, retry_after: float):
        super().__init__(f"circuit breaker open: retry after "
                         f"{max(0.0, retry_after):.2f}s")
        self.retry_after = retry_after


class WorkerHung(ServingError):
    """A dispatch exceeded the watchdog timeout; the worker was
    abandoned and its request failed fast."""


class ServerClosed(ServingError):
    """submit() after close()/drain started — also the outcome of a
    request that was accepted but NEVER dispatched when its server
    died or stopped. A router may safely resubmit such a request
    elsewhere (it provably never executed); see
    :class:`~paddle_tpu_torch.fleet.FleetRouter`."""


class ReplicaDied(ServingError):
    """The serving replica died (``PredictorServer.kill`` — the
    in-process stand-in for the process being killed) while this
    request was DISPATCHED on one of its workers. At-most-once: the
    request may or may not have executed, so it is surfaced exactly
    once as this error and never retried — the serving mirror of
    ``PSClient.push``'s ``PushUndelivered``."""


class ReloadFailed(ServingError):
    """Hot reload rejected (corrupt artifact, incompatible signature, or
    canary failure) — the previous model keeps serving."""

    def __init__(self, dirname: str, reason: str):
        super().__init__(f"reload of {dirname!r} failed: {reason} "
                         "(previous model still serving)")
        self.dirname = dirname
        self.reason = reason


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


# -- circuit breaker ----------------------------------------------------------


@dataclasses.dataclass
class BreakerPolicy:
    """Circuit-breaker tuning: ``failure_threshold`` consecutive
    failures (or one watchdog hang) trip it open; after ``cooldown``
    seconds one half-open probe request is let through — success closes
    the breaker, failure re-opens it for another cooldown."""

    failure_threshold: int = 5
    cooldown: float = 30.0


class CircuitBreaker:
    """closed → open → half_open → closed state machine (thread-safe).

    ``on_trip(reason)`` fires AFTER the lock is released whenever the
    breaker (re)opens — reasons ``"failures"`` (threshold trip),
    ``"hang"`` (watchdog :meth:`trip`), ``"probe_failure"`` (half-open
    probe failed). The server uses it to journal the state change and
    flight-record the trip; a raising callback is swallowed (telemetry
    must never wedge the breaker)."""

    def __init__(self, policy: Optional[BreakerPolicy] = None,
                 on_trip: Optional[Callable[[str], Any]] = None):
        self.policy = policy or BreakerPolicy()
        self.on_trip = on_trip
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive = 0
        self._open_until = 0.0
        self._probe_out = False
        self.trips = 0

    def _fire_on_trip(self, reason: str) -> None:
        if self.on_trip is None:
            return
        try:
            self.on_trip(reason)
        except Exception:
            pass

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def acquire(self) -> Optional[str]:
        """Admission check for one request. Returns ``"pass"``
        (breaker closed), ``"probe"`` (the one half-open probe), or
        ``None`` (open: fail fast)."""
        with self._lock:
            if self._state == "closed":
                return "pass"
            now = time.monotonic()
            if self._state == "open" and now >= self._open_until:
                self._state = "half_open"
                self._probe_out = False
            if self._state == "half_open" and not self._probe_out:
                self._probe_out = True
                return "probe"
            return None

    def retry_after(self) -> float:
        with self._lock:
            return self._open_until - time.monotonic()

    def cancel(self, token: Optional[str]) -> None:
        """A request admitted but never executed (validation reject,
        queue-full reject) returns its probe slot."""
        if token != "probe":
            return
        with self._lock:
            if self._state == "half_open":
                self._probe_out = False

    def record(self, token: Optional[str], success: bool) -> None:
        fire = None
        with self._lock:
            if success:
                self._consecutive = 0
                # only the half-open PROBE closes an open breaker — and
                # only while the breaker is still waiting on it: a stale
                # success (an abandoned hung worker — or hung probe —
                # finally returning after a fresh trip) must not mask a
                # tripped pool or bypass the cooldown that trip started
                if token == "probe" and self._state == "half_open":
                    self._state = "closed"
                    self._probe_out = False
                return
            elif token == "probe" or self._state == "half_open":
                self._reopen()
                fire = "probe_failure"
            else:
                self._consecutive += 1
                if self._state == "closed" and \
                        self._consecutive >= self.policy.failure_threshold:
                    self._trip()
                    fire = "failures"
        if fire:
            self._fire_on_trip(fire)

    def trip(self) -> None:
        """Force the breaker open (the watchdog's hung-dispatch path —
        one hang is conclusive, no threshold)."""
        with self._lock:
            self._trip()
        self._fire_on_trip("hang")

    def _trip(self):
        self._state = "open"
        self._open_until = time.monotonic() + self.policy.cooldown
        self._probe_out = False
        self.trips += 1
        _log().warning("circuit breaker OPEN for %.2fs (%d trips)",
                       self.policy.cooldown, self.trips)

    def _reopen(self):
        self._state = "open"
        self._open_until = time.monotonic() + self.policy.cooldown
        self._probe_out = False


# -- metrics ------------------------------------------------------------------


class ServingMetrics:
    """Thread-safe serving counters + latency histogram, surfaced via
    :meth:`PredictorServer.report`."""

    _COUNTERS = ("submitted", "completed", "rejected_invalid",
                 "rejected_overload", "rejected_breaker", "timeouts", "errors",
                 "hangs", "workers_replaced", "reloads", "reload_failures",
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
                            for r in ("invalid", "overload", "breaker")]),
            counter_family("paddle_tpu_serving_timeouts_total",
                           "Requests dropped at their deadline", [(labels, snap["timeouts"])]),
            counter_family("paddle_tpu_serving_errors_total",
                           "Requests failed by an executable error", [(labels, snap["errors"])]),
            counter_family("paddle_tpu_serving_hangs_total",
                           "Dispatches abandoned by the watchdog", [(labels, snap["hangs"])]),
            counter_family("paddle_tpu_serving_workers_replaced_total",
                           "Workers replaced after a watchdog hang",
                           [(labels, snap["workers_replaced"])]),
            counter_family("paddle_tpu_serving_reloads_total", "Hot-reload attempts (by outcome)",
                           [({**labels, "outcome": "ok"}, snap["reloads"]),
                            ({**labels, "outcome": "failed"}, snap["reload_failures"])]),
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
                 "submitted", "completed", "span", "token")

    def __init__(self, feed, n, bucket, deadline, token, span=None):
        self.feed = feed
        self.n = n
        self.bucket = bucket
        self.deadline = deadline      # absolute monotonic, or None
        self.token = token            # breaker admission token
        self.span = span              # trace id minted at submit
        self.done = threading.Event()
        self.value = None
        self.error: Optional[BaseException] = None
        self.submitted = time.monotonic()
        self.completed: Optional[float] = None


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
    __slots__ = ("thread", "busy_since", "request", "group", "carry",
                 "abandoned", "index")

    def __init__(self, index: int):
        self.index = index
        self.thread: Optional[threading.Thread] = None
        self.busy_since: Optional[float] = None
        self.request: Optional[_Request] = None
        # the full coalesced group behind `request` (None = pad-alone)
        self.group: Optional[List[_Request]] = None
        # requests pulled while coalescing that could not join the
        # forming batch — served FIRST on the next loop iteration
        self.carry: List[_Request] = []
        self.abandoned = False


class PredictorServer:
    """Bounded-queue serving runtime over a pool of ``Predictor.clone()``
    workers (one clone per worker thread; the program and its device
    weights are shared).

    ``predictor`` needs the :class:`paddle_tpu_torch.io.Predictor`
    surface: ``clone()``, ``run(feed)``, ``feed_names``,
    ``batch_buckets``, ``batched_feeds``, ``feed_spec(b)``,
    ``validate_feed(feed, allow_padding=)``; the fault-injection
    wrappers in ``paddle_tpu_torch.testing.faults`` duck-type it.

    Request flow: :meth:`submit` validates structurally (typed
    :class:`InvalidRequest`), checks the breaker (fail-fast
    :class:`CircuitOpen`) and enqueues (reject
    :class:`ServerOverloaded` when full) → a worker pads the batch up to
    its bucket, executes, slices the outputs back to the request's batch
    size, and completes the :class:`PendingResult`. :meth:`run` is the
    synchronous wrapper.

    ``golden_feed`` (and an optional ``canary_check(outputs)``) gates hot
    reloads: a candidate model must serve the golden feed with finite
    outputs (and pass ``canary_check``) before it is swapped in.

    ``batch_policy`` (a :class:`paddle_tpu_torch.fleet.BatchPolicy`)
    turns on continuous batching: workers coalesce queued requests into
    the largest bucket that fits within the policy's wait budget and
    slice outputs back per caller by row span."""

    def __init__(self, predictor, workers: int = 2, queue_size: int = 32,
                 default_deadline: Optional[float] = None,
                 breaker: Optional[BreakerPolicy] = None,
                 watchdog_timeout: Optional[float] = 60.0,
                 golden_feed: Optional[Dict[str, Any]] = None,
                 canary_check: Optional[Callable[[Any], Any]] = None,
                 reject_nonfinite: bool = True,
                 batch_policy=None,
                 warmup: bool = True, start: bool = True):
        from . import io as _io

        self._io = _io
        # swapped by a reload under _model_lock; readers take the lock
        # for one reference snapshot (reloads serialize on _reload_lock)
        self._predictor = predictor   # lint: allow(thread:unguarded-access)
        self._generation = 1          # lint: allow(thread:unguarded-access)
        self._model_lock = threading.Lock()
        self._reload_lock = threading.Lock()
        self._last_reload_error: Optional[BaseException] = None
        self.num_workers = int(workers)
        self.queue_size = int(queue_size)
        self.default_deadline = default_deadline
        self.watchdog_timeout = watchdog_timeout
        self.golden_feed = golden_feed
        self.canary_check = canary_check
        self.reject_nonfinite = bool(reject_nonfinite)
        self.batch_policy = batch_policy
        self._do_warmup = bool(warmup)
        self._queue: _queue.Queue = _queue.Queue(maxsize=self.queue_size)
        self._complete_lock = threading.Lock()
        self.metrics = ServingMetrics()
        self._workers: List[_Worker] = []
        self._watchdog: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._state = "starting"
        self._state_lock = threading.Lock()
        self._started_at = time.monotonic()
        self._pinned_compiles: Optional[int] = None
        # telemetry: journal spans a request, a scrape-time collector in the
        # process registry (the inst label keeps servers apart), the
        # PDTPU_TELEMETRY_ADDR shipper
        from .telemetry import get_journal, get_registry
        from .telemetry.shipper import maybe_auto_ship
        self.journal = get_journal()
        self.telemetry_inst = get_registry().next_instance("serving")
        self._telemetry_server = None
        maybe_auto_ship()
        self.breaker = CircuitBreaker(breaker, on_trip=self._on_breaker_trip)
        # registered last: a scrape must never see a half-built server
        self._telemetry_cid = get_registry().add_collector(
            PredictorServer.telemetry_families, owner=self)
        if start:
            self.start()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "PredictorServer":
        """Spawn workers + watchdog, warm every bucket once, pin the
        compile count, flip readiness."""
        with self._state_lock:
            if self._state != "starting":
                return self
        for i in range(self.num_workers):
            self._spawn_worker(i)
        if self.watchdog_timeout is not None:
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, daemon=True,
                name="pdtorch-serving-watchdog")
            self._watchdog.start()
        if self._do_warmup:
            self._warmup(self._predictor)
        # pin: any preparation after this point is a serving-contract
        # violation the metrics report makes visible
        self._pinned_compiles = self._io.aot_compile_count()
        with self._state_lock:
            self._state = "ready"
        return self

    def _warmup(self, predictor) -> None:
        """One execution per bucket (golden feed where it fits, zeros
        otherwise): pages weights and captured graphs in so the first real
        request sees steady-state latency."""
        clone = predictor.clone()
        for b in predictor.batch_buckets:
            feed = self._bucket_feed(predictor, b)
            out = clone.run(feed)
            _block_on(out)

    def _bucket_feed(self, predictor, bucket: int) -> Dict[str, np.ndarray]:
        spec = predictor.feed_spec(bucket)
        golden = self.golden_feed or {}
        feed = {}
        for k, (shape, dtype) in spec.items():
            if k in golden:
                v = np.asarray(golden[k])
                if k in predictor.batched_feeds:
                    from .io import _resize_batch
                    v = _resize_batch(v, bucket)
                feed[k] = v.astype(dtype, copy=False)
            else:
                feed[k] = np.zeros(shape, dtype)
        return feed

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
            # carried (coalescer-deferred) requests count as pending work;
            # abandoned (hung) workers never go idle, and the watchdog has
            # already failed their requests
            while not self._queue.empty() or any(
                    (w.busy_since is not None or w.carry) and not w.abandoned
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
            self.breaker.cancel(req.token)
            self._complete(req, error=ServerClosed("server stopping"))
        for w in self._workers:
            if w.abandoned:
                continue   # wedged in a dispatch; daemon thread, no join
            if w.thread is not None and w.thread is not threading.current_thread():
                try:
                    w.thread.join(timeout=5.0)
                except RuntimeError:   # raced a spawn: daemon exits solo
                    pass
        # abandoned workers never run their loop-exit cleanup: fail any
        # carried (never-dispatched) request they still hold
        for w in self._workers:
            for r in w.carry:
                self.breaker.cancel(r.token)
                self._complete(r, error=ServerClosed("server stopping"))
            w.carry = []
        if self._watchdog is not None:
            self._watchdog.join(timeout=5.0)
        with self._state_lock:
            self._state = "stopped"
        if self._telemetry_server is not None:
            self._telemetry_server.close()
            self._telemetry_server = None
        # a closed server stops exporting live-looking queue and worker gauges
        from .telemetry import get_registry
        get_registry().remove_collector(self._telemetry_cid)

    def kill(self, reason: str = "replica killed") -> None:
        """Abrupt replica death — the in-process stand-in for the
        serving process being ``kill -9``'d, used by fleet drills
        (``testing.faults.kill_server``) and exercised by
        :class:`~paddle_tpu_torch.fleet.FleetRouter`'s retry contract. No
        drain, no joins:

        - requests still QUEUED (or coalescer-carried) were provably
          never dispatched: they fail with :class:`ServerClosed`, which
          a router may safely resubmit to another replica;
        - requests DISPATCHED on a worker fail with
          :class:`ReplicaDied` exactly once and are never retried
          (at-most-once — the execution may or may not have happened);
        - the flight recorder captures the kill with the first
          in-flight request's span, so the post-mortem shows exactly
          what the replica was serving when it died.

        Idempotent; a later :meth:`close` is a no-op."""
        with self._state_lock:
            if self._state == "stopped":
                return
            self._state = "stopped"
        self._stop.set()
        died = []
        for w in self._workers:
            grp = list(w.group or ())
            if not grp and w.request is not None:
                grp = [w.request]
            w.abandoned = True
            for r in grp:
                if self._complete(r, error=ReplicaDied(reason)):
                    died.append(r.span)
            for r in w.carry:
                self.breaker.cancel(r.token)
                self._complete(r, error=ServerClosed(reason))
            w.carry = []
        requeued = 0
        while True:
            try:
                req = self._queue.get_nowait()
            except _queue.Empty:
                break
            self.breaker.cancel(req.token)
            self._complete(req, error=ServerClosed(reason))
            requeued += 1
        self.journal.emit("serving.killed", span=died[0] if died else None,
                          inst=self.telemetry_inst, reason=reason,
                          inflight=len(died), queued=requeued)
        from .telemetry import flight_dump, get_registry
        flight_dump("replica_killed", span=died[0] if died else None,
                    detail={"reason": reason, "inflight": len(died),
                            "inflight_spans": died, "queued": requeued,
                            "inst": self.telemetry_inst})
        _log().error("replica killed (%s): %d in-flight failed "
                     "at-most-once, %d never-dispatched failed retryable",
                     reason, len(died), requeued)
        if self._telemetry_server is not None:
            self._telemetry_server.close()
            self._telemetry_server = None
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
        ``default_deadline``); raises :class:`InvalidRequest` (also for a
        non-finite float payload), :class:`CircuitOpen`,
        :class:`ServerOverloaded` or :class:`ServerClosed`. ``span``
        adopts a trace id minted elsewhere instead of minting one."""
        with self._state_lock:
            state = self._state
        if state in ("draining", "stopping", "stopped"):
            raise ServerClosed(f"server is {state}")
        if state == "starting":
            raise ServerClosed("server not started (call start())")
        span = span or self.journal.new_span()
        token = self.breaker.acquire()
        if token is None:
            self.metrics.bump("rejected_breaker")
            self.journal.emit("serving.reject", span=span,
                              inst=self.telemetry_inst, reason="breaker")
            raise CircuitOpen(self.breaker.retry_after())
        try:
            with self._model_lock:
                predictor = self._predictor
            n, bucket = predictor.validate_feed(feed, allow_padding=True)
            if self.reject_nonfinite:
                _check_finite(feed, predictor.feed_names)
        except InvalidRequest as e:
            self.breaker.cancel(token)
            self.metrics.bump("rejected_invalid")
            self.journal.emit("serving.reject", span=span, inst=self.telemetry_inst,
                              reason="invalid", field=getattr(e, "field", None))
            raise
        except BaseException:
            # any other validation error (a ragged list in np.asarray) must
            # also give back the token: it may be the half-open probe's
            self.breaker.cancel(token)
            raise
        rel = self.default_deadline if deadline is None else deadline
        req = _Request(feed, n, bucket,
                       None if rel is None else time.monotonic() + rel,
                       token, span=span)
        # journaled before the enqueue: a worker may dispatch it at once,
        # and a span's timeline must never read dispatch before submit
        self.journal.emit("serving.submit", span=span, inst=self.telemetry_inst, n=n,
                          bucket=bucket, deadline_s=rel,
                          queue_depth=self._queue.qsize())
        # state re-check + enqueue are atomic under the state lock: close()
        # flips the state under the same lock before draining, so a
        # request can never slip into the queue after the drain loop
        # decided it was empty
        with self._state_lock:
            if self._state != "ready":
                self.breaker.cancel(token)
                raise ServerClosed(f"server is {self._state}")
            try:
                self._queue.put_nowait(req)
            except _queue.Full:
                self.breaker.cancel(token)
                self.metrics.bump("rejected_overload")
                self.journal.emit("serving.reject", span=span, inst=self.telemetry_inst,
                                  reason="overload", queue_depth=self._queue.qsize())
                raise ServerOverloaded(self._queue.qsize(),
                                       self.queue_size) from None
        self.metrics.bump("submitted")
        return PendingResult(req)

    def run(self, feed: Dict[str, Any], timeout: Optional[float] = None):
        """Synchronous submit+wait (``timeout`` doubles as the request
        deadline when no ``default_deadline`` is configured)."""
        deadline = timeout if self.default_deadline is None else None
        return self.submit(feed, deadline=deadline).result(timeout)

    # -- worker machinery ----------------------------------------------------

    def _spawn_worker(self, index: int) -> _Worker:
        w = _Worker(index)
        w.thread = threading.Thread(target=self._worker_loop, args=(w,),
                                    daemon=True,
                                    name=f"pdtorch-serving-worker-{index}")
        # started before it is registered: close() joins every registered
        # worker, and joining a thread not yet started raises
        w.thread.start()
        self._workers.append(w)
        return w

    def _admit(self, req: _Request) -> Optional[_Request]:
        """Dequeue-time admission: a request whose deadline passed while
        queued is dropped WITHOUT executing (its breaker token goes back),
        and one admitted before the breaker tripped fails fast with
        :class:`CircuitOpen`. Returns the request, or None after
        completing it with its typed error."""
        now = time.monotonic()
        if req.deadline is not None and now > req.deadline:
            self.breaker.cancel(req.token)
            self.metrics.bump("timeouts")
            self.journal.emit("serving.expired", span=req.span, inst=self.telemetry_inst,
                              late_s=round(now - req.deadline, 6))
            self._complete(req, error=DeadlineExceeded(
                f"deadline passed {now - req.deadline:.3f}s before "
                "dispatch"))
            return None
        if self.breaker.state == "open" and req.token == "pass":
            self.metrics.bump("rejected_breaker")
            self.journal.emit("serving.reject", span=req.span, inst=self.telemetry_inst,
                              reason="breaker_queued")
            self._complete(req, error=CircuitOpen(self.breaker.retry_after()))
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
        with self._model_lock:
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
        clone = None
        gen = 0
        while not self._stop.is_set() and not w.abandoned:
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
            with self._model_lock:
                pred, gen_now = self._predictor, self._generation
            total = sum(r.n for r in group)
            bucket = (req.bucket if len(group) == 1
                      else _batching.pick_bucket(total, pred.batch_buckets))
            spans = _batching.row_spans(group)
            w.request = req
            w.group = group
            w.busy_since = now = time.monotonic()
            for (off, n), r in zip(spans, group):
                extra = {"coalesced": len(group), "row": off} if len(group) > 1 else {}
                self.journal.emit("serving.dispatch", span=r.span, inst=self.telemetry_inst,
                                  worker=w.index, n=n, bucket=bucket,
                                  queued_s=round(now - r.submitted, 6), **extra)
            try:
                if clone is None or gen != gen_now:
                    clone = pred.clone()
                    gen = gen_now
                feed = (self._pad(pred, req) if len(group) == 1
                        else _batching.merge_feeds(group, pred.feed_names,
                                                   pred.batched_feeds,
                                                   bucket))
                out = clone.run(feed)
                _block_on(out)
            except BaseException as e:
                # a boundary that must keep serving, whatever was raised (an
                # InjectedCrash is a BaseException): the failure goes to each
                # caller of the group, the worker lives on
                _log().exception("dispatch of %d request(s) failed",
                                 len(group))
                for r in group:
                    first = self._complete(r, error=e)
                    # an abandoned worker's late outcome is stale: the
                    # watchdog already tripped the breaker for its hang
                    if not w.abandoned:
                        self.breaker.record(r.token, success=False)
                    if first:
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
                    if not w.abandoned:
                        self.breaker.record(r.token, success=True)
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
                w.request = None
                w.group = None
        # loop exit with requests still carried (the stop flag raced the
        # coalescer): they were never dispatched
        for r in w.carry:
            self.breaker.cancel(r.token)
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
        """First completion wins, atomically (a worker, the watchdog,
        kill() and close() may race to complete the same request)."""
        with self._complete_lock:
            if req.done.is_set():
                return False
            req.error = error
            req.value = value
            req.completed = time.monotonic()
            req.done.set()
            return True

    def _watchdog_loop(self) -> None:
        interval = max(0.01, min(0.5, (self.watchdog_timeout or 1.0) / 4))
        while not self._stop.is_set():
            time.sleep(interval)
            now = time.monotonic()
            for w in list(self._workers):
                busy = w.busy_since
                if w.abandoned or busy is None:
                    continue
                if now - busy <= self.watchdog_timeout:
                    continue
                group = list(w.group or ())
                if not group and w.request is not None:
                    group = [w.request]
                w.abandoned = True
                self.metrics.bump("hangs")
                span = group[0].span if group else None
                # the hang event goes into the ring BEFORE the breaker
                # trips, so both this dump and the trip's are complete
                self.journal.emit("serving.hang", span=span,
                                  inst=self.telemetry_inst,
                                  worker=w.index,
                                  busy_s=round(now - busy, 6),
                                  inflight=len(group))
                self.breaker.trip()
                from .telemetry import flight_dump
                flight_dump("worker_hung", span=span,
                            detail={"worker": w.index,
                                    "busy_s": round(now - busy, 6),
                                    "watchdog_timeout":
                                        self.watchdog_timeout,
                                    "inst": self.telemetry_inst})
                _log().error(
                    "worker %d hung for %.2fs (watchdog_timeout=%.2fs): "
                    "breaker tripped, worker abandoned + replaced",
                    w.index, now - busy, self.watchdog_timeout)
                # EVERY request of a coalesced dispatch hung with it:
                # fail each fast (their callers are all waiting)
                for r in group:
                    self._complete(r, error=WorkerHung(
                        f"dispatch exceeded the {self.watchdog_timeout}s "
                        "watchdog timeout"))
                self.metrics.bump("workers_replaced")
                neww = self._spawn_worker(len(self._workers))
                # never-dispatched requests the coalescer carried on
                # the wedged worker move to its replacement — they
                # must not strand behind an abandoned loop
                neww.carry, w.carry = w.carry, []

    def _on_breaker_trip(self, reason: str) -> None:
        """Breaker (re)open: journal it and flight-record the recent
        ring. The watchdog's ``hang`` path already dumped WITH the
        hung request's span — don't double-dump for the same event;
        ``probe_failure`` re-opens are journal-only (the original trip
        dumped)."""
        self.journal.emit("serving.breaker_open", inst=self.telemetry_inst,
                          reason=reason, trips=self.breaker.trips)
        if reason == "failures":
            from .telemetry import flight_dump
            flight_dump("breaker_trip",
                        detail={"reason": reason,
                                "trips": self.breaker.trips,
                                "inst": self.telemetry_inst})

    # -- hot reload ----------------------------------------------------------

    def reload(self, dirname: str, block: bool = True):
        """Hot-swap the served model from a ``save_inference_model``
        artifact. The load (manifest CRC validation + per-bucket warm-up) and
        the golden-feed canary run OFF the request path on a dedicated
        thread; only the final pointer swap takes the model lock, so
        in-flight requests finish on the clone they started with — zero
        drops either way. Any failure (torn artifact →
        ``CheckpointCorrupt``, signature drift or canary rejection →
        :class:`ReloadFailed`) leaves the previous model serving.

        ``block=False`` returns the loader thread immediately
        (``last_reload_error`` and the metrics counters carry the
        outcome); ``block=True`` joins and re-raises."""
        err: List[BaseException] = []

        def _load():
            try:
                self._do_reload(dirname)
            except BaseException as e:
                err.append(e)

        t = threading.Thread(target=_load, daemon=True,
                             name="pdtorch-serving-reload")
        t.start()
        if not block:
            return t
        t.join()
        if err:
            raise err[0]
        return None

    def reload_preflight(self, dirname: str):
        """Static pre-reload contract check: the
        :class:`~paddle_tpu_torch.analysis.LintReport` of
        ``analysis.contracts.check_reload_compat`` for swapping the
        artifact at ``dirname`` in over the currently-served model —
        metadata only (no CRC pass, no deserialization, no
        warm-up), so an operator or a rolling-fleet controller can
        vet a candidate against every server BEFORE any of them pays
        a load. ``reload`` runs this automatically and rejects on any
        error-severity finding."""
        from .analysis import contracts
        info = self._io.read_artifact_meta(dirname)
        with self._model_lock:
            served = contracts.serving_spec(self._predictor)
        return contracts.check_reload_compat(served, info)

    def _reload_static_check(self, dirname: str) -> None:
        # early REJECT only, never an early accept: a candidate whose
        # metadata alone proves the swap would strand in-flight traffic
        # fails before the load + per-bucket warm-up is paid; an
        # unreadable/odd artifact falls through for the real load to
        # classify (CheckpointCorrupt with the CRC detail), and the
        # post-load checks below stay as the backstop for drift classes
        # only the deserialized export shows
        try:
            report = self.reload_preflight(dirname)
        except Exception:
            return
        errs = report.at_least("error")
        if errs:
            more = (f" (+{len(errs) - 1} more static contract finding(s))"
                    if len(errs) > 1 else "")
            raise ReloadFailed(dirname, errs[0].message + more)

    def _do_reload(self, dirname: str) -> None:
        with self._reload_lock:
            try:
                self._reload_static_check(dirname)
                old = self._predictor
                new_pred = self._io.load_inference_model(
                    dirname, device=getattr(old, "device", None))
                if list(new_pred.feed_names) != list(old.feed_names):
                    raise ReloadFailed(
                        dirname, f"feed names {new_pred.feed_names} != "
                        f"served model's {old.feed_names}")
                dropped = [b for b in old.batch_buckets
                           if b not in new_pred.batch_buckets]
                if dropped:
                    raise ReloadFailed(
                        dirname, f"bucket set shrank (missing {dropped}): "
                        "in-flight bucket traffic would go off-bucket")
                for b in old.batch_buckets:
                    got, want = new_pred.feed_spec(b), old.feed_spec(b)
                    if got != want:
                        diff = sorted(k for k in want if got.get(k) != want[k])
                        raise ReloadFailed(
                            dirname, f"feed signature drifted at bucket {b} "
                            f"(fields {diff}: {[got.get(k) for k in diff]} vs "
                            f"served {[want[k] for k in diff]}): queued "
                            "in-flight requests validated against the old "
                            "shapes would all fail on the new model")
                self._canary(new_pred, dirname)
                # candidate buckets were warmed at load: warm them
                # off-thread so the swap doesn't cold-start a request
                self._warmup(new_pred)
            except BaseException as e:
                self._last_reload_error = e
                self.metrics.bump("reload_failures")
                self.journal.emit("serving.reload", inst=self.telemetry_inst,
                                  dirname=dirname, ok=False,
                                  error=f"{type(e).__name__}: {e}"[:300])
                # the rejected candidate's preparations happened OFF the
                # request path: re-pin so the compiles_since_warmup
                # contract signal doesn't read as a (false) request-path
                # recompile forever after a rolled-back reload
                if self._pinned_compiles is not None:
                    self._pinned_compiles = self._io.aot_compile_count()
                _log().warning("hot reload of %s rolled back: %s", dirname, e)
                raise
            with self._model_lock:
                self._predictor = new_pred
                self._generation += 1
            self._last_reload_error = None
            self._pinned_compiles = self._io.aot_compile_count()
            self.metrics.bump("reloads")
            self.journal.emit("serving.reload", inst=self.telemetry_inst,
                              dirname=dirname, ok=True,
                              generation=self._generation)
            _log().info("hot reload: now serving %s (generation %d)",
                        dirname, self._generation)

    def _canary(self, predictor, dirname: str) -> None:
        # the golden feed is resized onto a precompiled bucket exactly
        # like warmup does (Predictor.run is exact-bucket-strict, and a
        # legal off-bucket golden feed must not make every reload fail)
        buckets = predictor.batch_buckets
        n = 0
        for k in sorted(predictor.batched_feeds):
            if self.golden_feed is not None and k in self.golden_feed:
                n = int(np.asarray(self.golden_feed[k]).shape[0])
                break
        fits = [b for b in buckets if b >= n]
        feed = self._bucket_feed(predictor, fits[0] if fits else buckets[-1])
        try:
            out = predictor.run(feed)
            _block_on(out)
        except Exception as e:
            raise ReloadFailed(
                dirname, f"canary execution failed: {type(e).__name__}: {e}")
        bad = _nonfinite_outputs(out)
        if bad:
            raise ReloadFailed(
                dirname, f"canary produced non-finite outputs: {bad}")
        if self.canary_check is not None:
            try:
                ok = self.canary_check(out)
            except Exception as e:
                raise ReloadFailed(dirname, f"canary_check raised "
                                   f"{type(e).__name__}: {e}")
            if ok is False:
                raise ReloadFailed(dirname, "canary_check returned False")

    # -- observability -------------------------------------------------------

    @property
    def generation(self) -> int:
        with self._model_lock:
            return self._generation

    @property
    def last_reload_error(self) -> Optional[BaseException]:
        """The most recent reload's failure (None after a success) —
        the outcome channel for ``reload(..., block=False)`` callers."""
        return self._last_reload_error

    def _alive_workers(self) -> List[_Worker]:
        """THE worker-liveness definition — shared by :meth:`health`
        and the registry collector so ``/healthz`` and the
        ``paddle_tpu_serving_workers*`` gauges can never drift."""
        return [w for w in self._workers
                if not w.abandoned and w.thread is not None
                and w.thread.is_alive()]

    def health(self) -> Dict[str, Any]:
        """Readiness/liveness: ``starting`` → ``ready`` (``overloaded``
        while the queue is full, ``breaker_open``/``half_open`` while the
        breaker is tripped) → ``draining`` → ``stopped``."""
        with self._state_lock:
            state = self._state
        if state == "ready":
            bstate = self.breaker.state
            if bstate == "open":
                state = "breaker_open"
            elif bstate == "half_open":
                state = "half_open"
            elif self._queue.full():
                state = "overloaded"
        alive = self._alive_workers()
        return {
            "live": state != "stopped" and bool(alive),
            "ready": state in ("ready", "overloaded", "half_open"),
            "state": state,
            "generation": self.generation,
            "queue_depth": self._queue.qsize(),
            "queue_capacity": self.queue_size,
            "workers": len(alive),
            "workers_busy": sum(1 for w in alive if w.busy_since is not None),
            "breaker": self.breaker.state,
            "uptime_s": round(time.monotonic() - self._started_at, 3),
        }

    def repin_compiles(self) -> None:
        """Re-pin ``compiles_since_warmup``. ``io.aot_compile_count`` is
        process-wide, so it also moves when another server in the process
        loads off the request path (a fleet sibling's reload, a router's
        ``replace()``); ``FleetRouter`` re-pins the rest of its fleet
        then. No-op before warm-up."""
        if self._pinned_compiles is not None:
            self._pinned_compiles = self._io.aot_compile_count()

    def telemetry_families(self) -> list:
        """This server's registry export (serving.py:1356): every
        :class:`ServingMetrics` counter and the latency histogram (the
        store :meth:`report` reads) plus the live queue, worker, breaker
        and generation gauges. The process registry's collector calls it
        at scrape time; a :class:`~paddle_tpu_torch.fleet.FleetRouter`
        merges it under a ``replica`` label."""
        from .telemetry.registry import counter_family, gauge_family

        labels = {"inst": self.telemetry_inst}
        fams = self.metrics.telemetry_families(self.telemetry_inst)
        alive = self._alive_workers()
        bstate = self.breaker.state
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
            gauge_family("paddle_tpu_serving_breaker_open",
                         "1 while the circuit breaker is open",
                         [(labels, 1 if bstate == "open" else 0)]),
            gauge_family("paddle_tpu_serving_breaker_half_open",
                         "1 while the breaker awaits its half-open probe",
                         [(labels, 1 if bstate == "half_open" else 0)]),
            counter_family("paddle_tpu_serving_breaker_trips_total",
                           "Circuit-breaker trips",
                           [(labels, self.breaker.trips)]),
            gauge_family("paddle_tpu_serving_generation",
                         "Served-model generation (bumps on hot reload)",
                         [(labels, self.generation)]),
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
        reject/timeout/error/breaker counters, coalescing counters, reload
        outcomes, and ``compiles_since_warmup`` (0 for a warmed server)."""
        out = self.metrics.snapshot()
        out["health"] = self.health()
        out["breaker"] = {"state": self.breaker.state,
                          "trips": self.breaker.trips}
        with self._model_lock:
            pred = self._predictor
        compiles = self._io.aot_compile_count()
        out["batch_buckets"] = list(pred.batch_buckets)
        out["compiles_since_warmup"] = (
            None if self._pinned_compiles is None
            else compiles - self._pinned_compiles)
        return out


# -- helpers ------------------------------------------------------------------


def _check_finite(feed: Dict[str, Any], feed_names) -> None:
    for k in feed_names:
        v = np.asarray(feed[k])
        if v.dtype.kind == "f" and not np.isfinite(v).all():
            raise InvalidRequest(k, "contains non-finite values "
                                 "(NaN/Inf payload rejected)")


def _nonfinite_outputs(out) -> List[str]:
    import torch

    bad = []
    items = out.items() if isinstance(out, dict) else [("output", out)]
    for k, v in items:
        if isinstance(v, torch.Tensor):
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                bad.append(str(k))
            continue
        a = np.asarray(v)
        if a.dtype.kind == "f" and not np.isfinite(a).all():
            bad.append(str(k))
    return bad


__all__ = [
    "BreakerPolicy", "CircuitBreaker", "CircuitOpen", "DeadlineExceeded",
    "InvalidRequest", "LatencyHistogram", "PendingResult", "PredictorServer",
    "ReloadFailed", "ReplicaDied", "ServerClosed", "ServerOverloaded",
    "ServingError", "ServingMetrics", "WorkerHung",
]
