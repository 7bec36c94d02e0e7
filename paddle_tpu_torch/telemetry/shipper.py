"""Background telemetry shipper: the PUSH half of the collector story
(counterpart of ``paddle_tpu.telemetry.shipper``; its verbs are the JAX
shipper's byte for byte, so a collector of either package takes the
pushes of a shipper of either).

Any process — a trainer, a serving process — attaches ONE process-wide
:class:`Shipper` that streams its observability to a telemetry
collector over the framed wire of ``parallel.async_ps.FramedClient``:

- **journal events**, captured live through ``RunJournal.subscribe``
  (subscribers fire for EVERY event regardless of ring/sink sampling,
  so the shipped stream is complete) into a bounded buffer and flushed
  as ``EVENTS`` batches every ``flush_interval``;
- **registry snapshots** (``registry.snapshot()``, the full
  families_snapshot) as ``SNAPSHOT`` pushes every
  ``snapshot_interval`` — the samples the collector's time-series
  rings and alert rules run on.

The hot path NEVER blocks on the collector: the subscriber callback is
a lock + deque append (the <2%-of-a-K=16-dispatch budget is
test-pinned); all wire I/O happens on the shipper's daemon thread.
When the collector is unreachable the buffer holds what fits and the
overflow is counted — ``paddle_tpu_shipper_dropped_total`` — never
raised. Event batches are deduplicated server-side by ``(origin, run,
seq)``, so flush retries are safe (idempotent sends, no at-most-once
dance on a telemetry path).

Attachment is zero-code: every ``Trainer`` and ``PredictorServer``
constructor calls :func:`maybe_auto_ship`, which
starts the process shipper iff ``PDTPU_TELEMETRY_ADDR=host:port`` is
set (the env var is inherited by spawned replica processes, so a
remote fleet ships per-process automatically). Explicit attachment is
:func:`ship_to` — also exposed as ``.ship_to(addr)`` on the trainer and
the server.

**Collector HA**: ``PDTPU_TELEMETRY_ADDR`` (and every addr-taking
door here) accepts a comma-separated failover list —
``"host1:p1,host2:p2"``. Flushes stick to the first address that
accepts them; a flush error rotates to the next and retries within
the SAME tick (counted as ``paddle_tpu_shipper_flushes_total{outcome=
"failover"}``). The server-side ``(origin, run, sseq)`` dedupe that
makes retries safe makes failover safe too: a standby collector that
replayed the shared segment log carries the same high-water marks, so
the batch a dead primary never acknowledged is resent to the standby
and lands exactly once.

Knobs (env defaults in parentheses): ``origin`` — the label this
process's series carry at the collector (``PDTPU_TELEMETRY_ORIGIN``,
else ``<hostname>-<pid>`` — pids collide across machines the moment a
fleet spans hosts, so the default origin carries the sanitized
hostname); ``flush_interval`` (``PDTPU_TELEMETRY_FLUSH_S``, 0.25s) —
each shipper adds a deterministic per-origin phase offset
(:func:`flush_jitter`) so K replicas spawned in the same second don't
synchronize their pushes into the collector; ``buffer_events``
(``PDTPU_TELEMETRY_BUFFER``, 4096).

:class:`ReplicationClient` is the OTHER puller on this wire: a
cross-host standby collector's client for the primary's ``SEGMENTS``
verb (segment-log listing + raw segment/tail fetches — see
``telemetry/collector.py``'s replication story).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Tuple, Union

from .journal import RunJournal, get_journal
from .registry import MetricsRegistry, get_registry

AddrLike = Union[str, Tuple[str, int]]


def _log():
    import logging
    return logging.getLogger("paddle_tpu_torch.telemetry.shipper")


def default_origin() -> str:
    """``<hostname>-<pid>``: the origin a shipper uses when neither
    ``origin=`` nor ``PDTPU_TELEMETRY_ORIGIN`` names one. Pids are
    only unique per machine — two replicas on different hosts of a
    cross-host fleet can share a pid, and their series must not merge
    under one origin label. The hostname is sanitized to the label
    charset (anything outside ``[A-Za-z0-9._-]`` becomes ``-``) so
    the merged ``/metrics`` naming contract holds."""
    import socket as _socket

    host = "".join(c if (c.isalnum() or c in "._-") else "-"
                   for c in _socket.gethostname()) or "host"
    return f"{host}-{os.getpid()}"


def flush_jitter(origin: str, interval: float, frac: float = 0.25) -> float:
    """Deterministic per-origin offset added to every flush wait:
    ``hash(origin)`` mapped into ``[0, frac * interval)``. A scale-up
    that spawns K replicas in the same second gives all K the same
    flush cadence — without jitter their pushes synchronize into the
    collector as a K-wide thundering herd every tick. Keying the
    jitter on the origin (stable per process across restarts, distinct
    across replicas by construction — see :func:`default_origin`)
    desynchronizes them deterministically: no RNG, so the schedule is
    reproducible and two same-period shippers provably never share a
    phase unless they share an origin."""
    import hashlib

    h = hashlib.sha1(origin.encode("utf-8", "surrogatepass")).digest()[:8]
    u = int.from_bytes(h, "big") / float(2 ** 64)   # [0, 1)
    return u * float(frac) * float(interval)


def parse_addr(addr: AddrLike) -> Tuple[str, int]:
    """``"host:port"`` (the env-var shape) or ``(host, port)``."""
    if isinstance(addr, str):
        host, _, port = addr.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(
                f"bad telemetry collector addr {addr!r} (want host:port)")
        return (host, int(port))
    host, port = addr
    return (str(host), int(port))


def parse_addrs(addr) -> Tuple[Tuple[str, int], ...]:
    """The HA shape: a comma-separated failover list
    (``"h1:p1,h2:p2"`` — what ``PDTPU_TELEMETRY_ADDR`` accepts), a
    list/tuple of addr-likes, or one addr. Order is priority: the
    shipper sticks to the first address that accepts flushes and fails
    over down (then around) the list on flush errors."""
    if isinstance(addr, str):
        parts = [p.strip() for p in addr.split(",") if p.strip()]
        if not parts:
            raise ValueError(f"bad telemetry collector addr {addr!r}")
        return tuple(parse_addr(p) for p in parts)
    if isinstance(addr, (list, tuple)):
        if len(addr) == 2 and isinstance(addr[1], int):
            return (parse_addr(addr),)   # one (host, port) pair
        return tuple(parse_addr(a) for a in addr)
    return (parse_addr(addr),)


class ShipperClient:
    """Framed-wire client for the collector's push verbs (a thin
    :class:`~paddle_tpu_torch.parallel.async_ps.FramedClient` wrapper with
    the retry budget a BACKGROUND path wants: short timeout, few
    retries — a missed flush is retried by the next tick, not by
    spinning here)."""

    def __init__(self, addr: Tuple[str, int], timeout: float = 5.0):
        from ..parallel.async_ps import FramedClient

        class _Client(FramedClient):
            peer_name = "telemetry collector"

        self._cli = _Client(addr, timeout=timeout, retries=2,
                            retry_backoff=0.05, retry_backoff_max=0.2,
                            connect=False)

    def _call(self, header: str, body: bytes) -> int:
        resp = self._cli._request(f"{header} {len(body)}", body)
        return int(resp.split()[1])

    def ship_events(self, origin: str, run: str, events) -> int:
        # the journal's own encoder: a numpy-valued detail field must
        # ship as the NUMBER the local JSONL sink writes, not a repr
        # string (fleet-wide timeline == per-process sink, byte-alike)
        from .journal import _json_default

        body = json.dumps({"run": run, "events": list(events)},
                          default=_json_default).encode()
        return self._call(f"EVENTS {origin}", body)

    def ship_snapshot(self, origin: str, snapshot: Dict[str, Any]) -> int:
        from .journal import _json_default

        body = json.dumps({"families": snapshot},
                          default=_json_default).encode()
        return self._call(f"SNAPSHOT {origin}", body)

    def ping(self) -> None:
        self._cli._request("PING")

    def stats(self) -> Dict[str, Any]:
        """The collector's ``STATS`` verb: its ingest/store counters as
        one JSON object riding the reply line (``OK {...}``) — what the
        bench rows delta to price store ingest-writes."""
        resp = self._cli._request("STATS")
        return json.loads(resp.split(" ", 1)[1])

    def close(self) -> None:
        self._cli.close()


class ReplicationClient:
    """A cross-host standby collector's puller for the primary's
    ``SEGMENTS`` verb: one framed request (``SEGMENTS <len>`` + json)
    per call, one framed reply body back — the segment-log listing
    (json) or raw segment bytes, depending on the request form. The
    bytes are NOT trusted off the wire: the standby re-verifies every
    sealed segment against the sidecar CRC the listing carried before
    anything touches its store."""

    def __init__(self, addr: Tuple[str, int], timeout: float = 10.0):
        from ..parallel.async_ps import FramedClient

        class _Client(FramedClient):
            peer_name = "primary collector"

        self._cli = _Client(addr, timeout=timeout, retries=2,
                            retry_backoff=0.05, retry_backoff_max=0.2,
                            connect=False)

    def _segments(self, req: Dict[str, Any]) -> bytes:
        body = json.dumps(req, separators=(",", ":")).encode()
        resp, payload = self._cli._request(
            f"SEGMENTS {len(body)}", body,
            body_len=lambda r: int(r.split()[1]))
        return payload

    def listing(self) -> Dict[str, Any]:
        """The primary's sealed segments (name + CRC sidecar doc each)
        and its active segment's name/size."""
        return json.loads(self._segments({"list": True}))

    def fetch(self, name: str, offset: int = 0,
              limit: Optional[int] = None) -> bytes:
        """Raw bytes of one segment file from ``offset`` (the whole
        file for a sealed segment, the unseen tail for the open
        one)."""
        req: Dict[str, Any] = {"fetch": name, "offset": int(offset)}
        if limit is not None:
            req["limit"] = int(limit)
        return self._segments(req)

    def ping(self) -> None:
        """The promotion fence's liveness probe of the primary."""
        self._cli._request("PING")

    def close(self) -> None:
        self._cli.close()


class Shipper:
    """One process's push pipeline to a collector (see module
    docstring). ``close()`` flushes what it can and detaches."""

    def __init__(self, addr: AddrLike, origin: Optional[str] = None,
                 journal: Optional[RunJournal] = None,
                 registry: Optional[MetricsRegistry] = None,
                 flush_interval: Optional[float] = None,
                 snapshot_interval: Optional[float] = None,
                 buffer_events: Optional[int] = None,
                 client_timeout: float = 5.0):
        # the HA failover list: flushes go to addrs[_addr_i]; a flush
        # error rotates to the next address and retries ONCE in the
        # same tick (server-side idempotent dedupe is what makes the
        # resend — to either collector — safe)
        self.addrs = parse_addrs(addr)
        self._addr_i = 0
        origin = origin or os.environ.get("PDTPU_TELEMETRY_ORIGIN") \
            or default_origin()
        if any(c.isspace() for c in origin):
            raise ValueError(f"origin {origin!r} must not contain "
                             "whitespace (it rides a framed header)")
        if origin == "collector":
            raise ValueError(
                "origin 'collector' is reserved for the collector's own "
                "series in the merged export")
        self.origin = origin
        self.journal = journal if journal is not None else get_journal()
        self.registry = registry if registry is not None else get_registry()
        self.flush_interval = float(
            flush_interval if flush_interval is not None
            else os.environ.get("PDTPU_TELEMETRY_FLUSH_S", 0.25))
        self.snapshot_interval = float(
            snapshot_interval if snapshot_interval is not None
            else max(self.flush_interval, 0.5))
        # per-origin phase offset on the flush wait: K replicas spawned
        # together would otherwise push in lockstep (see flush_jitter)
        self.flush_jitter = flush_jitter(self.origin, self.flush_interval)
        bound = int(buffer_events if buffer_events is not None
                    else os.environ.get("PDTPU_TELEMETRY_BUFFER", 4096))
        self._buf_lock = threading.Lock()
        # (ship_seq, event) tuples: the ship sequence is assigned under
        # THIS lock at append time, so it is monotonic in buffer order
        # even when journal subscribers land out of journal-seq order
        # (subscribe() runs outside the journal lock), and it is
        # stable across flush retries — the collector's dedupe
        # high-water runs on it
        self._buf: deque = deque()
        self._buf_bound = max(16, bound)
        self._sseq = 0
        # counters (read by the registry collector AND bench deltas)
        self._c_lock = threading.Lock()
        self._counts = {"events_shipped": 0, "events_dropped": 0,
                        "snapshots": 0, "flushes": 0, "flush_failures": 0,
                        "failovers": 0, "flush_seconds": 0.0}
        self._client_timeout = client_timeout
        self._client = ShipperClient(self.addr, timeout=client_timeout)
        self._stop = threading.Event()
        self._wake = threading.Event()
        # serializes _flush_once: a synchronous flush() on the caller's
        # thread must never interleave with the loop's tick on the ONE
        # underlying framed socket (FramedClient has no internal lock)
        self._flush_lock = threading.Lock()
        self._last_snapshot = 0.0
        self.telemetry_inst = self.registry.next_instance("shipper")
        self._sub = self.journal.subscribe(self._on_event)
        self._telemetry_cid = self.registry.add_collector(
            Shipper._families, owner=self)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="pdtpu-telemetry-shipper")
        self._thread.start()
        # first flush IMMEDIATELY (not one interval in): the process
        # registers its origin with the collector the moment shipping
        # starts, so absence alerts cover even a process that dies
        # young — and operators see a spawned fleet appear promptly
        self._wake.set()

    @property
    def addr(self) -> Tuple[str, int]:
        """The address flushes currently go to (failover rotates it)."""
        return self.addrs[self._addr_i]

    def _failover_locked(self) -> None:
        """Rotate to the next collector in the list (called under
        ``_flush_lock`` after a flush error). The dead primary comes
        back into rotation if every other address fails too — a
        recovered primary is re-adopted within one lap."""
        try:
            self._client.close()
        except Exception:
            pass
        self._addr_i = (self._addr_i + 1) % len(self.addrs)
        self._client = ShipperClient(self.addr,
                                     timeout=self._client_timeout)
        with self._c_lock:
            self._counts["failovers"] += 1

    # -- hot path ------------------------------------------------------------

    def _on_event(self, event: Dict[str, Any]) -> None:
        """Journal-subscriber callback: runs on the EMITTER's thread —
        a bounded append, nothing else. A full buffer drops the OLDEST
        event (the collector wants the freshest context) and counts
        it; the wire is never touched here."""
        with self._buf_lock:
            if len(self._buf) >= self._buf_bound:
                self._buf.popleft()
                dropped = True
            else:
                dropped = False
            self._sseq += 1
            self._buf.append((self._sseq, event))
        if dropped:
            with self._c_lock:
                self._counts["events_dropped"] += 1

    # -- background flush ----------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.flush_interval + self.flush_jitter)
            self._wake.clear()
            if self._stop.is_set():
                break
            self._flush_once()
        # final best-effort flush so a drained close ships the tail
        self._flush_once(final=True)
        try:
            self._client.close()
        except Exception:
            pass

    def _flush_once(self, final: bool = False) -> None:
        with self._flush_lock:
            self._flush_once_locked(final)

    def _flush_once_locked(self, final: bool) -> None:
        with self._buf_lock:
            batch = list(self._buf)
            self._buf.clear()
        now = time.monotonic()
        want_snap = final or (now - self._last_snapshot
                              >= self.snapshot_interval)
        if not batch and not want_snap:
            return
        t0 = time.perf_counter()

        def _send():
            if batch:
                self._client.ship_events(
                    self.origin, self.journal.run_id,
                    [dict(e, sseq=s) for s, e in batch])
            if want_snap:
                self._client.ship_snapshot(self.origin,
                                           self.registry.snapshot())

        try:
            try:
                _send()
            except Exception:
                if len(self.addrs) < 2:
                    raise
                # the HA half: fail over to the next collector and
                # retry THIS flush (a resend of an already-applied
                # batch is deduped server-side by the sseq high-water,
                # on the standby too once it has replayed the log)
                self._failover_locked()
                _send()
            if want_snap:
                self._last_snapshot = now
            with self._c_lock:
                self._counts["events_shipped"] += len(batch)
                if want_snap:
                    self._counts["snapshots"] += 1
                self._counts["flushes"] += 1
                self._counts["flush_seconds"] += time.perf_counter() - t0
        except Exception as e:
            # collector unreachable / reply lost: put the batch back
            # (bounded — overflow is counted, the hot path never
            # blocks) and try again next tick. Idempotent server-side
            # dedupe makes a partially-applied resend safe.
            with self._buf_lock:
                for event in reversed(batch):
                    self._buf.appendleft(event)
                overflow = len(self._buf) - self._buf_bound
                for _ in range(max(0, overflow)):
                    self._buf.popleft()
            with self._c_lock:
                if overflow > 0:
                    self._counts["events_dropped"] += overflow
                self._counts["flush_failures"] += 1
                self._counts["flushes"] += 1
                self._counts["flush_seconds"] += time.perf_counter() - t0
            if not final:
                _log().debug("telemetry flush to %s failed: %s: %s",
                             self.addr, type(e).__name__, e)

    def flush(self) -> None:
        """Synchronous flush (tests/drills): ship buffered events and
        a fresh snapshot NOW on the caller's thread (serialized
        against the background loop's tick)."""
        with self._flush_lock:
            self._last_snapshot = 0.0
            self._flush_once_locked(final=True)

    # -- observability -------------------------------------------------------

    def counters(self) -> Dict[str, float]:
        """Flat monotonic counters (the bench delta surface): events
        shipped/dropped, snapshots, flushes, flush failures, and the
        cumulative flush seconds (latency = seconds/flushes)."""
        with self._c_lock:
            return dict(self._counts)

    def report(self) -> Dict[str, Any]:
        out = self.counters()
        with self._buf_lock:
            out["buffered"] = len(self._buf)
        out["origin"] = self.origin
        out["addr"] = f"{self.addr[0]}:{self.addr[1]}"
        out["addrs"] = [f"{h}:{p}" for h, p in self.addrs]
        return out

    def collector_stats(self) -> Optional[Dict[str, Any]]:
        """The attached collector's ingest/store counters (``STATS``
        wire verb), or None when it is unreachable — serialized against
        the flush loop (one framed socket). The bench rows delta this
        to price the collector-side store ingest-writes a measured
        window caused."""
        with self._flush_lock:
            try:
                return self._client.stats()
            except Exception:
                return None

    def _families(self):
        from .registry import counter_family

        c = self.counters()
        labels = {"inst": self.telemetry_inst}
        return [
            counter_family("paddle_tpu_shipper_shipped_total",
                           "Journal events shipped to the collector",
                           [(labels, c["events_shipped"])]),
            counter_family(
                "paddle_tpu_shipper_dropped_total",
                "Journal events dropped by the bounded ship buffer "
                "(collector unreachable or buffer too small)",
                [(labels, c["events_dropped"])]),
            counter_family("paddle_tpu_shipper_snapshots_total",
                           "Registry snapshots shipped to the collector",
                           [(labels, c["snapshots"])]),
            counter_family("paddle_tpu_shipper_flushes_total",
                           "Shipper flush attempts (by outcome; a "
                           "'failover' marks a flush that rotated to "
                           "the next collector in the HA list)",
                           [({**labels, "outcome": "ok"},
                             c["flushes"] - c["flush_failures"]),
                            ({**labels, "outcome": "failed"},
                             c["flush_failures"]),
                            ({**labels, "outcome": "failover"},
                             c["failovers"])]),
            counter_family("paddle_tpu_shipper_flush_seconds_total",
                           "Shipper thread seconds spent flushing",
                           [(labels, round(c["flush_seconds"], 6))]),
        ]

    # -- lifecycle -----------------------------------------------------------

    def close(self, timeout: float = 5.0) -> None:
        self.journal.unsubscribe(self._sub)
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=timeout)
        self.registry.remove_collector(self._telemetry_cid)


# -- the process-wide shipper -------------------------------------------------

_lock = threading.Lock()
_active: Optional[Shipper] = None
_explicit = False   # was the active shipper attached via ship_to()?


def ship_to(addr: AddrLike, origin: Optional[str] = None,
            **kw) -> Shipper:
    """Attach THE process shipper to a collector. Idempotent for the
    same address AND origin (returns the running shipper); a different
    address — or an explicitly different ``origin`` — closes the old
    shipper and starts a new one (a requested origin must never be
    silently dropped: alert keys and dashboards are built on it)."""
    return _ship(addr, origin, explicit=True, **kw)


def _ship(addr: AddrLike, origin: Optional[str], explicit: bool,
          **kw) -> Shipper:
    global _active, _explicit
    target = parse_addrs(addr)
    # construction happens UNDER the lock (it is cheap: no connect —
    # the client is lazy), so two racing first-time callers (a Trainer
    # and a PredictorServer built concurrently, both auto-shipping)
    # can never both install a shipper and leak the loser's thread +
    # journal subscription. Closing the displaced shipper (joins its
    # thread) happens outside.
    with _lock:
        if _active is not None:
            if _active.addrs == target and \
                    (origin is None or origin == _active.origin):
                _explicit = _explicit or explicit
                return _active
            if not explicit and _explicit:
                # the env-var DEFAULT yields to an explicit ship_to():
                # a later-constructed Trainer/server must not silently
                # reroute a deliberately redirected process back to
                # PDTPU_TELEMETRY_ADDR (the redirected collector would
                # page origin-down for a live process)
                return _active
        shipper = Shipper(target, origin=origin, **kw)
        old, _active = _active, shipper
        _explicit = explicit
    if old is not None:
        old.close()
    return shipper


def active_shipper() -> Optional[Shipper]:
    with _lock:
        return _active


def stop_shipping() -> None:
    """Close + detach the process shipper (tests; idempotent)."""
    global _active, _explicit
    with _lock:
        shipper, _active = _active, None
        _explicit = False
    if shipper is not None:
        shipper.close()


def maybe_auto_ship() -> Optional[Shipper]:
    """Start the process shipper iff ``PDTPU_TELEMETRY_ADDR`` is set —
    called by every ``Trainer``/``PredictorServer`` constructor, so pointing a whole fleet at a collector is ONE env
    var and zero code. An EXPLICITLY attached shipper (``ship_to``) is
    never displaced by the env default. Never raises: telemetry must
    not take down the process it observes."""
    addr = os.environ.get("PDTPU_TELEMETRY_ADDR")
    if not addr:
        return None
    try:
        return _ship(addr, None, explicit=False)
    except Exception as e:
        _log().warning("PDTPU_TELEMETRY_ADDR=%r: could not start the "
                       "telemetry shipper (%s: %s)", addr,
                       type(e).__name__, e)
        return None


__all__ = ["ReplicationClient", "Shipper", "ShipperClient",
           "active_shipper", "default_origin", "flush_jitter",
           "maybe_auto_ship", "parse_addr", "parse_addrs", "ship_to",
           "stop_shipping"]
