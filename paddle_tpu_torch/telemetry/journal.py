"""Structured run journal: one correlated JSONL event stream per
process (counterpart of ``paddle_tpu.telemetry.journal``, the same
events, lines and env vars).

Every event carries the process ``run`` id, a monotonic ``seq``, a
wall-clock ``t``, a ``kind`` (dotted ``subsystem.event``), and an
optional ``span`` — the trace id minted at ``submit``/dispatch time
and propagated through feeder fill, fused-dispatch chunks, serving
worker execution, and the async-PS wire protocol, so one slow request
or lost push is attributable end to end (``tools/flight_dump.py
--span <id>`` renders exactly its lifecycle).

The journal always retains a bounded ring of recent events — the
flight recorder's buffer (:mod:`paddle_tpu_torch.telemetry.recorder` flushes
it to disk on crash-shaped triggers). A JSONL file sink is opt-in
(:meth:`RunJournal.open`, or ``PDTPU_JOURNAL_PATH`` for the process
default): the hot path then pays one ``json.dumps`` + buffered write
per event, which is why dispatch-rate emitters stay ring-only by
default.

Emitting is cheap by construction (dict build + lock + deque append,
no device interaction): the trainer emits once per DISPATCH (not per
step), which keeps journal overhead inside the <2% K=16 budget the
tests pin, with zero added device↔host syncs.

At very high serving QPS even the ring fills with request-lifecycle
events faster than anything else can land in it. **Per-kind sampling**
(``RunJournal(sample={"serving": 0.01})``, or
``PDTPU_JOURNAL_SAMPLE=serving=0.01,ps=0.5`` for the process default)
keeps a deterministic fraction: the keep/drop decision is a hash of
the event's **span** (so one request's submit → dispatch → complete
events share a fate — a sampled-in submit always keeps its lifecycle)
or of the event's seq for span-less events. No ``random`` anywhere:
the same traffic journals the same events every run. Kinds match by
longest dotted prefix (``"serving"`` covers every ``serving.*`` kind;
``"*"`` is the catch-all); unconfigured kinds always keep. Dropped
events still consume a ``seq`` (gaps in the sink are visible sampling,
not corruption) and are counted in ``dropped_sampled``.
"""

from __future__ import annotations

import json
import os
import secrets
import threading
import time
import zlib
from collections import deque
from typing import Any, Dict, List, Optional

# ring capacity: enough context to explain the seconds before a crash
# without a week-long fit growing memory (one event is ~200 bytes)
DEFAULT_RING = 4096


def new_run_id() -> str:
    """Process run id: wall-clock prefix (sortable across a fleet's
    dumps) + random suffix (unique across same-second restarts)."""
    return time.strftime("%Y%m%dT%H%M%S") + "-" + secrets.token_hex(4)


# span ids are minted on hot paths (one per dispatch chunk / serving
# request); os.urandom per mint costs tens of µs on some kernels, so
# spans are a per-process random prefix (urandom, once) + a counter —
# unique within the process by construction, unique across a fleet's
# processes by the 32-bit prefix
_span_lock = threading.Lock()
_span_prefix = secrets.token_hex(4)
_span_counter = 0


def _mint_span() -> str:
    global _span_counter
    with _span_lock:
        _span_counter += 1
        n = _span_counter
    return f"{_span_prefix}{n & 0xFFFFFFFF:08x}"


class RunJournal:
    """Thread-safe correlated event stream (ring + optional sinks)."""

    def __init__(self, run_id: Optional[str] = None,
                 ring_size: int = DEFAULT_RING,
                 sample: Optional[Dict[str, float]] = None):
        self.run_id = run_id or new_run_id()
        self._lock = threading.Lock()
        self._seq = 0
        self._ring: deque = deque(maxlen=ring_size)
        self._files: List[Any] = []
        self._sample: Dict[str, float] = dict(sample or {})
        self._subscribers: Dict[int, Any] = {}
        self._next_sub = 0
        self.dropped_sink_writes = 0
        self.dropped_sampled = 0
        self.ingested = 0

    # -- spans -------------------------------------------------------------
    @staticmethod
    def new_span() -> str:
        """Mint a trace/span id (16 hex chars): at ``submit`` for a
        serving request, at chunk fill/dispatch for a training step,
        at ``step`` for an async-PS push batch. Cheap by construction
        (a counter under a process-random prefix, no urandom per
        call) — minting rides hot paths."""
        return _mint_span()

    # -- sampling ----------------------------------------------------------
    def set_sample(self, sample: Optional[Dict[str, float]]) -> None:
        """Replace the per-kind sampling table: ``{kind_prefix: rate}``
        with rates in [0, 1] (``{}``/None keeps everything). Matching
        is by longest dotted prefix of the event kind; ``"*"`` is the
        catch-all for otherwise-unconfigured kinds."""
        with self._lock:
            self._sample = dict(sample or {})

    def sample_rate(self, kind: str) -> float:
        """The configured keep-rate for ``kind`` (1.0 = keep all)."""
        with self._lock:
            return self._rate_locked(kind)

    def _rate_locked(self, kind: str) -> float:
        s = self._sample
        if not s:
            return 1.0
        k = kind
        while True:
            if k in s:
                return float(s[k])
            if "." not in k:
                break
            k = k.rsplit(".", 1)[0]
        return float(s.get("*", 1.0))

    @staticmethod
    def _sampled_in(key: str, rate: float) -> bool:
        # deterministic keep/drop: a crc32 of the span (or seq) mapped
        # onto [0, 1) — NOT random.random(), so the same traffic
        # journals the same events every run, and every event of one
        # span shares a fate (span-consistent sampling)
        if rate >= 1.0:
            return True
        if rate <= 0.0:
            return False
        return (zlib.crc32(key.encode()) & 0xFFFFFFFF) / 2.0 ** 32 < rate

    # -- sinks -------------------------------------------------------------
    def open(self, path: str) -> "RunJournal":
        """Attach a JSONL file sink (append mode, line-buffered via
        explicit flush per event). Multiple sinks are allowed."""
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        f = open(path, "a", encoding="utf-8")
        with self._lock:
            self._files.append(f)
        return self

    def close(self) -> None:
        with self._lock:
            files, self._files = self._files, []
        for f in files:
            try:
                f.close()
            except OSError:
                pass

    # -- subscribers -------------------------------------------------------
    def subscribe(self, fn) -> int:
        """Register a live-event callback: ``fn(event)`` is called for
        EVERY event — per-kind sampling does NOT apply (sampling is the
        ring/sink pressure valve; a subscriber is a live observation
        channel, and the fleet wire's ``DISPATCHED`` ordering hangs off
        it — a sampled-out ``serving.dispatch`` must still fire it).
        Called AFTER the ring append (or sampling drop) and OUTSIDE the
        journal lock — a subscriber may emit or read without
        deadlocking, at the cost of cross-thread callback ordering not
        being seq-strict; it runs on the EMITTER's thread, so keep it
        cheap and never let it block unboundedly. Exceptions are
        swallowed (telemetry never takes down the run it observes).
        Returns a handle for :meth:`unsubscribe`."""
        with self._lock:
            sid = self._next_sub
            self._next_sub += 1
            self._subscribers[sid] = fn
            return sid

    def unsubscribe(self, sid: int) -> None:
        with self._lock:
            self._subscribers.pop(sid, None)

    # -- emission ----------------------------------------------------------
    def emit(self, kind: str, span: Optional[str] = None,
             **fields) -> Dict[str, Any]:
        """Record one event; returns the event dict (already sequenced).
        The sink write happens UNDER the journal lock: concurrent
        emitters (serving workers, the watchdog, the feeder fill
        thread, the training loop) must neither interleave bytes
        mid-line nor land out of ``seq`` order in the JSONL file. A
        failing file sink is counted, never raised — telemetry must
        not take down the run it observes."""
        subs: List[Any] = []
        with self._lock:
            self._seq += 1
            event: Dict[str, Any] = {"run": self.run_id, "seq": self._seq,
                                     "t": time.time(), "kind": kind}
            if span is not None:
                event["span"] = span
            event.update(fields)
            if self._subscribers:
                subs = list(self._subscribers.values())
            rate = self._rate_locked(kind)
            sampled_out = rate < 1.0 and not self._sampled_in(
                span if span is not None else f"{self.run_id}:{self._seq}",
                rate)
            if sampled_out:
                # sampled out: the seq is consumed (sink gaps read as
                # sampling, not corruption) but neither ring nor sinks
                # see the event — the high-QPS pressure valve.
                # Subscribers still fire below: they are not a sink.
                self.dropped_sampled += 1
            else:
                self._ring.append(event)
                self._write_sinks_locked(event, kind)
        for fn in subs:
            try:
                fn(event)
            except Exception:
                pass
        return event

    def _write_sinks_locked(self, event: Dict[str, Any], kind: str) -> None:
        if not self._files:
            return
        try:
            line = json.dumps(event, sort_keys=True,
                              default=_json_default) + "\n"
        except (TypeError, ValueError):
            line = json.dumps(
                {"run": event.get("run", self.run_id), "seq": event["seq"],
                 "t": event["t"], "kind": kind,
                 "unserializable": True}) + "\n"
        for f in self._files:
            try:
                f.write(line)
                f.flush()
            except (OSError, ValueError):
                self.dropped_sink_writes += 1

    def ingest(self, events, origin: Optional[str] = None) -> int:
        """Absorb another process's journal events into this one: a fleet
        router pulls each replica process's retained ring over the framed
        control link (the ``JOURNAL`` verb) and ingests it here, so one
        ring (and one JSONL sink) holds the fleet-wide timeline.

        Shipped events keep their own ``run`` id and ``seq`` (this
        journal's ``seq`` is not consumed) and gain an ``origin`` field
        when one is given (the replica's name). Returns the number of
        events ingested."""
        n = 0
        with self._lock:
            for event in events:
                if not isinstance(event, dict) or "kind" not in event:
                    continue
                event = dict(event)
                if origin is not None:
                    event.setdefault("origin", origin)
                self._ring.append(event)
                self._write_sinks_locked(event, str(event["kind"]))
                n += 1
            self.ingested += n
        return n

    # -- reads -------------------------------------------------------------
    def recent(self, n: Optional[int] = None,
               kind: Optional[str] = None,
               span: Optional[str] = None) -> List[Dict[str, Any]]:
        """The retained ring (oldest first), optionally filtered by
        ``kind`` prefix and/or ``span``."""
        with self._lock:
            events = list(self._ring)
        if kind is not None:
            events = [e for e in events if e["kind"].startswith(kind)]
        if span is not None:
            events = [e for e in events if e.get("span") == span]
        if n is not None:
            events = events[-n:]
        return events

    @property
    def seq(self) -> int:
        with self._lock:
            return self._seq


def _json_default(o):
    try:
        import numpy as np
        if isinstance(o, np.generic):
            return o.item()
        if isinstance(o, np.ndarray):
            return o.tolist()
    except ImportError:
        pass
    return repr(o)


# -- the process-wide default journal -----------------------------------------

_default_lock = threading.Lock()
_default_journal: Optional[RunJournal] = None


def parse_sample(spec: Optional[str]) -> Dict[str, float]:
    """Parse a ``PDTPU_JOURNAL_SAMPLE`` value — comma-separated
    ``kind=rate`` pairs, e.g. ``"serving=0.01,ps=0.5"`` — into a
    sampling table. Malformed entries are skipped (a bad env var must
    not break startup); rates clamp to [0, 1]."""
    out: Dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        kind, _, rate = part.partition("=")
        try:
            out[kind.strip()] = min(1.0, max(0.0, float(rate)))
        except ValueError:
            continue
    return out


def get_journal() -> RunJournal:
    """THE process journal (created on first use; honors
    ``PDTPU_JOURNAL_PATH`` as an initial JSONL sink and
    ``PDTPU_JOURNAL_SAMPLE`` as the initial per-kind sampling
    table)."""
    global _default_journal
    with _default_lock:
        if _default_journal is None:
            j = RunJournal(
                sample=parse_sample(os.environ.get("PDTPU_JOURNAL_SAMPLE")))
            path = os.environ.get("PDTPU_JOURNAL_PATH")
            if path:
                try:
                    j.open(path)
                except OSError:
                    pass  # an unwritable sink must not break startup
            _default_journal = j
        return _default_journal


def set_journal(journal: Optional[RunJournal]) -> Optional[RunJournal]:
    """Swap the process journal (tests; returns the previous one)."""
    global _default_journal
    with _default_lock:
        old, _default_journal = _default_journal, journal
        return old


__all__ = ["DEFAULT_RING", "RunJournal", "get_journal", "new_run_id",
           "parse_sample", "set_journal"]
