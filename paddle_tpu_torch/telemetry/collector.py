"""Telemetry collector daemon: fleet-wide time series, alerts, and
cross-process trace timelines from pushed telemetry (counterpart of
``paddle_tpu.telemetry.collector``, copied and adapted: the same push
verbs, ``SEGMENTS`` replication and HTTP endpoints, so a shipper, a
reader or a standby of either package works against a collector of the
other). The daemon is a host process: it touches no CUDA state.

Everything before this module is pull-only and per-process: each
trainer/replica serves its own ``/metrics``, and journal shipping
exists only for fleet-OWNED replicas (``FleetRouter.ship_journals``).
The collector inverts the direction: ANY process — a trainer, an
out-of-process serving replica, a router — runs a background
:class:`~paddle_tpu_torch.telemetry.shipper.Shipper` (auto-started by
``PDTPU_TELEMETRY_ADDR``, or ``ship_to(addr)``) that PUSHES its
journal-ring deltas and periodic registry snapshots here over the
same length-prefixed framed wire the async-PS path speaks
(:class:`~paddle_tpu_torch.parallel.async_ps.FramedClient` reuse).

Wire verbs (shipper → collector; one ASCII header line + one json
body; replies ``OK <n>`` / ``ERR <reason>``)::

    PING
    EVENTS <origin> <len>    + {"run": ..., "events": [...]}
    SNAPSHOT <origin> <len>  + {"t": ..., "families": families_snapshot}
    STATS                    (reply: ``OK {json}`` — ingest/store ctrs)
    SEGMENTS <len>           + {"list": true} | {"fetch": name,
                             "offset": k[, "limit": n]} (framed reply
                             body: listing json / raw segment bytes —
                             the cross-host standby's replication pull)

``EVENTS`` ingestion is idempotent: events are deduplicated by a
per-``(origin, run)`` high-water ``seq``, so a shipper whose reply was
lost simply resends the batch (no at-most-once dance needed on a
telemetry path — double-counting is prevented server-side).

The collector maintains:

- a :class:`SeriesStore` — per-origin bounded time-series rings over
  every pushed metric sample (counters/gauges as ``(t, value)``,
  histograms as ``(t, bucket counts)``), the substrate the
  :class:`~paddle_tpu_torch.telemetry.alerts.AlertEngine` evaluates every
  ``eval_interval`` and an autoscaler can read;
- its OWN :class:`~paddle_tpu_torch.telemetry.journal.RunJournal` holding
  the ingested fleet-wide event stream (every event keeps its origin
  run/seq and gains ``origin=``) — one ring answers "what was the
  whole fleet doing around this span";
- HTTP read endpoints (:meth:`TelemetryCollector.serve_http`):
  ``/metrics`` (every origin's latest snapshot merged under an
  ``origin`` label — naming-contract clean), ``/alerts`` (JSON,
  firing + pending + recently-resolved), and ``/timeline?trace=<span>``
  (the cross-process waterfall of one trace id, assembled from the
  ingested journals; ``&format=text`` renders it).

An alert transition journals ``alert.firing``/``alert.resolved`` and
— for ``page``-severity rules (or all, with ``dump_on_fire=True``) —
triggers a local flight dump carrying the fleet-wide ring, so the
evidence is on disk the moment the pager goes off.

**Durability & HA** (``store_dir=``): every ingest is written through
to a :class:`~paddle_tpu_torch.telemetry.store.SegmentStore` — a segmented,
CRC-framed, retention-bounded (time AND bytes) append-only log. A
restart replays it: rings, dedupe high-water marks, the fleet journal,
and alert firing/pending state all come back (a firing alert stays
firing with its original clock — no re-fire, no resolve flap), and
``GET /query?metric=...&labels=...&from=...&to=...&step=...`` range
reads serve from the log so history survives the process. A SECOND
collector started with ``standby=True`` over the same (shared-
filesystem) ``store_dir`` ingests nothing until the first failed-over
push arrives — the shipper's comma-separated ``PDTPU_TELEMETRY_ADDR``
failover list routes pushes to it once the primary dies — at which
point it PROMOTES by replaying the log. A standby on ANOTHER machine
(no shared filesystem) passes ``replicate_from="host:port"`` instead:
it continuously pulls the primary's sealed segments and open-segment
tail over the ``SEGMENTS`` verb into its OWN ``store_dir``
(CRC-re-verified against each segment's sidecar on receipt), and the
promotion fence moves from heartbeat-file stamps to the replication
stream — a standby refuses to promote while its replication source
still answers a direct probe, so a returning primary keeps the pen. Alert rules hot-reload via
SIGHUP (the daemon re-lints ``--rules``) or ``POST /rules``; findings
from :func:`~paddle_tpu_torch.telemetry.alerts.lint_rules` REJECT the
reload, success journals ``alert.rules_reloaded``.

Run in-process (``TelemetryCollector()``) or standalone::

    python -m paddle_tpu_torch.telemetry.collector [--port N] [--http-port N]
        [--rules rules.json] [--eval-interval S] [--flight-root DIR]

The daemon prints ``PORT <n>`` and ``HTTP <n>`` once listening (the
:class:`CollectorProcess` handshake, same discipline as
``replica_main``).
"""

from __future__ import annotations

import json
import math
import socket
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from . import alerts as _alerts
from .journal import RunJournal
from .recorder import FlightRecorder
from .registry import (MetricFamily, _series_key, counter_family,
                       families_from_snapshot, gauge_family, merge_exports)


def _log():
    import logging
    return logging.getLogger("paddle_tpu_torch.telemetry.collector")


def _reply_json(conn: socket.socket, payload) -> None:
    """Framed reply body: ``OK <len>\\n`` + payload. A dict/list is
    JSON-encoded; raw bytes pass through (the SEGMENTS fetch form ships
    segment-file bytes verbatim — their integrity rides the CRC
    sidecar, not the frame)."""
    if not isinstance(payload, (bytes, bytearray)):
        payload = json.dumps(payload, sort_keys=True,
                             separators=(",", ":")).encode()
    conn.sendall(b"OK %d\n" % len(payload) + bytes(payload))


# -- per-origin time series ---------------------------------------------------


class SeriesStore:
    """Bounded time-series rings over pushed metric snapshots, keyed by
    series (name + labels, the pushing origin stamped as an ``origin``
    label). Counters/gauges ring ``(t, value)``; histograms ring
    ``(t, bucket counts, sum, count)`` so windowed quantiles come from
    bucket DELTAS. Origins that stop pushing for ``origin_expiry_s``
    are retired wholesale (their series and last-push mark dropped) —
    which is what lets a replica-down absence alert RESOLVE once the
    operator replaced the process."""

    def __init__(self, max_points: int = 512, origin_expiry_s: float = 60.0,
                 value_ttl_s: float = 60.0):
        self.max_points = int(max_points)
        self.origin_expiry_s = float(origin_expiry_s)
        # a sample older than this yields NO threshold verdict (and a
        # rate window with no sample inside it yields none either): a
        # dead origin's last breaker_open=1 gauge must not keep paging
        # until origin expiry — staleness is the absence alert's job
        self.value_ttl_s = float(value_ttl_s)
        self._lock = threading.Lock()
        # series key -> ring; meta: key -> (name, labels, type[, bounds])
        self._rings: Dict[str, deque] = {}
        self._meta: Dict[str, Tuple[str, Dict[str, str], str, Any]] = {}
        self._by_origin: Dict[str, set] = {}
        # metric name -> series keys: rule matching must not scan every
        # stored series under the lock on every eval tick
        self._by_name: Dict[str, set] = {}
        self._latest_snap: Dict[str, Dict[str, Any]] = {}
        self.last_push: Dict[str, float] = {}

    # -- writes --------------------------------------------------------------

    @staticmethod
    def _sanitize(snapshot) -> Dict[str, Any]:
        """Coerce a PUSHED snapshot into the strict families_snapshot
        shape BEFORE storing it: a version-skewed or buggy client must
        not be able to poison every later ``/metrics`` read (a family
        missing ``help`` becomes a visible ``validate_families``
        violation, never a 500 on scrape). VALUES are validated too —
        a scalar sample must be float-coercible and a histogram sample
        a well-formed bounds/counts dict, or the SAMPLE is dropped:
        one bad process must never make the fleet-wide scrape
        unrenderable."""
        out: Dict[str, Any] = {}
        for name, fam in (snapshot or {}).items():
            if not isinstance(fam, dict):
                continue
            ftype = str(fam.get("type", "untyped"))
            samples = []
            for s in fam.get("samples") or []:
                if not isinstance(s, dict) or "value" not in s:
                    continue
                value = s["value"]
                if ftype == "histogram":
                    if not isinstance(value, dict):
                        continue
                    try:
                        bounds = [float(b) for b in
                                  value.get("bounds") or []]
                        counts = [int(c) for c in
                                  value.get("counts") or []]
                        value = {"bounds": bounds, "counts": counts,
                                 "sum": float(value.get("sum", 0.0)),
                                 "count": int(value.get("count", 0))}
                    except (TypeError, ValueError):
                        continue
                    if len(counts) != len(bounds) + 1:
                        continue
                else:
                    try:
                        value = float(value)
                    except (TypeError, ValueError):
                        continue
                labels = s.get("labels")
                samples.append(
                    {"labels": ({str(k): str(v)
                                 for k, v in labels.items()}
                                if isinstance(labels, dict) else {}),
                     "value": value})
            out[str(name)] = {"type": ftype,
                              "help": str(fam.get("help", "")),
                              "samples": samples}
        return out

    def ingest(self, origin: str, snapshot: Dict[str, Any],
               t: Optional[float] = None, sanitized: bool = False) -> int:
        """Absorb one origin's ``families_snapshot`` dict (sanitized —
        see :meth:`_sanitize`; ``sanitized=True`` skips the pass for a
        snapshot that already went through it, e.g. a segment-log
        replay of a previously-sanitized push); returns the number of
        samples ringed."""
        t = time.time() if t is None else t
        if not sanitized:
            snapshot = self._sanitize(snapshot)
        n = 0
        with self._lock:
            self._latest_snap[origin] = snapshot
            self.last_push[origin] = t
            keys = self._by_origin.setdefault(origin, set())
            for name, fam in snapshot.items():
                ftype = fam.get("type", "untyped")
                for s in fam.get("samples", []):
                    labels = dict(s.get("labels", {}))
                    labels.setdefault("origin", origin)
                    key = _series_key(name, labels)
                    ring = self._rings.get(key)
                    if ring is None:
                        ring = self._rings[key] = deque(
                            maxlen=self.max_points)
                    value = s.get("value")
                    if ftype == "histogram" and isinstance(value, dict):
                        self._meta[key] = (name, labels, ftype,
                                           tuple(value.get("bounds", ())))
                        ring.append((t, tuple(value.get("counts", ())),
                                     float(value.get("sum", 0.0)),
                                     int(value.get("count", 0))))
                    else:
                        try:
                            v = float(value)
                        except (TypeError, ValueError):
                            continue
                        self._meta[key] = (name, labels, ftype, None)
                        ring.append((t, v))
                    keys.add(key)
                    self._by_name.setdefault(name, set()).add(key)
                    n += 1
        return n

    def mark_push(self, origin: str, t: Optional[float] = None) -> None:
        """An EVENTS-only push still proves the origin alive."""
        with self._lock:
            self.last_push[origin] = time.time() if t is None else t
            self._by_origin.setdefault(origin, set())

    def expire(self, now: Optional[float] = None) -> List[str]:
        """Retire origins silent past ``origin_expiry_s``; returns the
        retired names."""
        now = time.time() if now is None else now
        with self._lock:
            stale = [o for o, t in self.last_push.items()
                     if now - t > self.origin_expiry_s]
            for origin in stale:
                self._retire_locked(origin)
        return stale

    def retire(self, origin: str) -> None:
        """Drop one origin wholesale regardless of its push age — the
        segment-log replay path for a persisted ``retire`` record (an
        expiry that already happened must not resurrect on restart)."""
        with self._lock:
            self._retire_locked(origin)

    def _retire_locked(self, origin: str) -> None:
        self.last_push.pop(origin, None)
        self._latest_snap.pop(origin, None)
        for key in self._by_origin.pop(origin, set()):
            self._rings.pop(key, None)
            meta = self._meta.pop(key, None)
            if meta is not None:
                named = self._by_name.get(meta[0])
                if named is not None:
                    named.discard(key)
                    if not named:
                        del self._by_name[meta[0]]

    # -- reads ---------------------------------------------------------------

    def origins(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.last_push)

    def latest_snapshots(self) -> Dict[str, Dict[str, Any]]:
        """Per-origin latest ``families_snapshot`` dicts (copied under
        the store lock) — the raw material of :meth:`latest_families`
        and the collector's merged export."""
        with self._lock:
            return dict(self._latest_snap)

    def latest_families(self) -> List[MetricFamily]:
        """Every origin's latest snapshot, merged under ``origin`` —
        the fleet-wide ``/metrics`` body (same primitive as the fleet
        router's ``replica`` merge, so the naming contract holds)."""
        return merge_exports(
            {origin: families_from_snapshot(snap)
             for origin, snap in self.latest_snapshots().items()},
            label="origin")

    def _match_locked(self, metric: str,
                      labels: Dict[str, str]) -> List[str]:
        out = []
        for key in self._by_name.get(metric, ()):
            slabels = self._meta[key][1]
            if all(slabels.get(k) == v for k, v in labels.items()):
                out.append(key)
        return sorted(out)

    # -- the AlertEngine store interface -------------------------------------

    def latest_values(self, metric: str, labels: Dict[str, str],
                      now: Optional[float] = None
                      ) -> List[Tuple[str, Optional[float]]]:
        """Latest sample per matching series — skipping samples older
        than ``value_ttl_s`` (a dead origin's frozen gauge yields no
        verdict; its silence is the absence alert's signal)."""
        now = time.time() if now is None else now
        with self._lock:
            out = []
            for key in self._match_locked(metric, labels):
                ring = self._rings.get(key)
                if not ring or self._meta[key][2] == "histogram":
                    continue
                t1, v1 = ring[-1][0], ring[-1][1]
                if now - t1 > self.value_ttl_s:
                    continue
                out.append((key, v1))
            return out

    def rates(self, metric: str, labels: Dict[str, str], window_s: float,
              now: float) -> List[Tuple[str, Optional[float]]]:
        """Per-second increase over the window: newest sample vs the
        newest sample at/just before the window start (so a window
        spanning exactly two flushes still rates). A decrease (process
        restart reset the counter) clamps to the post-reset value over
        the window rather than going negative. A series with NO sample
        inside the window yields no verdict — a dead origin's last
        burst must not keep a rate alert firing on wholly-stale data
        (the quantile form's idle-window contract, applied here
        too)."""
        with self._lock:
            out = []
            for key in self._match_locked(metric, labels):
                ring = self._rings.get(key)
                if not ring or self._meta[key][2] == "histogram":
                    continue
                pts = list(ring)
                t1, v1 = pts[-1][0], pts[-1][1]
                if t1 < now - window_s:
                    continue  # every sample predates the window
                base = None
                for t0, v0 in reversed(pts[:-1]):
                    base = (t0, v0)
                    if t0 <= now - window_s:
                        break
                if base is None or base[0] >= t1:
                    continue  # a single sample rates nothing
                dv = v1 - base[1]
                if dv < 0:
                    dv = v1  # counter reset: count from zero
                out.append((key, dv / (t1 - base[0])))
            return out

    def quantiles(self, metric: str, labels: Dict[str, str], q: float,
                  window_s: float, now: float
                  ) -> List[Tuple[str, Optional[float]]]:
        """Histogram quantile from the bucket-count DELTA across the
        window (upper-bound estimate, the ``histogram_quantile``
        discipline); a window with no observations yields no verdict
        (the series is skipped, not compared against stale totals)."""
        with self._lock:
            out = []
            for key in self._match_locked(metric, labels):
                meta = self._meta[key]
                if meta[2] != "histogram":
                    continue
                ring = self._rings.get(key)
                if not ring:
                    continue
                pts = list(ring)
                t1, c1 = pts[-1][0], pts[-1][1]
                if t1 < now - window_s:
                    continue  # every sample predates the window
                base = None
                for p in reversed(pts[:-1]):
                    base = p
                    if p[0] <= now - window_s:
                        break
                if base is None:
                    # a single ringed sample: its counts are ALL-TIME
                    # totals, not a window delta — no verdict (the
                    # contract above), never a spurious cold-start p99
                    continue
                c0 = base[1]
                if len(c0) != len(c1):
                    c0 = (0,) * len(c1)
                delta = [max(0, a - b) for a, b in zip(c1, c0)]
                value = _quantile_from_counts(meta[3] or (), delta, q)
                if value is not None:
                    out.append((key, value))
            return out

    def range_query(self, metric: str,
                    labels: Optional[Dict[str, str]] = None,
                    start: float = 0.0, end: Optional[float] = None,
                    step: float = 0.0) -> Dict[str, Any]:
        """In-memory range read over the bounded rings — the ``/query``
        fallback for a collector WITHOUT persistence (same response
        shape as :meth:`~paddle_tpu_torch.telemetry.store.SegmentStore.query`,
        but the horizon is the ring, not the retention window)."""
        from .store import downsample

        labels = dict(labels or {})
        end = time.time() if end is None else end
        out = []
        with self._lock:
            for key in self._match_locked(metric, labels):
                if self._meta[key][2] == "histogram":
                    continue
                pts = [(t, v) for t, v in self._rings.get(key, ())
                       if start <= t <= end]
                out.append({"key": key, "labels": dict(self._meta[key][1]),
                            "points": [[round(t, 6), v] for t, v in
                                       downsample(pts, start, step)]})
        return {"metric": metric, "matchers": labels, "from": start,
                "to": end, "step": step, "series": out}

    def staleness(self, metric: str, labels: Dict[str, str], now: float
                  ) -> List[Tuple[str, float]]:
        with self._lock:
            out = []
            for key in self._match_locked(metric, labels):
                ring = self._rings.get(key)
                if ring:
                    out.append((key, now - ring[-1][0]))
            return out

    def origin_staleness(self, now: float) -> List[Tuple[str, float]]:
        with self._lock:
            return sorted((origin, now - t)
                          for origin, t in self.last_push.items())


def _quantile_from_counts(bounds, counts, q: float) -> Optional[float]:
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= target:
            return float(bounds[i]) if i < len(bounds) else math.inf
    return math.inf


# -- timeline assembly --------------------------------------------------------


def assemble_timeline(events: List[Dict[str, Any]],
                      span: str) -> Dict[str, Any]:
    """The cross-process waterfall of one trace id: every journal
    event carrying ``span``, sorted by wall clock, with per-event
    offsets from the first — the feeder fill → fused dispatch → PS
    wire → serving submit/dispatch/complete lifecycle laid out across
    however many processes shipped it."""
    rows = sorted((e for e in events if e.get("span") == span),
                  key=lambda e: (e.get("t", 0.0), e.get("seq", 0)))
    if not rows:
        return {"span": span, "events": [], "origins": [],
                "duration_s": 0.0}
    t0 = rows[0].get("t", 0.0)
    out_rows = []
    for e in rows:
        out_rows.append({
            "t": e.get("t"),
            "offset_s": round(float(e.get("t", t0)) - t0, 6),
            "origin": e.get("origin", "local"),
            "run": e.get("run"),
            "seq": e.get("seq"),
            "kind": e.get("kind"),
            "detail": {k: v for k, v in e.items()
                       if k not in ("t", "origin", "run", "seq", "kind",
                                    "span")},
        })
    origins = sorted({r["origin"] for r in out_rows})
    return {"span": span,
            "t0": t0,
            "duration_s": round(rows[-1].get("t", t0) - t0, 6),
            "origins": origins,
            "events": out_rows}


def render_timeline_text(tl: Dict[str, Any], width: int = 40) -> str:
    """ASCII waterfall of :func:`assemble_timeline`'s output — shared
    by the collector's ``/timeline?format=text`` and the offline
    ``tools/trace_timeline.py``."""
    rows = tl.get("events", [])
    if not rows:
        return f"span {tl.get('span')}: no events\n"
    dur = max(tl.get("duration_s") or 0.0, 1e-9)
    lines = [f"span {tl['span']}: {len(rows)} event(s) across "
             f"{len(tl['origins'])} origin(s) "
             f"({', '.join(tl['origins'])}), {dur * 1e3:.2f} ms"]
    owidth = max(len(r["origin"]) for r in rows)
    kwidth = max(len(str(r["kind"])) for r in rows)
    for r in rows:
        pos = min(width - 1, int(r["offset_s"] / dur * (width - 1)))
        bar = "." * pos + "|" + "." * (width - 1 - pos)
        detail = ""
        if r["detail"]:
            short = {k: r["detail"][k] for k in sorted(r["detail"])[:3]}
            detail = " " + json.dumps(short, sort_keys=True,
                                      default=repr)[:60]
        lines.append(f"  {r['offset_s'] * 1e3:9.3f}ms [{bar}] "
                     f"{r['origin']:<{owidth}} {str(r['kind']):<{kwidth}}"
                     f"{detail}")
    return "\n".join(lines) + "\n"


# -- the daemon ---------------------------------------------------------------


class TelemetryCollector:
    """The push-ingest + alert-eval + read-endpoint daemon (in-process
    form; ``python -m paddle_tpu_torch.telemetry.collector`` wraps exactly
    this). See the module docstring for the wire and HTTP surfaces."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 rules: Optional[List[_alerts.AlertRule]] = None,
                 eval_interval: float = 0.25,
                 journal_ring: int = 16384,
                 max_points: int = 512,
                 origin_expiry_s: float = 60.0,
                 dump_on_fire=None,
                 flight_root: Optional[str] = None,
                 store_dir: Optional[str] = None,
                 retention_s: float = 24 * 3600.0,
                 retention_bytes: int = 256 << 20,
                 segment_max_bytes: int = 4 << 20,
                 segment_max_s: float = 600.0,
                 standby: bool = False,
                 takeover_s: float = 5.0,
                 replicate_from: Optional[Any] = None,
                 replicate_interval: float = 0.5):
        self.store = SeriesStore(max_points=max_points,
                                 origin_expiry_s=origin_expiry_s)
        # the collector's OWN journal (never the process default): it
        # holds the INGESTED fleet-wide stream plus alert transitions,
        # and a collector embedded in a test/trainer process must not
        # bleed into that process's journal
        self.journal = RunJournal(ring_size=journal_ring)
        self.engine = _alerts.AlertEngine(
            rules if rules is not None else _alerts.preset_rules(),
            on_transition=self._on_transition)
        self.eval_interval = float(eval_interval)
        # dump_on_fire: True = every firing transition dumps, False =
        # never, None (default) = page-severity rules dump
        self.dump_on_fire = dump_on_fire
        self._recorder = FlightRecorder(journal=self.journal,
                                        root=flight_root)
        self._lock = threading.Lock()
        # serializes one EVENTS batch's whole read-filter-ingest-update
        # against another's: a stalled handler thread racing its own
        # retry must not double-ingest (the idempotency contract)
        self._ingest_lock = threading.Lock()
        # (origin, run) -> (high-water ship-seq, last touch): EVENTS
        # dedupe (idempotent ingest makes shipper retries safe
        # server-side). Entries untouched for origin_expiry_s are
        # pruned by the eval loop: a STABLY-NAMED origin that restarts
        # mints a new run id per incarnation and must not leak a dead
        # run's entry per restart forever
        self._high: Dict[Tuple[str, str], Tuple[int, float]] = {}
        self._counters = {"events": 0, "snapshots": 0, "event_batches": 0,
                          "dup_events": 0, "bad_requests": 0,
                          "segments_corrupt": 0}
        self._stop = threading.Event()
        self._http: Optional[Any] = None

        # -- durable series store (telemetry/store.py) -------------------
        # With store_dir every ingest is written through to a
        # segmented, CRC-framed, retention-bounded log; a restart (or a
        # standby promotion) replays it to rebuild rings, dedupe
        # high-water marks, the fleet journal, and alert firing/pending
        # state. _seg_lock makes [counter update → log append] atomic
        # across threads so a 'state' record's absolute counters always
        # agree with its position in the log (replay = baseline +
        # increments, exact).
        self._seg: Optional[Any] = None
        self._seg_lock = threading.Lock()
        self._promote_lock = threading.Lock()
        # one-way flag (True -> False exactly once, in promote() under
        # _promote_lock): the hot paths read it lock-free and promote()
        # re-checks under the lock, so a stale True only costs one extra
        # promote() call
        self._standby = bool(standby)   # lint: allow(thread:unguarded-access)
        # the split-brain fence: a standby only promotes once the
        # active writer's heartbeat (stamped every eval tick, removed
        # on clean close) has been silent this long — a transient
        # primary stall that made ONE flush fail over must not create
        # two writers on the shared store_dir
        self.takeover_s = float(takeover_s)
        self._last_retention = 0.0
        if store_dir:
            from .store import SegmentStore
            self._seg = SegmentStore(
                store_dir, retention_s=retention_s,
                retention_bytes=retention_bytes,
                segment_max_bytes=segment_max_bytes,
                segment_max_s=segment_max_s,
                state_fn=self._state_payload)
            if not self._standby:
                self._recover()
                self._seg.open()
        elif self._standby:
            raise ValueError("standby=True needs a store_dir to promote "
                             "from (a standby without a shared segment "
                             "log has no history to adopt)")

        # -- cross-host replication (telemetry catch-up) -----------------
        # A standby on ANOTHER machine cannot share the primary's
        # store_dir; replicate_from="host:port" (the primary's push
        # wire) makes it pull sealed segments + the open-segment tail
        # over the SEGMENTS verb into its OWN store_dir, continuously.
        # Promotion then replays the local replica — and the fence
        # moves from heartbeat-file stamps (meaningless across hosts)
        # to the replication stream: a standby refuses to promote
        # while its replication source still answers a direct probe.
        self._repl_addr: Optional[Tuple[str, int]] = None
        self._repl_cli: Optional[Any] = None
        self._repl_interval = float(replicate_interval)
        self._repl_last_contact: Optional[float] = None
        self._repl_lock = threading.Lock()
        if replicate_from:
            if not self._standby or self._seg is None:
                raise ValueError(
                    "replicate_from= needs standby=True and a (local) "
                    "store_dir — replication is the cross-host standby's "
                    "copy of the primary's segment log")
            from .shipper import parse_addr
            self._repl_addr = parse_addr(replicate_from)
            self._repl_thread = threading.Thread(
                target=self._replicate_loop, daemon=True,
                name="pdtpu-collector-repl")
            self._repl_thread.start()

        self._ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._ls.bind((host, int(port)))
        self._ls.listen(64)
        self.host = host
        self.port = self._ls.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="pdtpu-collector-accept")
        self._accept_thread.start()
        self._eval_thread = threading.Thread(
            target=self._eval_loop, daemon=True, name="pdtpu-collector-eval")
        self._eval_thread.start()

    # -- lifecycle -----------------------------------------------------------

    @property
    def addr(self) -> Tuple[str, int]:
        return (self.host, self.port)

    def close(self) -> None:
        self._stop.set()
        try:
            self._ls.close()
        except OSError:
            pass
        if self._http is not None:
            self._http.close()
            self._http = None
        self._eval_thread.join(timeout=5.0)
        if self._repl_cli is not None:
            try:
                self._repl_cli.close()
            except Exception:
                pass
            self._repl_cli = None
        if self._seg is not None:
            # a final state record makes a CLEAN shutdown bit-exact on
            # restart even when the last eval tick predates the last
            # ingest; then fsync-close the active segment and drop the
            # writer heartbeat so a standby may take over immediately
            with self._seg_lock:
                if not self._standby:
                    self._seg.append(self._state_record())
            self._seg.close()
            if not self._standby:
                self._seg.clear_heartbeat()

    # -- durable store: write-through, recovery, promotion -------------------

    @property
    def persistent(self) -> bool:
        return self._seg is not None

    @property
    def is_standby(self) -> bool:
        return self._standby

    def _state_payload(self) -> Dict[str, Any]:
        """The 'state' record body (minus the ``k`` tag): absolute
        ingest counters, EVENTS dedupe high-water marks, and the alert
        engine's firing/pending/resolved state — everything replay
        cannot reconstruct from snap/ev records alone."""
        with self._lock:
            ctrs = dict(self._counters)
            high = [[o, r, hw, touched]
                    for (o, r), (hw, touched) in sorted(self._high.items())]
        # rule SPECS ride along so a hot-reloaded pack survives restart
        # and standby promotion (the log, not the boot-time --rules
        # file, is the source of truth for a recovering collector)
        specs = [{"name": r.name, "expr": r.expr, "severity": r.severity,
                  "annotations": dict(r.annotations)}
                 for r in self.engine.rules]
        return {"ctrs": ctrs, "high": high, "rules": specs,
                "engine": self.engine.state()}

    def _state_record(self) -> Dict[str, Any]:
        rec = self._state_payload()
        rec["k"] = "state"
        rec["t"] = time.time()
        return rec

    def _apply_record(self, kind: str, doc: Dict[str, Any]) -> None:
        """Replay one persisted record into the in-memory planes (the
        ``SegmentStore.recover`` callback)."""
        if kind == "snap":
            self.store.ingest(str(doc.get("o", "")), doc.get("f") or {},
                              t=doc.get("t"), sanitized=True)
            self._counters["snapshots"] += 1
        elif kind == "ev":
            origin = str(doc.get("o", ""))
            events = doc.get("e") or []
            self.journal.ingest(events, origin=origin)
            key = (origin, str(doc.get("r", "")))
            hw = int(doc.get("hw", 0))
            t = doc.get("t")
            t = float(t) if isinstance(t, (int, float)) else time.time()
            old = self._high.get(key, (0, 0.0))[0]
            self._high[key] = (max(old, hw), t)
            self.store.mark_push(origin, t=t)
            self._counters["events"] += len(events)
            self._counters["event_batches"] += 1
        elif kind == "retire":
            self.store.retire(str(doc.get("o", "")))
        elif kind == "state":
            for k, v in (doc.get("ctrs") or {}).items():
                # segments_corrupt is NOT restored from the baseline:
                # a still-retained corrupt record is re-detected (and
                # re-counted) by every recovery pass, so carrying the
                # old count forward would grow the monotonic counter
                # by one per restart with zero new corruption
                if k in self._counters and k != "segments_corrupt":
                    self._counters[k] = type(self._counters[k])(v)
            self._high = {(str(o), str(r)): (int(hw), float(touched))
                          for o, r, hw, touched in doc.get("high") or []}
            specs = doc.get("rules")
            if specs:
                try:
                    # assigned directly (not set_rules): replay must
                    # never EMIT transitions, and restore() below
                    # replaces the instance table wholesale anyway
                    self.engine.rules = _alerts.parse_rules(specs)
                except _alerts.AlertRuleError:
                    pass  # keep the boot-time rules
            self.engine.restore(doc.get("engine") or {})

    def _recover(self) -> int:
        """Replay the retained segment log oldest → newest. Counter
        exactness: every segment begins with a 'state' record (absolute
        baseline) and subsequent snap/ev records increment, so any
        retained SUFFIX of history recovers the exact pre-restart
        counts. Corrupt records were already skipped (and counted) by
        the store's reader."""
        n = self._seg.recover(self._apply_record)
        self._counters["segments_corrupt"] += \
            self._seg.counters["corrupt_records"]
        if n:
            _log().info("recovered %d telemetry record(s) from %s "
                        "(%d origin(s), %d corrupt record(s) skipped)",
                        n, self._seg.root, len(self.store.origins()),
                        self._seg.counters["corrupt_records"])
        return n

    # -- cross-host replication (standby pull over SEGMENTS) -----------------

    def _repl_client(self):
        if self._repl_cli is None:
            from .shipper import ReplicationClient
            self._repl_cli = ReplicationClient(self._repl_addr)
        return self._repl_cli

    def _replicate_loop(self) -> None:
        while not self._stop.wait(self._repl_interval):
            if not self._standby:
                return  # promoted: this collector writes its own log now
            try:
                self._replicate_once()
            except Exception as e:
                # primary unreachable (dead, partitioned): nothing to
                # pull — retry next tick; promotion decides liveness
                _log().debug("segment replication pull failed: %s: %s",
                             type(e).__name__, e)

    def _replicate_once(self) -> int:
        """One replication pull: list the primary's segments, adopt
        every sealed segment we lack (sidecar-CRC-verified; a segment
        corrupted in flight is rejected and re-requested next cycle),
        then extend the open-segment mirror by exact byte offset.
        Returns the number of sealed segments adopted."""
        with self._repl_lock:
            cli = self._repl_client()
            listing = cli.listing()
            n = 0
            have = self._seg.sealed_names()
            for ent in listing.get("segments") or []:
                name = str(ent.get("name"))
                if name in have:
                    continue
                data = cli.fetch(name)
                if self._seg.ingest_sealed(name, data,
                                           ent.get("meta") or {}):
                    n += 1
            op = listing.get("open")
            if op and op.get("name"):
                name, psize = str(op["name"]), int(op.get("size", 0))
                local = self._seg.mirror_size(name)
                while local < psize:
                    chunk = cli.fetch(name, offset=local,
                                      limit=psize - local)
                    if not chunk:
                        break
                    new = self._seg.ingest_open_tail(name, local, chunk)
                    if new <= local:
                        break
                    local = new
            self._repl_last_contact = time.monotonic()
            return n

    def _primary_reachable(self) -> bool:
        """One direct probe of the replication source — the cross-host
        half of the split-brain fence. True means a live (or returned)
        primary still owns the pen; a standby must not promote over
        it."""
        if self._repl_addr is None:
            return False
        from .shipper import ReplicationClient
        try:
            cli = ReplicationClient(self._repl_addr,
                                    timeout=min(1.0, max(self.takeover_s,
                                                         0.1)))
            try:
                cli.ping()
                return True
            finally:
                cli.close()
        except Exception:
            return False

    def promote(self, force: bool = False) -> bool:
        """Standby → active: replay the shared segment log (rings,
        journal, dedupe marks, alert state — firing instances come back
        firing WITHOUT a new transition) and take over appending to it.
        Idempotent; called automatically on the first data push a
        standby receives (the shipper failed over), or explicitly by an
        operator (``force=True`` skips the fence). Returns True if
        this call did the promotion.

        The fence: promotion REFUSES (raises — the push gets an ERR,
        the shipper re-buffers and retries) while the active writer's
        heartbeat is fresher than ``takeover_s``. One transiently
        stalled primary flush must not let a standby seize the shared
        log out from under a live writer (split-brain: two appenders,
        duplicate alerts, a sidecar CRC committed over a file the
        primary still has open). A dead primary stops stamping, so the
        fence clears within ``takeover_s``; a CLEAN shutdown removes
        the stamp and the takeover is immediate."""
        with self._promote_lock:
            if not self._standby:
                return False
            if self._seg is not None:
                if not force:
                    age = self._seg.heartbeat_age()
                    if age is not None and age < self.takeover_s:
                        raise RuntimeError(
                            f"standby not promoting: the active "
                            f"writer's heartbeat is {age:.1f}s old "
                            f"(< takeover_s={self.takeover_s:g}) — "
                            "retry after it goes silent")
                    # the cross-host fence: with replicate_from the
                    # heartbeat file lives in the PRIMARY's store_dir
                    # on another machine — liveness is the replication
                    # stream itself. A returning primary that answers
                    # a direct probe keeps the pen; exactly one writer.
                    if self._primary_reachable():
                        raise RuntimeError(
                            "standby not promoting: the replication "
                            f"source at {self._repl_addr} still answers "
                            "its wire — a live primary keeps the pen "
                            "(force=True overrides)")
                if self._repl_addr is not None:
                    # final catch-up pull: anything the primary sealed
                    # or appended after our last tick and before its
                    # death. Best-effort — a dead primary fails fast
                    # and we promote from what already replicated.
                    try:
                        self._replicate_once()
                    except Exception:
                        pass
                self._recover()
                self._seg.open()
            self._standby = False
            self.journal.emit("collector.promoted",
                              store=self._seg.root if self._seg else None)
            _log().warning("standby collector promoted "
                           "(store=%s, %d origin(s), %d firing alert(s) "
                           "restored)",
                           self._seg.root if self._seg else None,
                           len(self.store.origins()),
                           len(self.engine.firing()))
            return True

    def _seg_append(self, record: Dict[str, Any]) -> None:
        if self._seg is not None and not self._standby:
            with self._seg_lock:
                self._seg.append(record)

    def __enter__(self) -> "TelemetryCollector":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- push wire -----------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._ls.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True,
                             name="pdtpu-collector-conn").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        from ..parallel.async_ps import read_exact, read_line

        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn.settimeout(30.0)
            while not self._stop.is_set():
                try:
                    line = read_line(conn)
                except (ConnectionError, OSError):
                    return
                parts = line.split()
                if not parts or parts[0] == "QUIT":
                    return
                try:
                    reply = self._dispatch(parts, conn, read_exact)
                except (ConnectionError, OSError):
                    return
                except Exception as e:
                    # a malformed header/body may have left its framed
                    # payload UNREAD: reply ERR and close — keeping the
                    # connection would parse leftover body bytes as the
                    # next header and desync every later request (the
                    # shipper's FramedClient reconnects transparently)
                    with self._lock:
                        self._counters["bad_requests"] += 1
                    reply = f"ERR {type(e).__name__}: {e}"[:200].replace(
                        "\n", " ")
                    try:
                        conn.sendall(reply.encode() + b"\n")
                    except OSError:
                        pass
                    return
                if reply is None:
                    continue  # the branch replied itself (SEGMENTS)
                try:
                    conn.sendall(reply.encode() + b"\n")
                except OSError:
                    return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, parts: List[str], conn, read_exact
                  ) -> Optional[str]:
        verb = parts[0]
        if verb == "PING":
            return "OK 0"
        if verb == "SEGMENTS":
            # segment replication (standby pull): {"list": true} → the
            # sealed-segment + open-tail listing; {"fetch": name,
            # "offset": k[, "limit": n]} → raw segment bytes. The
            # branch frames its own reply body (json OR raw bytes) and
            # returns None so _serve_conn sends nothing further.
            if self._seg is None:
                raise ValueError("SEGMENTS needs a collector with a "
                                 "store_dir (no segment log here)")
            req = json.loads(read_exact(conn, int(parts[1])))
            if req.get("fetch"):
                limit = req.get("limit")
                data = self._seg.read_segment(
                    str(req["fetch"]), offset=int(req.get("offset", 0)),
                    limit=None if limit is None else int(limit))
                _reply_json(conn, data)
            else:
                _reply_json(conn, self._seg.replication_listing())
            return None
        if verb == "STATS":
            # ingest/store counters as one JSON object riding the reply
            # line — the bench rows' store-overhead delta source (and a
            # doctor read for operators without the HTTP port)
            return "OK " + json.dumps(self.stats(), sort_keys=True,
                                      separators=(",", ":"))
        if verb in ("EVENTS", "SNAPSHOT") and parts[1] == "collector":
            # reserved: the merged export stamps the collector's OWN
            # series under this origin — a pusher claiming it would be
            # silently overwritten there while still feeding the rings
            # (scrape and alert state would disagree)
            raise ValueError("origin 'collector' is reserved")
        if verb in ("EVENTS", "SNAPSHOT") and self._standby:
            # first data push to a standby: the shippers failed over,
            # so the primary is gone — replay the shared log and take
            # over BEFORE applying this push (its dedupe depends on
            # the replayed high-water marks)
            self.promote()
        if verb == "EVENTS":
            origin, blen = parts[1], int(parts[2])
            body = json.loads(read_exact(conn, blen))
            return f"OK {self._ingest_events(origin, body)}"
        if verb == "SNAPSHOT":
            origin, blen = parts[1], int(parts[2])
            body = json.loads(read_exact(conn, blen))
            t = time.time()
            snap = SeriesStore._sanitize(body.get("families") or {})
            n = self.store.ingest(origin, snap, t=t, sanitized=True)
            with self._seg_lock:
                with self._lock:
                    self._counters["snapshots"] += 1
                if self._seg is not None and not self._standby:
                    self._seg.append({"k": "snap", "o": origin, "t": t,
                                      "f": snap})
            return f"OK {n}"
        # raised (not returned) so the connection CLOSES: an unknown
        # verb from a newer client may carry a framed body this
        # version cannot size — reading on would desync the stream
        raise ValueError(f"unknown verb {verb!r}")

    def _ingest_events(self, origin: str, body: Dict[str, Any]) -> int:
        run = str(body.get("run", ""))
        events = [e for e in body.get("events", [])
                  if isinstance(e, dict) and "kind" in e]
        key = (origin, run)
        # the dedupe mark: a shipper stamps each event with ``sseq``
        # (assigned at buffer-append time, monotonic in ship order
        # even when journal subscribers fire out of journal-seq order,
        # stable across retries); a third-party pusher without it
        # falls back to the journal seq — correct as long as it ships
        # in order
        with self._ingest_lock:
            with self._lock:
                high = self._high.get(key, (0, 0.0))[0]
            fresh = []
            for e in events:
                mark = e.pop("sseq", None)
                if mark is None:
                    mark = e.get("seq")
                if mark is None:
                    # no dedupe mark at all: ingest rather than drop
                    # (dedupe is impossible for such a pusher — a
                    # retried unmarked batch may duplicate, which is
                    # the pusher's trade, not silent loss here)
                    fresh.append(e)
                    continue
                if int(mark) > high:
                    fresh.append(e)
                    high = max(high, int(mark))
            dup = len(events) - len(fresh)
            n = self.journal.ingest(fresh, origin=origin) if fresh else 0
            now = time.time()
            with self._seg_lock:
                with self._lock:
                    self._counters["events"] += n
                    self._counters["dup_events"] += dup
                    self._counters["event_batches"] += 1
                    self._high[key] = (max(self._high.get(key, (0, 0.0))[0],
                                           high), now)
                if self._seg is not None and not self._standby:
                    # written BEFORE the OK reply goes out: an event
                    # batch the shipper saw acknowledged is durable, so
                    # a standby replaying this log dedupes the resend a
                    # failed-over shipper makes of anything UNACKED
                    self._seg.append({"k": "ev", "o": origin, "t": now,
                                      "r": run, "hw": high, "e": fresh})
        self.store.mark_push(origin, t=now)
        return n

    # -- alert evaluation ----------------------------------------------------

    def _eval_loop(self) -> None:
        while not self._stop.wait(self.eval_interval):
            try:
                self.evaluate_once()
            except Exception as e:  # the watchtower must not fall over
                _log().warning("alert evaluation failed: %s: %s",
                               type(e).__name__, e)

    def evaluate_once(self, now: Optional[float] = None
                      ) -> List[Dict[str, Any]]:
        """One expiry + evaluation tick (the eval thread's body; tests
        and drills call it directly for deterministic timing). A
        standby does NOTHING here: it must not expire origins, fire
        alerts, or touch the shared log the primary is writing."""
        if self._standby:
            return []
        now = time.time() if now is None else now
        retired = self.store.expire(now)
        for origin in retired:
            self.journal.emit("collector.origin_retired", origin=origin)
            # persisted so replay does not resurrect the retired
            # origin's series from its older snap records
            self._seg_append({"k": "retire", "o": origin, "t": now})
        # dedupe marks are TTL-pruned, not only origin-retired: a
        # stably-named origin that restarts mints a new run id per
        # incarnation while keeping its last_push fresh, so dead runs'
        # entries would otherwise leak forever on a long-lived
        # collector (a rejoining run re-ships its ring and dedupes
        # from scratch — idempotent-safe)
        gone = set(retired)
        with self._lock:
            for key in [k for k, (_, touched) in self._high.items()
                        if k[0] in gone or
                        now - touched > self.store.origin_expiry_s]:
                del self._high[key]
        transitions = self.engine.evaluate(self.store, now)
        if self._seg is not None:
            self._seg.touch_heartbeat()
            # retention re-lists the dir and re-reads every sealed
            # sidecar — a per-tick sweep would be hundreds of
            # syscalls/s under the store lock for a bound that moves
            # on the scale of segments, so it runs every ~10s
            if now - self._last_retention >= 10.0:
                self._last_retention = now
                self._seg.enforce_retention(now)
            self._persist_state_if_changed()
        return transitions

    def _persist_state_if_changed(self) -> None:
        """Append a 'state' record when anything it captures moved
        since the last tick (ingest counters, dedupe marks, alert
        instances) — idle collectors write nothing, loaded ones write
        one small record per eval tick."""
        with self._seg_lock:
            rec = self._state_record()
            fp = json.dumps({"ctrs": rec["ctrs"], "high": rec["high"],
                             "engine": rec["engine"]},
                            sort_keys=True, default=repr)
            if fp == getattr(self, "_last_state_fp", None):
                return
            self._last_state_fp = fp
            self._seg.append(rec)

    def _on_transition(self, t: Dict[str, Any]) -> None:
        self.journal.emit(f"alert.{t['state']}", rule=t["rule"],
                          key=t["key"], value=t.get("value"),
                          severity=t["severity"], expr=t["expr"])
        _log().warning("alert %s: %s on %s (value=%s)", t["state"],
                       t["rule"], t["key"], t.get("value"))
        if t["state"] == "firing" and (
                self.dump_on_fire is True or
                (self.dump_on_fire is None and t["severity"] == "page")):
            # the pager moment: flush the fleet-wide ring to disk so
            # the evidence exists even if the collector dies next
            self._recorder.dump(f"alert_{t['rule']}", detail=t,
                                span=None)

    # -- read surfaces -------------------------------------------------------

    def families(self, now: Optional[float] = None) -> List[MetricFamily]:
        """ONE merged export: every origin's latest snapshot + the
        collector's own series (stamped ``origin="collector"``) through
        a single :func:`merge_exports` pass, so family declarations
        never repeat and the naming contract holds.

        An origin silent past HALF its expiry scrapes with a
        ``stale="true"`` label on every sample (the JSON form carries
        the same label): its gauges are the last thing a dead process
        said, and an autoscaler reading the merged export must be able
        to tell a fresh 'queue_depth 0' from a frozen one BEFORE the
        origin is retired wholesale."""
        now = time.time() if now is None else now
        with self._lock:
            c = dict(self._counters)
        snap = self.engine.snapshot()
        firing = len(snap["firing"])
        trans = snap["transitions_total"]
        own = [
            counter_family("paddle_tpu_collector_events_total",
                           "Journal events ingested from shippers",
                           [({}, c["events"])]),
            counter_family("paddle_tpu_collector_snapshots_total",
                           "Metric snapshots ingested from shippers",
                           [({}, c["snapshots"])]),
            gauge_family("paddle_tpu_collector_origins",
                         "Origins currently pushing telemetry",
                         [({}, len(self.store.origins()))]),
            gauge_family("paddle_tpu_collector_alerts_firing",
                         "Alert instances currently firing",
                         [({}, firing)]),
            counter_family("paddle_tpu_collector_alert_transitions_total",
                           "Alert state transitions (by state)",
                           [({"state": s}, v)
                            for s, v in sorted(trans.items())]),
        ]
        if self._seg is not None:
            sc = dict(self._seg.counters)
            own += [
                counter_family(
                    "paddle_tpu_collector_segments_corrupt_total",
                    "Corrupt segment records detected and skipped by "
                    "recovery (CRC mismatch, torn tail, bitrot)",
                    [({}, c["segments_corrupt"])]),
                counter_family(
                    "paddle_tpu_collector_store_appends_total",
                    "Records appended to the on-disk series store",
                    [({}, sc["appends"])]),
                counter_family(
                    "paddle_tpu_collector_store_bytes_total",
                    "Bytes appended to the on-disk series store",
                    [({}, sc["bytes"])]),
                counter_family(
                    "paddle_tpu_collector_store_append_seconds_total",
                    "Seconds spent in store appends (ingest-write "
                    "overhead)",
                    [({}, round(sc["append_seconds"], 6))]),
                counter_family(
                    "paddle_tpu_collector_store_append_failures_total",
                    "Store appends that failed (disk full/IO error) — "
                    "pushes were still ACKed from memory, so a nonzero "
                    "rate means the durable log is falling behind",
                    [({}, sc["append_failures"])]),
                gauge_family(
                    "paddle_tpu_collector_store_segments",
                    "Retained segments on disk (active included)",
                    [({}, len(self._seg.segment_paths()))]),
            ]
        stale_after = self.store.origin_expiry_s / 2.0
        ages = self.store.origins()
        named = {}
        for origin, osnap in self.store.latest_snapshots().items():
            fams = families_from_snapshot(osnap)
            if now - ages.get(origin, now) > stale_after:
                for fam in fams:
                    fam.samples = [(dict(labels, stale="true"), value)
                                   for labels, value in fam.samples]
            named[origin] = fams
        named["collector"] = own
        return merge_exports(named, label="origin")

    def stats(self) -> Dict[str, Any]:
        """Flat ingest/store counters (the ``STATS`` wire verb body —
        the bench rows delta these to price store ingest-writes)."""
        with self._lock:
            out: Dict[str, Any] = dict(self._counters)
        out["origins"] = len(self.store.origins())
        out["standby"] = self._standby
        out["persistence"] = self._seg is not None
        if self._seg is not None:
            sc = dict(self._seg.counters)
            out["store"] = {
                "appends": sc["appends"], "bytes": sc["bytes"],
                "append_seconds": round(sc["append_seconds"], 6),
                "append_failures": sc["append_failures"],
                "segments_sealed": sc["segments_sealed"],
                "segments_deleted": sc["segments_deleted"],
                "segments": len(self._seg.segment_paths()),
                "repl_segments": sc["repl_segments"],
                "repl_bytes": sc["repl_bytes"],
                "repl_corrupt": sc["repl_corrupt"],
            }
        out["replicating"] = self._repl_addr is not None
        if self._repl_addr is not None:
            with self._repl_lock:
                last = self._repl_last_contact
            out["repl_contact_age_s"] = (
                None if last is None
                else round(time.monotonic() - last, 3))
        return out

    def query(self, metric: str, labels: Optional[Dict[str, str]] = None,
              start: float = 0.0, end: Optional[float] = None,
              step: float = 0.0) -> Dict[str, Any]:
        """Range-read one metric (the ``GET /query`` body): from the
        durable segment log when persistence is on — the answer then
        survives this collector — else from the bounded in-memory
        rings."""
        if self._seg is not None:
            return self._seg.query(metric, labels, start=start, end=end,
                                   step=step)
        return self.store.range_query(metric, labels, start=start, end=end,
                                      step=step)

    def reload_rules(self, specs: Optional[List[Dict[str, Any]]] = None,
                     path: Optional[str] = None) -> List[str]:
        """Hot-reload the alert rule pack (SIGHUP / ``POST /rules``):
        lint first (:func:`~paddle_tpu_torch.telemetry.alerts.lint_rules`),
        REJECT on any finding (returned; the running rules stay in
        force), else swap via ``AlertEngine.set_rules`` — state keyed
        by rule name survives, firing instances of removed rules
        resolve — and journal ``alert.rules_reloaded``."""
        if (specs is None) == (path is None):
            raise ValueError("pass exactly one of specs= or path=")
        if path is not None:
            try:
                with open(path, "r", encoding="utf-8") as f:
                    doc = json.load(f)
            except (OSError, ValueError) as e:
                return [f"alert:malformed-expr {path}: unreadable rule "
                        f"file: {e}"]
            specs = doc.get("rules", []) if isinstance(doc, dict) else doc
        if not isinstance(specs, list):
            return ["alert:malformed-expr expected a JSON list of rules "
                    "(or {'rules': [...]})"]
        findings = _alerts.lint_rules(specs)
        if findings:
            self.journal.emit("alert.rules_rejected", findings=len(findings),
                              source=path or "<inline>")
            _log().warning("alert rule reload REJECTED (%d finding(s); "
                           "running rules stay in force)", len(findings))
            return findings
        rules = _alerts.parse_rules(specs)
        self.engine.set_rules(rules)
        self.journal.emit("alert.rules_reloaded", rules=len(rules),
                          names=sorted(r.name for r in rules),
                          source=path or "<inline>")
        _log().info("alert rules reloaded: %d rule(s)", len(rules))
        if self._seg is not None and not self._standby:
            with self._seg_lock:
                self._last_state_fp = None
                self._seg.append(self._state_record())
        return []

    def alerts_json(self) -> Dict[str, Any]:
        return self.engine.snapshot()

    def timeline(self, span: str) -> Dict[str, Any]:
        return assemble_timeline(self.journal.recent(), span)

    def serve_http(self, port: int = 0, host: Optional[str] = None):
        """Start the read endpoint: ``/metrics`` + ``/healthz`` +
        ``/alerts`` + ``/timeline?trace=<span>[&format=text]``.
        Idempotent; returns the :class:`~paddle_tpu_torch.telemetry.http.
        TelemetryServer` (``.url``/``.port``)."""
        from .http import serve_metrics
        from .registry import FamiliesView

        if self._http is not None:
            return self._http

        def health():
            return {"live": not self._stop.is_set(),
                    "role": "standby" if self._standby else "collector",
                    "persistence": self._seg is not None,
                    "origins": sorted(self.store.origins()),
                    "alerts_firing": len(self.engine.firing())}

        def alerts_route(query: str):
            body = json.dumps(self.alerts_json(), sort_keys=True,
                              default=repr).encode()
            return 200, "application/json", body

        def timeline_route(query: str):
            params = dict(p.partition("=")[::2]
                          for p in query.split("&") if p)
            span = params.get("trace") or params.get("span")
            if not span:
                return (400, "text/plain; charset=utf-8",
                        b"need ?trace=<span>\n")
            tl = self.timeline(span)
            if params.get("format") == "text":
                return (200, "text/plain; charset=utf-8",
                        render_timeline_text(tl).encode())
            return (200, "application/json",
                    json.dumps(tl, sort_keys=True, default=repr).encode())

        def query_route(query: str):
            params = dict(p.partition("=")[::2]
                          for p in query.split("&") if p)
            metric = params.get("metric")
            if not metric:
                return (400, "text/plain; charset=utf-8",
                        b"need ?metric=<name>[&labels=k=v,k2=v2]"
                        b"[&from=T][&to=T][&step=S]\n")
            try:
                labels = _alerts._parse_labels(params.get("labels"))
                start = float(params.get("from", 0.0))
                end = (float(params["to"]) if params.get("to") is not None
                       and params.get("to") != "" else None)
                step = float(params.get("step", 0.0))
            except (ValueError, _alerts.AlertRuleError) as e:
                return (400, "text/plain; charset=utf-8",
                        f"bad query parameter: {e}\n".encode())
            doc = self.query(metric, labels, start=start, end=end,
                             step=step)
            return (200, "application/json",
                    json.dumps(doc, sort_keys=True, default=repr).encode())

        def rules_post(query: str, body: bytes):
            try:
                specs = json.loads(body.decode("utf-8"))
            except (ValueError, UnicodeDecodeError) as e:
                return (400, "application/json",
                        json.dumps({"accepted": False, "findings": [
                            f"alert:malformed-expr body is not JSON: {e}"
                        ]}).encode())
            if isinstance(specs, dict):
                specs = specs.get("rules", [])
            findings = self.reload_rules(specs=specs)
            doc = {"accepted": not findings, "findings": findings,
                   "rules": [r.describe() for r in self.engine.rules]}
            return (200 if not findings else 422, "application/json",
                    json.dumps(doc, sort_keys=True).encode())

        self._http = serve_metrics(
            registry=FamiliesView(self.families), health_fn=health,
            port=port, host=host or self.host,
            extra_routes={"/alerts": alerts_route,
                          "/timeline": timeline_route,
                          "/query": query_route},
            post_routes={"/rules": rules_post})
        return self._http


# -- out-of-process spawn -----------------------------------------------------


class CollectorProcess:
    """Spawn-and-own a standalone collector daemon (``python -m
    paddle_tpu_torch.telemetry.collector``); parses the ``PORT``/``HTTP``
    handshake. ``addr`` is the push wire, ``http_port`` the read
    endpoint."""

    def __init__(self, rules_path: Optional[str] = None,
                 host: str = "127.0.0.1", args: Tuple[str, ...] = (),
                 store_dir: Optional[str] = None,
                 timeout: float = 300.0):
        # timeout matches ReplicaProcess.wait_ready: the child's cold
        # interpreter + package import can take minutes on a machine
        # already saturated by a test suite or a training fleet
        import os
        import select
        import subprocess
        import sys

        from ..parallel.async_ps import child_python_env

        argv = [sys.executable, "-m", "paddle_tpu_torch.telemetry.collector",
                "--host", host, "--port", "0", "--http-port", "0"]
        if rules_path:
            argv += ["--rules", rules_path]
        if store_dir:
            argv += ["--store-dir", store_dir]
        argv += list(args)
        # a collector child must never ship to itself (or to whatever
        # collector the PARENT ships to — its metrics are its own)
        env = child_python_env(pop=("PDTPU_TELEMETRY_ADDR",
                                    "PDTPU_TELEMETRY_ORIGIN"))
        self._proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                      text=True, env=env)
        self.host = host
        self.port: Optional[int] = None
        self.http_port: Optional[int] = None
        # the pipe is select()ed so the deadline holds even when the
        # child hangs WITHOUT printing (the wait_ready discipline) —
        # and a stalled handshake must not orphan the live daemon the
        # caller has no handle to. Reads are raw os.read on the fd,
        # NOT readline(): when the PORT and HTTP lines land in one
        # pipe chunk, readline() would buffer the second line inside
        # the TextIOWrapper where select() cannot see it — and the
        # handshake would hang on a pipe that already delivered
        # everything (a real observed flake, timing-dependent).
        deadline = time.monotonic() + timeout
        fd = self._proc.stdout.fileno()
        buf = b""
        while self.port is None or self.http_port is None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self.stop()
                raise TimeoutError(
                    f"collector did not hand shake in {timeout:g}s")
            ready, _, _ = select.select([fd], [], [],
                                        min(remaining, 1.0))
            if not ready:
                continue
            chunk = os.read(fd, 4096)
            if not chunk:
                raise RuntimeError(
                    f"collector process exited rc={self._proc.poll()} "
                    "before its handshake")
            buf += chunk
            while b"\n" in buf and (self.port is None or
                                    self.http_port is None):
                line, _, buf = buf.partition(b"\n")
                text = line.decode("utf-8", "replace")
                if text.startswith("PORT "):
                    self.port = int(text.split()[1])
                elif text.startswith("HTTP "):
                    self.http_port = int(text.split()[1])

    @property
    def addr(self) -> Tuple[str, int]:
        return (self.host, self.port)

    @property
    def http_url(self) -> str:
        return f"http://{self.host}:{self.http_port}"

    @property
    def pid(self) -> int:
        return self._proc.pid

    def kill(self) -> None:
        """SIGKILL, no cleanup — the HA drill's primary-death injector
        (``stop()`` is the graceful path)."""
        import signal as _signal

        if self._proc.poll() is None:
            try:
                self._proc.send_signal(_signal.SIGKILL)
            except OSError:
                pass
            try:
                self._proc.wait(timeout=5.0)
            except Exception:
                pass

    def stop(self) -> None:
        if self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5.0)
            except Exception:
                self._proc.kill()

    def __enter__(self) -> "CollectorProcess":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import signal

    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.telemetry.collector",
        description="telemetry collector daemon: push ingest wire + "
                    "/metrics /alerts /timeline")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--bind", default="",
                    help="listener bind address for the push wire AND "
                         "the HTTP endpoint (also PDTPU_BIND_ADDR; "
                         "overrides --host; default loopback)")
    ap.add_argument("--port", type=int, default=0,
                    help="push wire port (0 picks free)")
    ap.add_argument("--http-port", type=int, default=0,
                    help="read endpoint port (0 picks free)")
    ap.add_argument("--rules", default="",
                    help="JSON alert-rule file (default: the preset pack; "
                         "SIGHUP re-lints and hot-reloads it)")
    ap.add_argument("--eval-interval", type=float, default=0.25)
    ap.add_argument("--origin-expiry", type=float, default=60.0)
    ap.add_argument("--flight-root", default="",
                    help="flight-dump root for alert-triggered dumps")
    ap.add_argument("--dump-on-fire", action="store_true",
                    help="flight-dump on EVERY firing transition "
                         "(default: page-severity rules only)")
    ap.add_argument("--store-dir", default="",
                    help="segmented on-disk series store root (empty: "
                         "in-memory only, a restart loses history)")
    ap.add_argument("--retention-s", type=float, default=24 * 3600.0,
                    help="store retention by time (oldest sealed "
                         "segments past this are deleted)")
    ap.add_argument("--retention-bytes", type=int, default=256 << 20,
                    help="store retention by size (oldest-first "
                         "deletion past this)")
    ap.add_argument("--segment-max-bytes", type=int, default=4 << 20)
    ap.add_argument("--standby", action="store_true",
                    help="start as an HA standby over the shared "
                         "--store-dir: no ingestion/eval until the "
                         "first failed-over push promotes it (replaying "
                         "the segment log)")
    ap.add_argument("--takeover-s", type=float, default=5.0,
                    help="standby promotion fence: refuse to promote "
                         "while the active writer's heartbeat is "
                         "fresher than this (0 disables)")
    ap.add_argument("--replicate-from", default="",
                    help="primary collector push-wire addr (host:port) "
                         "to replicate the segment log from — the "
                         "cross-host standby form (needs --standby and "
                         "a LOCAL --store-dir)")
    ap.add_argument("--replicate-interval", type=float, default=0.5,
                    help="seconds between replication pulls")
    args = ap.parse_args(argv)

    import os as _os
    host = args.bind or _os.environ.get("PDTPU_BIND_ADDR") or args.host
    rules = _alerts.load_rules(args.rules) if args.rules else None
    col = TelemetryCollector(
        host=host, port=args.port, rules=rules,
        eval_interval=args.eval_interval,
        origin_expiry_s=args.origin_expiry,
        dump_on_fire=True if args.dump_on_fire else None,
        flight_root=args.flight_root or None,
        store_dir=args.store_dir or None,
        retention_s=args.retention_s,
        retention_bytes=args.retention_bytes,
        segment_max_bytes=args.segment_max_bytes,
        standby=args.standby, takeover_s=args.takeover_s,
        replicate_from=args.replicate_from or None,
        replicate_interval=args.replicate_interval)
    http = col.serve_http(port=args.http_port)
    stop = threading.Event()
    hup = threading.Event()
    # handlers are installed BEFORE the PORT/HTTP handshake prints:
    # the handshake means "ready", and an operator (or drill) may
    # SIGHUP the instant it lands — with the default disposition still
    # in place that signal would KILL the daemon (a real observed
    # race: the HTTP thread can hold the GIL through a first scrape
    # while the main thread has not reached signal.signal yet)
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, lambda *a: stop.set())
        except ValueError:  # not the main thread (embedded call)
            break
    try:
        # the SIGHUP contract: re-lint the --rules file and hot-swap
        # the pack; findings REJECT the reload and the running rules
        # stay in force (the reload never leaves the engine rule-less)
        signal.signal(signal.SIGHUP, lambda *a: hup.set())
    except (ValueError, AttributeError):  # embedded call / no SIGHUP
        pass
    print(f"PORT {col.port}", flush=True)
    print(f"HTTP {http.port}", flush=True)
    import sys as _sys
    try:
        while not stop.wait(0.5):
            if hup.is_set():
                hup.clear()
                # reload chatter goes to STDERR: stdout is the
                # handshake pipe a CollectorProcess parent never
                # drains past PORT/HTTP — enough SIGHUPs printing
                # there would fill the pipe and wedge this loop
                if args.rules:
                    findings = col.reload_rules(path=args.rules)
                    for f in findings:
                        print(f"rules reload rejected: {f}",
                              file=_sys.stderr, flush=True)
                else:
                    print("SIGHUP ignored: no --rules file to reload",
                          file=_sys.stderr, flush=True)
    finally:
        col.close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())


__all__ = [
    "CollectorProcess", "SeriesStore", "TelemetryCollector",
    "assemble_timeline", "render_timeline_text",
]
