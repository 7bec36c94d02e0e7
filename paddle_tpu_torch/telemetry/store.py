"""Durable telemetry: segmented, append-only on-disk series store
(counterpart of ``paddle_tpu.telemetry.store``, copied and adapted: the
same records over the port's ``resilience`` segment log, so a store
directory written by either package reads back equal in the other).

Everything the collector holds — per-origin time-series rings, the
fleet-wide journal, EVENTS dedupe high-water marks, alert
firing/pending state — lived only in memory before this module: one
collector restart erased all history, re-armed every ``for_s`` clock,
and left post-mortems with nothing to read. :class:`SegmentStore` is
the write-through log that fixes that, built on the same durability
discipline the checkpoint path proved (``resilience``):

- **Records** are CRC-framed lines (:func:`resilience.frame_record`):
  a torn tail from a ``kill -9`` mid-append or a bit-flipped byte is
  detected per-record and SKIPPED on recovery — counted
  (``paddle_tpu_collector_segments_corrupt_total``), never a crash.
- **Segments** rotate at ``segment_max_bytes``/``segment_max_s``; a
  finished segment is committed by :func:`resilience.seal_segment`
  (fsync + atomic CRC sidecar). Every segment BEGINS with a ``state``
  record (the collector's absolute counters + alert-engine state), so
  recovery from ANY retained suffix of the log reproduces exact
  counter values: absolute baseline from the first state record, then
  per-record increments.
- **Retention** is enforced by time AND bytes: sealed segments whose
  newest record is older than ``retention_s``, or the oldest ones once
  the store exceeds ``retention_bytes``, are deleted wholesale
  (segment granularity — the classic series-store trade). The active
  segment is never deleted.
- **Recovery** (:meth:`recover`) streams every retained record oldest
  → newest through a caller-supplied ``apply(kind, payload)``; the
  collector replays ``snap`` records into fresh ``SeriesStore`` rings,
  ``ev`` records into its journal + dedupe high-water marks, ``retire``
  records drop an origin, and the last ``state`` record restores the
  :class:`~paddle_tpu_torch.telemetry.alerts.AlertEngine` without re-firing.
  A standby collector PROMOTES by exactly this replay
  (``TelemetryCollector.promote``) — the shared-filesystem HA story.
- **Range reads** (:meth:`query`) scan the retained segments for one
  metric's samples in ``[start, end]`` and downsample to ``step``
  buckets (last-sample-per-bucket, gauge semantics) — the
  ``GET /query`` endpoint the autoscaler and post-mortems read, served
  from disk so the answer survives the collector that wrote it.

Record payloads are compact JSON (one object per line), ``k``-tagged::

    {"k": "snap",   "o": origin, "t": t, "f": families_snapshot}
    {"k": "ev",     "o": origin, "t": t, "r": run, "hw": seq, "e": [...]}
    {"k": "retire", "o": origin, "t": t}
    {"k": "state",  "t": t, "engine": ..., "ctrs": ..., "rules": [...]}

Appends are buffered-write + flush (the OS page cache survives process
death; only power loss can lose a flushed-but-unfsynced tail), with
fsync at every seal. The collector's ingest path pays one ``json.dumps``
plus one buffered write per push batch — pinned under the established
<2%-of-a-K=16-dispatch telemetry budget in
``tests/test_telemetry_store.py``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from .. import resilience

SEGMENT_PREFIX = "segment-"
SEGMENT_SEALED = ".log"
SEGMENT_ACTIVE = ".open"
HEARTBEAT_NAME = "HEARTBEAT"


def _log():
    import logging
    return logging.getLogger("paddle_tpu_torch.telemetry.store")


def _segment_name(index: int, active: bool) -> str:
    return (f"{SEGMENT_PREFIX}{index:08d}"
            f"{SEGMENT_ACTIVE if active else SEGMENT_SEALED}")


def _segment_index(name: str) -> Optional[int]:
    if not name.startswith(SEGMENT_PREFIX):
        return None
    stem, dot, ext = name.rpartition(".")
    if dot + ext not in (SEGMENT_SEALED, SEGMENT_ACTIVE):
        return None
    try:
        return int(stem[len(SEGMENT_PREFIX):])
    except ValueError:
        return None


def downsample(points: List[Tuple[float, float]], start: float,
               step: float) -> List[Tuple[float, float]]:
    """Last-sample-per-bucket downsampling (gauge semantics — counters
    keep their monotonic shape, quantile math happens upstream on
    bucket deltas): bucket ``i`` covers ``[start + i*step, start +
    (i+1)*step)`` and reports its newest sample at the bucket start.
    ``step <= 0`` returns the raw points."""
    if step <= 0 or not points:
        return list(points)
    out: List[Tuple[float, float]] = []
    for t, v in points:  # points arrive time-ordered (log append order)
        bucket = start + int((t - start) // step) * step
        if out and out[-1][0] == bucket:
            out[-1] = (bucket, v)
        else:
            out.append((bucket, v))
    return out


class SegmentStore:
    """One collector's segmented on-disk telemetry log (module
    docstring has the format). Thread-safe: appends, rotation,
    retention, and range reads serialize on one lock; reads of sealed
    segments happen outside it (sealed files are immutable)."""

    def __init__(self, root: str,
                 retention_s: float = 24 * 3600.0,
                 retention_bytes: int = 256 << 20,
                 segment_max_bytes: int = 4 << 20,
                 segment_max_s: float = 600.0,
                 state_fn: Optional[Callable[[], Dict[str, Any]]] = None):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.retention_s = float(retention_s)
        self.retention_bytes = int(retention_bytes)
        self.segment_max_bytes = int(segment_max_bytes)
        self.segment_max_s = float(segment_max_s)
        # state_fn() -> the collector's current "state" payload dict;
        # written as the FIRST record of every new segment so any
        # retained suffix of the log recovers absolute counters
        self.state_fn = state_fn
        self._lock = threading.Lock()
        self._f: Optional[Any] = None
        self._active_index = 0
        self._active_path: Optional[str] = None
        self._active_bytes = 0
        self._active_opened = 0.0
        self._active_first_t: Optional[float] = None
        self._active_last_t: Optional[float] = None
        self._active_records = 0
        # monotonic counters (collector families + bench deltas); the
        # repl_* keys count the STANDBY-side replication ingest (a
        # segment corrupted in flight is rejected and re-requested
        # here — the primary's corrupt_records stays untouched)
        self.counters = {"appends": 0, "bytes": 0, "append_seconds": 0.0,
                         "append_failures": 0, "corrupt_records": 0,
                         "segments_sealed": 0, "segments_deleted": 0,
                         "repl_segments": 0, "repl_bytes": 0,
                         "repl_corrupt": 0}

    # -- layout ---------------------------------------------------------------

    def _scan(self) -> List[Tuple[int, str]]:
        """(index, filename) of every segment on disk, oldest first."""
        out = []
        for name in os.listdir(self.root):
            idx = _segment_index(name)
            if idx is not None:
                out.append((idx, name))
        return sorted(out)

    def segment_paths(self) -> List[str]:
        """Every retained segment, oldest first (the recovery / query /
        ``tools/series_dump.py`` read order)."""
        with self._lock:
            return [os.path.join(self.root, name) for _, name in self._scan()]

    # -- writer liveness (the split-brain fence) ------------------------------

    @property
    def _heartbeat_path(self) -> str:
        return os.path.join(self.root, HEARTBEAT_NAME)

    def touch_heartbeat(self) -> None:
        """The ACTIVE writer stamps this every eval tick (one utime
        syscall). A standby refuses to promote while the stamp is
        fresh — the fence that stops a transient primary stall (one
        slow flush, a GC pause) from creating TWO live writers over
        one shared store_dir."""
        try:
            with open(self._heartbeat_path, "a"):
                pass
            os.utime(self._heartbeat_path, None)
        except OSError:
            pass

    def clear_heartbeat(self) -> None:
        """Graceful shutdown removes the stamp so a standby may take
        over immediately (no takeover wait after a clean close)."""
        try:
            os.remove(self._heartbeat_path)
        except OSError:
            pass

    def heartbeat_age(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds since the active writer's last stamp, or None when
        no writer ever stamped (first boot / clean shutdown)."""
        try:
            mtime = os.path.getmtime(self._heartbeat_path)
        except OSError:
            return None
        return (time.time() if now is None else now) - mtime

    # -- writes ---------------------------------------------------------------

    def open(self) -> "SegmentStore":
        """Start appending: seal any leftover ``.open`` segment from a
        dead writer (its tail was recovered record-by-record; it is
        final now) and begin a fresh active segment. Called AFTER
        recovery — a standby never opens the log until it promotes."""
        with self._lock:
            if self._f is not None:
                return self
            segs = self._scan()
            for idx, name in segs:
                if name.endswith(SEGMENT_ACTIVE):
                    self._seal_leftover(idx, name)
            last = max((i for i, _ in self._scan()), default=0)
            self._open_segment(last + 1)
        self.touch_heartbeat()
        return self

    def _seal_leftover(self, idx: int, name: str) -> None:
        """A dead writer's active segment: rename to sealed and commit
        a sidecar over whatever survived. A trailing line with no
        newline is THE kill -9 artifact — it is trimmed before sealing
        so validate()/series_dump stay clean for a normal crash (the
        bytes are provably unreadable: no frame, no CRC); mid-file
        corruption is preserved as evidence and keeps flagging."""
        src = os.path.join(self.root, name)
        dst = os.path.join(self.root, _segment_name(idx, active=False))
        if os.path.exists(dst):
            # a complete replicated sealed copy already landed (the
            # standby adopted it while this partial mirror lingered):
            # the partial must never clobber it
            try:
                os.remove(src)
            except OSError:
                pass
            return
        try:
            try:
                with open(src, "r+b") as f:
                    data = f.read()
                    if data and not data.endswith(b"\n"):
                        f.truncate(data.rfind(b"\n") + 1)
            except OSError:
                pass
            os.replace(src, dst)
            resilience.seal_segment(dst, meta=self._span_meta(dst))
        except OSError as e:
            _log().warning("could not seal leftover segment %s: %s", name, e)

    def _span_meta(self, path: str) -> Dict[str, Any]:
        first_t = last_t = None
        records = 0
        for ok, payload in resilience.iter_records(path):
            if not ok:
                continue
            records += 1
            try:
                doc = json.loads(payload)
            except ValueError:
                continue
            t = doc.get("t") if isinstance(doc, dict) else None
            if doc.get("k") != "state" and isinstance(t, (int, float)):
                first_t = t if first_t is None else first_t
                last_t = t
        return {"first_t": first_t, "last_t": last_t, "records": records}

    def _open_segment(self, index: int) -> None:
        self._active_index = index
        self._active_path = os.path.join(self.root,
                                         _segment_name(index, active=True))
        self._f = open(self._active_path, "ab")
        self._active_bytes = self._f.tell()
        self._active_opened = time.monotonic()
        self._active_first_t = self._active_last_t = None
        self._active_records = 0
        if self.state_fn is not None:
            try:
                state = dict(self.state_fn())
                state["k"] = "state"
                state.setdefault("t", time.time())
                self._write_locked(state)
            except Exception as e:  # the log must not kill the collector
                _log().warning("segment state record failed: %s: %s",
                               type(e).__name__, e)

    def _write_locked(self, payload: Dict[str, Any]) -> None:
        data = resilience.frame_record(
            json.dumps(payload, separators=(",", ":"),
                       default=_json_default).encode())
        self._f.write(data)
        self._f.flush()
        self._active_bytes += len(data)
        self._active_records += 1
        t = payload.get("t")
        # the sidecar's first_t/last_t span DATA records only: state
        # records carry the append-time clock, and a segment full of
        # synthetic-timestamp test data must not be pruned (or
        # retention-aged) off the state record's wall clock
        if payload.get("k") != "state" and isinstance(t, (int, float)):
            if self._active_first_t is None:
                self._active_first_t = t
            self._active_last_t = t
        self.counters["appends"] += 1
        self.counters["bytes"] += len(data)

    def append(self, payload: Dict[str, Any]) -> bool:
        """Write-through one record (rotating first if the active
        segment is over its byte/age bound). Returns False — counted,
        logged, never raised — when the disk write fails: the
        collector keeps serving from memory."""
        t0 = time.perf_counter()
        try:
            with self._lock:
                if self._f is None:
                    return False
                if (self._active_bytes >= self.segment_max_bytes or
                        (self._active_records > 0 and
                         time.monotonic() - self._active_opened
                         >= self.segment_max_s)):
                    self._rotate_locked()
                self._write_locked(payload)
            return True
        except (OSError, ValueError, TypeError) as e:
            # counted AND exported (store_append_failures_total): the
            # collector deliberately keeps ACKing pushes it could not
            # persist (memory still serves; availability over
            # durability under disk pressure) — but that trade is only
            # safe if a rate() alert can see the log falling behind
            self.counters["append_failures"] += 1
            _log().warning("telemetry store append failed: %s: %s",
                           type(e).__name__, e)
            return False
        finally:
            self.counters["append_seconds"] += time.perf_counter() - t0

    def _rotate_locked(self) -> None:
        self._f.flush()
        self._f.close()
        sealed = os.path.join(self.root,
                              _segment_name(self._active_index, active=False))
        os.replace(self._active_path, sealed)
        resilience.seal_segment(sealed, meta={
            "first_t": self._active_first_t, "last_t": self._active_last_t,
            "records": self._active_records})
        self.counters["segments_sealed"] += 1
        self._open_segment(self._active_index + 1)

    def rotate(self) -> None:
        """Force a seal+rotate (tests, SIGTERM close path)."""
        with self._lock:
            if self._f is not None:
                self._rotate_locked()

    def close(self) -> None:
        with self._lock:
            if self._f is None:
                return
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
                self._f.close()
            except OSError:
                pass
            self._f = None

    # -- cross-host replication (the SEGMENTS wire verb's two halves) ---------

    def replication_listing(self) -> Dict[str, Any]:
        """The PRIMARY side of segment replication: every sealed
        segment with its full CRC sidecar doc, plus the active
        segment's name and current flushed size. A standby diffs this
        against its own store and pulls what it lacks
        (:meth:`ingest_sealed` / :meth:`ingest_open_tail`). A segment
        mid-seal (sidecar not committed yet) is omitted — it shows up
        complete on the next cycle."""
        with self._lock:
            segs = self._scan()
            active = (os.path.basename(self._active_path)
                      if self._f is not None else None)
        out: Dict[str, Any] = {"segments": [], "open": None}
        for _, name in segs:
            path = os.path.join(self.root, name)
            if name.endswith(SEGMENT_SEALED):
                try:
                    with open(path + resilience.SEGMENT_META_SUFFIX) as f:
                        meta = json.load(f)
                except (OSError, ValueError):
                    continue
                out["segments"].append({"name": name, "meta": meta})
            elif name == active:
                try:
                    size = os.path.getsize(path)
                except OSError:
                    size = 0
                out["open"] = {"name": name, "size": size}
        return out

    def read_segment(self, name: str, offset: int = 0,
                     limit: Optional[int] = None) -> bytes:
        """Raw bytes of one retained segment (the SEGMENTS fetch form).
        Appends are flush-per-record, so any prefix of the ACTIVE
        segment a reader sees is a valid record stream plus at most
        one torn tail — which is exactly what the standby's mirror
        tolerates."""
        if _segment_index(name) is None:
            raise ValueError(f"not a segment name: {name!r}")
        with open(os.path.join(self.root, name), "rb") as f:
            f.seek(int(offset))
            return f.read() if limit is None else f.read(int(limit))

    def ingest_sealed(self, name: str, data: bytes,
                      meta: Dict[str, Any]) -> bool:
        """The STANDBY side: adopt one replicated sealed segment.
        The bytes are verified against the primary's sidecar (size +
        whole-file CRC32) BEFORE anything touches disk; a mismatch —
        corruption in flight — is counted (``repl_corrupt``) and
        returns False so the caller re-requests, never poisoning the
        local store. Data file and sidecar both commit tmp+rename, so
        a standby killed mid-adopt leaves either nothing or a fully
        valid sealed segment."""
        import zlib

        idx = _segment_index(name)
        if idx is None or not name.endswith(SEGMENT_SEALED):
            return False
        if (len(data) != meta.get("size") or
                zlib.crc32(data) & 0xFFFFFFFF != meta.get("crc32")):
            self.counters["repl_corrupt"] += 1
            _log().warning("replicated segment %s failed its sidecar "
                           "CRC/size check — re-requesting", name)
            return False
        path = os.path.join(self.root, name)
        # the partial .open mirror of the same index (the primary
        # rotated since we started tailing it) is superseded — dropped
        # BEFORE the sealed commit so a kill in between can only cost
        # a refetch, never leave a leftover .open for open()'s
        # leftover-seal to clobber the complete file with
        try:
            os.remove(os.path.join(self.root,
                                   _segment_name(idx, active=True)))
        except OSError:
            pass
        tmp = path + ".part"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            mtmp = path + resilience.SEGMENT_META_SUFFIX + ".part"
            with open(mtmp, "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(mtmp, path + resilience.SEGMENT_META_SUFFIX)
        except OSError as e:
            _log().warning("could not adopt replicated segment %s: %s",
                           name, e)
            return False
        self.counters["repl_segments"] += 1
        self.counters["repl_bytes"] += len(data)
        return True

    def ingest_open_tail(self, name: str, offset: int, data: bytes) -> int:
        """Mirror the primary's ACTIVE segment: append ``data`` iff
        ``offset`` equals the local copy's size (the mirror is always
        an exact byte prefix of the primary's file, so the only
        possible damage is one torn final record — which
        :meth:`open`'s leftover-seal trims at promotion). Returns the
        local size after the call; a caller whose offset was stale
        re-fetches from the returned size."""
        if _segment_index(name) is None or \
                not name.endswith(SEGMENT_ACTIVE):
            raise ValueError(f"not an active segment name: {name!r}")
        path = os.path.join(self.root, name)
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        if int(offset) != size:
            return size
        try:
            with open(path, "ab") as f:
                f.write(data)
                f.flush()
        except OSError as e:
            _log().warning("could not mirror open segment %s: %s", name, e)
            return size
        self.counters["repl_bytes"] += len(data)
        return size + len(data)

    def mirror_size(self, name: str) -> int:
        """Current local byte size of one segment file (0 when absent)
        — the standby's next open-tail fetch offset."""
        try:
            return os.path.getsize(os.path.join(self.root, name))
        except OSError:
            return 0

    def sealed_names(self) -> set:
        """Locally present sealed segment names (the standby's diff
        base against :meth:`replication_listing`)."""
        with self._lock:
            return {n for _, n in self._scan() if n.endswith(SEGMENT_SEALED)}

    # -- retention ------------------------------------------------------------

    def enforce_retention(self, now: Optional[float] = None) -> List[str]:
        """Delete sealed segments past the time bound, then oldest-first
        past the byte bound. Returns the deleted filenames."""
        now = time.time() if now is None else now
        deleted: List[str] = []
        with self._lock:
            segs = [(i, n) for i, n in self._scan()
                    if n.endswith(SEGMENT_SEALED)]
            sizes: Dict[str, int] = {}
            last_ts: Dict[str, Optional[float]] = {}
            for _, name in segs:
                p = os.path.join(self.root, name)
                try:
                    sizes[name] = os.path.getsize(p)
                except OSError:
                    sizes[name] = 0
                last_ts[name] = None
                try:
                    with open(p + resilience.SEGMENT_META_SUFFIX) as f:
                        last_ts[name] = json.load(f).get("last_t")
                except (OSError, ValueError):
                    pass
            total = sum(sizes.values()) + self._active_bytes
            for _, name in segs:
                too_old = (last_ts[name] is not None and
                           now - last_ts[name] > self.retention_s)
                over_bytes = total > self.retention_bytes
                if not too_old and not over_bytes:
                    if last_ts[name] is None:
                        # unreadable/missing sidecar: age unknowable —
                        # skip THIS segment, but a sweep-ending break
                        # here would wedge time-retention for every
                        # newer segment behind one rotted sidecar
                        continue
                    break  # oldest-first: the first keeper ends the sweep
                p = os.path.join(self.root, name)
                for victim in (p, p + resilience.SEGMENT_META_SUFFIX):
                    try:
                        os.remove(victim)
                    except OSError:
                        pass
                total -= sizes[name]
                deleted.append(name)
                self.counters["segments_deleted"] += 1
        return deleted

    def total_bytes(self) -> int:
        with self._lock:
            total = 0
            for _, name in self._scan():
                try:
                    total += os.path.getsize(os.path.join(self.root, name))
                except OSError:
                    pass
            return total

    # -- reads ----------------------------------------------------------------

    def _iter_payloads(self, paths: Optional[List[str]] = None,
                       count: bool = False) -> Iterator[Dict[str, Any]]:
        """Every intact record's decoded payload, oldest segment first.
        Corrupt records/undecodable payloads are skipped (counted only
        when ``count`` — the RECOVERY pass; a range query re-reading
        the same damaged segment must not re-inflate the counter)."""
        for path in (self.segment_paths() if paths is None else paths):
            try:
                for ok, payload in resilience.iter_records(path):
                    if not ok:
                        if count:
                            self.counters["corrupt_records"] += 1
                            _log().warning(
                                "skipping corrupt record in %s: %s",
                                os.path.basename(path), payload)
                        continue
                    try:
                        doc = json.loads(payload)
                    except ValueError:
                        if count:
                            self.counters["corrupt_records"] += 1
                        continue
                    if isinstance(doc, dict) and "k" in doc:
                        yield doc
            except OSError as e:
                if count:
                    self.counters["corrupt_records"] += 1
                _log().warning("skipping unreadable segment %s: %s",
                               path, e)

    def recover(self, apply: Callable[[str, Dict[str, Any]], None]) -> int:
        """Replay every retained record through ``apply(kind, payload)``
        oldest → newest; returns the number applied. ``apply`` raising
        is counted and skipped — one poisoned record must not erase the
        rest of history."""
        n = 0
        for doc in self._iter_payloads(count=True):
            try:
                apply(doc["k"], doc)
                n += 1
            except Exception as e:
                self.counters["corrupt_records"] += 1
                _log().warning("recovery apply failed for %r record: "
                               "%s: %s", doc.get("k"), type(e).__name__, e)
        return n

    def _segment_overlaps(self, path: str, start: float,
                          end: float) -> bool:
        """Sidecar first_t/last_t prune for sealed segments; the active
        (or sidecar-less) segment always scans."""
        try:
            with open(path + resilience.SEGMENT_META_SUFFIX) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return True
        first_t, last_t = meta.get("first_t"), meta.get("last_t")
        if not isinstance(first_t, (int, float)) or \
                not isinstance(last_t, (int, float)):
            return True
        return first_t <= end and last_t >= start

    def query(self, metric: str, labels: Optional[Dict[str, str]] = None,
              start: float = 0.0, end: Optional[float] = None,
              step: float = 0.0) -> Dict[str, Any]:
        """Range-read one metric's value series (counters/gauges;
        histogram families expose their windowed quantiles through the
        alert engine, not here) from the retained log: every ``snap``
        record in ``[start, end]`` whose sample labels superset-match
        ``labels``, downsampled to ``step``-second buckets
        (last-sample-per-bucket). Deterministic for a fixed log — the
        restart bit-identity contract rides on that."""
        from .registry import _series_key

        labels = dict(labels or {})
        end = time.time() if end is None else end
        series: Dict[str, Dict[str, Any]] = {}
        paths = [p for p in self.segment_paths()
                 if self._segment_overlaps(p, start, end)]
        for doc in self._iter_payloads(paths):
            if doc.get("k") != "snap":
                continue
            t = doc.get("t")
            if not isinstance(t, (int, float)) or not start <= t <= end:
                continue
            fam = (doc.get("f") or {}).get(metric)
            if not isinstance(fam, dict):
                continue
            origin = str(doc.get("o", ""))
            for s in fam.get("samples") or []:
                value = s.get("value")
                if not isinstance(value, (int, float)):
                    continue  # histogram samples have no scalar read here
                slabels = dict(s.get("labels") or {})
                slabels.setdefault("origin", origin)
                if not all(slabels.get(k) == v for k, v in labels.items()):
                    continue
                key = _series_key(metric, slabels)
                ent = series.setdefault(key, {"labels": slabels,
                                              "points": []})
                ent["points"].append((float(t), float(value)))
        out_series = []
        for key in sorted(series):
            ent = series[key]
            pts = downsample(ent["points"], start, step)
            out_series.append({"key": key, "labels": ent["labels"],
                               "points": [[round(t, 6), v]
                                          for t, v in pts]})
        return {"metric": metric, "matchers": labels,
                "from": start, "to": end, "step": step,
                "series": out_series}

    def list_series(self) -> List[Dict[str, Any]]:
        """Every distinct series in the retained log with its sample
        count and time span — ``tools/series_dump.py --list``."""
        seen: Dict[str, Dict[str, Any]] = {}
        from .registry import _series_key

        for doc in self._iter_payloads():
            if doc.get("k") != "snap":
                continue
            t = doc.get("t")
            origin = str(doc.get("o", ""))
            for name, fam in (doc.get("f") or {}).items():
                if not isinstance(fam, dict):
                    continue
                for s in fam.get("samples") or []:
                    slabels = dict(s.get("labels") or {})
                    slabels.setdefault("origin", origin)
                    key = _series_key(str(name), slabels)
                    ent = seen.setdefault(key, {
                        "key": key, "metric": str(name),
                        "type": str(fam.get("type", "untyped")),
                        "samples": 0, "first_t": None, "last_t": None})
                    ent["samples"] += 1
                    if isinstance(t, (int, float)):
                        if ent["first_t"] is None:
                            ent["first_t"] = t
                        ent["last_t"] = t
        return [seen[k] for k in sorted(seen)]

    def validate(self) -> List[str]:
        """CRC sweep of every retained segment: sealed segments against
        their sidecars (whole-file CRC), then every segment
        record-by-record. Returns findings (empty == clean); the
        ``tools/series_dump.py --validate`` body."""
        findings: List[str] = []
        with self._lock:
            segs = self._scan()
            active_idx = self._active_index if self._f is not None else None
        for idx, name in segs:
            path = os.path.join(self.root, name)
            sealed = name.endswith(SEGMENT_SEALED)
            if sealed:
                ok, reason = resilience.check_segment(path)
                if not ok:
                    findings.append(f"{name}: {reason}")
            bad = []
            try:
                records = list(resilience.iter_records(path))
            except OSError as e:
                findings.append(f"{name}: unreadable: {e}")
                continue
            for i, (ok, payload) in enumerate(records):
                if not ok:
                    # the ACTIVE segment's final torn line is the
                    # normal kill -9 artifact, not bitrot
                    if (not sealed and idx == active_idx
                            and i == len(records) - 1
                            and "torn tail" in str(payload)):
                        continue
                    bad.append((i, payload))
            for i, reason in bad:
                findings.append(f"{name}: record {i}: {reason}")
        return findings


def _json_default(o):
    from .journal import _json_default as jd
    return jd(o)


__all__ = ["SegmentStore", "downsample"]
