"""Flight recorder: flush the journal's recent-event ring to disk when
the process hits a crash-shaped trigger (counterpart of
``paddle_tpu.telemetry.recorder``; a dump is in the JAX package's
format, which its ``tools/flight_dump.py`` reads).

The registry says *that* something is wrong; this module captures
*what the system was doing in the seconds before it died*. The journal already retains
a bounded ring of recent events; on a trigger —

- guard escalation (``FloatingPointError`` from the NaN/Inf guard),
- serving watchdog ``WorkerHung``,
- circuit-breaker trip,
- SIGTERM/SIGINT preemption,
- ``ReshardError`` on restore,
- an unhandled ``fit`` exception

— :meth:`FlightRecorder.dump` writes it to a directory using the SAME
commit discipline as checkpoints: files land in a ``*.tmp.<pid>``
sibling, get fsynced, a ``resilience.write_manifest`` CRC manifest is
written LAST, and the directory is renamed into place — a dump can be
trusted or discarded, never half-read. ``tools/flight_dump.py``
pretty-prints/filters one.

Dumps rotate (oldest removed past ``max_dumps``): a crash-looping
process must not fill the disk with its own black boxes. Dump root:
``PDTPU_FLIGHT_DIR`` env, else ``<tmp>/paddle_tpu_flight`` —
``fit(checkpoint_config=...)`` re-roots the process recorder next to
the checkpoints so operators find both in one place.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

from .journal import RunJournal, get_journal

EVENTS_NAME = "events.jsonl"
META_NAME = "flight.json"


def default_flight_dir() -> str:
    return os.environ.get(
        "PDTPU_FLIGHT_DIR",
        os.path.join(tempfile.gettempdir(), "paddle_tpu_flight"))


class FlightRecorder:
    """Dump-on-trigger writer over a :class:`RunJournal`'s ring."""

    def __init__(self, journal: Optional[RunJournal] = None,
                 root: Optional[str] = None, max_dumps: int = 8):
        self._journal = journal
        self.root = root
        self.max_dumps = int(max_dumps)
        self._lock = threading.Lock()
        # serializes concurrent dumpers (two breakers tripping at the
        # same journal seq must not share a tmp dir) — separate from
        # _lock so set_root never waits on disk I/O
        self._dump_lock = threading.Lock()
        self._tmp_seq = 0
        self.dumps: List[str] = []  # paths written by THIS recorder

    @property
    def journal(self) -> RunJournal:
        return self._journal if self._journal is not None else get_journal()

    def set_root(self, root: Optional[str]) -> None:
        with self._lock:
            self.root = root

    def dump(self, trigger: str, detail: Optional[Dict[str, Any]] = None,
             span: Optional[str] = None,
             root: Optional[str] = None) -> Optional[str]:
        """Flush the ring to ``<root>/flight_<runid>_<seq>_<trigger>``
        (atomic, CRC-manifested). Returns the committed path, or None
        on failure — the recorder reports a crash, it must never BE
        the crash, so filesystem errors are swallowed into a log line.
        ``span``/``detail`` land in ``flight.json`` so the dump names
        the offending request/step without grepping."""
        journal = self.journal
        try:
            return self._dump(journal, trigger, detail, span, root)
        except Exception as e:  # pragma: no cover - defensive
            _log().warning("flight-recorder dump for %r failed: %s: %s",
                           trigger, type(e).__name__, e)
            return None

    def _dump(self, journal, trigger, detail, span, root) -> str:
        from .. import resilience
        from .registry import get_registry

        # serialize the whole write+rename: two threads dumping the
        # same trigger at the same seq would otherwise interleave
        # files in one tmp dir and commit a mixed-content black box
        with self._dump_lock:
            return self._dump_locked(journal, trigger, detail, span, root,
                                     resilience, get_registry())

    def _dump_locked(self, journal, trigger, detail, span, root,
                     resilience, registry) -> str:
        with self._lock:
            base = root or self.root or default_flight_dir()
            self._tmp_seq += 1
            tmp_seq = self._tmp_seq
        os.makedirs(base, exist_ok=True)
        events = journal.recent()
        tag = _safe_tag(trigger)
        final = os.path.join(
            base, f"flight_{journal.run_id}_{journal.seq:08d}_{tag}")
        tmp = f"{final}{resilience.TMP_MARKER}{os.getpid()}.{tmp_seq}"
        os.makedirs(tmp, exist_ok=True)
        meta = {
            "run": journal.run_id,
            "trigger": trigger,
            "wall_time": time.time(),
            "span": span,
            "detail": detail or {},
            "num_events": len(events),
            "first_seq": events[0]["seq"] if events else None,
            "last_seq": events[-1]["seq"] if events else None,
            # the registry snapshot rides along: the dump answers "what
            # were the counters at the moment of death" by itself
            "metrics": _metrics_snapshot(registry),
        }
        with open(os.path.join(tmp, EVENTS_NAME), "w",
                  encoding="utf-8") as f:
            for e in events:
                f.write(json.dumps(e, sort_keys=True, default=repr) + "\n")
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, META_NAME), "w", encoding="utf-8") as f:
            json.dump(meta, f, sort_keys=True, default=repr)
            f.flush()
            os.fsync(f.fileno())
        resilience.write_manifest(
            tmp, meta={"global_step": 0, "flight_trigger": trigger,
                       "run": journal.run_id})
        if os.path.isdir(final):  # same-seq retrigger: replace
            shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        with self._lock:
            self.dumps.append(final)
        self._rotate(base)
        _log().error("flight recorder: dumped %d event(s) to %s "
                     "(trigger=%s)", len(events), final, trigger)
        return final

    def _rotate(self, base: str) -> None:
        try:
            dumps = sorted(
                d for d in os.listdir(base)
                if d.startswith("flight_") and ".tmp." not in d
                and os.path.isdir(os.path.join(base, d)))
        except OSError:
            return
        for stale in dumps[:-self.max_dumps] if self.max_dumps > 0 else []:
            shutil.rmtree(os.path.join(base, stale), ignore_errors=True)


def _metrics_snapshot(registry) -> Dict[str, Any]:
    try:
        return registry.snapshot()
    except Exception:  # a broken collector must not lose the dump
        return {}


def _safe_tag(trigger: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "-"
                   for c in trigger)[:48] or "trigger"


def _log():
    import logging
    return logging.getLogger("paddle_tpu_torch.telemetry")


# -- the process-wide default recorder ----------------------------------------

_default_recorder = FlightRecorder()


def get_recorder() -> FlightRecorder:
    """THE process flight recorder (rides the process journal)."""
    return _default_recorder


def flight_dump(trigger: str, detail: Optional[Dict[str, Any]] = None,
                span: Optional[str] = None,
                root: Optional[str] = None) -> Optional[str]:
    """Module-level convenience: dump via the process recorder."""
    return _default_recorder.dump(trigger, detail=detail, span=span,
                                  root=root)


__all__ = ["EVENTS_NAME", "META_NAME", "FlightRecorder",
           "default_flight_dir", "flight_dump", "get_recorder"]
