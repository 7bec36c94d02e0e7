"""Closed-loop autoscaler: the telemetry plane driving the fleet size
(counterpart of ``paddle_tpu.fleet.autoscaler``, copied and adapted: the
same policy, readers, registry families and journal events, driving the
port's ``FleetRouter.grow()``/``retire()``).

Production traffic is bursty and everything else in the fleet is
fixed-size: replicas are spawned once and only replaced on death. This
module closes the loop over the fleet and the telemetry plane — a
control loop that watches the collector's fleet-wide read surface and
grows/shrinks the serving fleet within a configured band:

- **trends** ride ``GET /query`` range reads (per-origin queue depth,
  shed rate): a sustained-signal window must stay hot before a trend
  alone scales anything, and the trend math only ever consumes
  COMPLETE downsample buckets (:func:`complete_buckets` — a partial
  trailing bucket under-reports by construction and must never gate a
  scale decision);
- **alert transitions** from ``/alerts`` are immediate scale-up
  triggers (the paging rule already encodes "this is bad": no second
  sustain window on top), still subject to the band and the up
  cooldown;
- **scale-down** drains: :meth:`~paddle_tpu_torch.fleet.router.FleetRouter.
  retire` removes the replica from routing first, drains in-flight
  work with the at-most-once ``ReplicaDied``/``ServerClosed``
  classification intact, then stops the process via its owning agent.

The decision core (:class:`AutoscalePolicy`) is PURE: every input —
including the clock — arrives in one :class:`ScaleSignals` value, and
the output is one :class:`ScaleDecision`. Hysteresis (separate up/down
thresholds and sustain windows), per-direction cooldowns, anti-flap (a
replica retired in the last ``flap_guard_s`` blocks the next retire),
the quorum floor (never below ``quorum`` while any alert is firing),
and the **fail-static rule** — stale or absent telemetry pauses all
scaling AND resets the sustain windows, so a collector failover
mid-decision never causes a scale on a data gap — are all unit-pinned
without a single sleep.

The wrapper (:class:`Autoscaler`) runs the loop on a daemon thread:
reads come through a reader (:class:`HttpCollectorReader` speaks the
collector's HTTP endpoints with the same failover-list discipline as
the shipper; :class:`LocalCollectorReader` wraps an in-process
:class:`~paddle_tpu_torch.telemetry.collector.TelemetryCollector`), actions
go through ``FleetRouter.grow()`` / ``FleetRouter.retire()`` — which
spawn locally or through the per-host fleet agents, whichever the
router was built with.

The trainer-side analog (scheduled ``fit(elastic=True)`` grow/shrink
on a resize-request file/signal) is :class:`paddle_tpu_torch.resilience.
ResizeRequest`. ``chip_smoke.py`` phase 25 (b) replays bench.py's
diurnal ``autoscale`` row and requires a scale-up in the burst, a
scale-down after it and zero dropped accepted requests. See MIGRATION.md
"Autoscaler".
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import urllib.parse
import urllib.request
from typing import Any, Dict, List, Optional, Sequence, Tuple


def _log():
    import logging
    return logging.getLogger("paddle_tpu_torch.fleet.autoscaler")


# -- pure decision core -------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScaleSignals:
    """One control-loop tick's worth of input, clock included — the
    policy never reads ambient time. ``None`` signal values mean "this
    signal produced no verdict this tick" (series absent, too few
    points); a tick where EVERY trend signal is verdict-less should
    arrive with ``data_ok=False``."""

    now: float                     # the tick's clock (monotonic or wall)
    replicas: int                  # current fleet size (router ground truth)
    queue_per_replica: Optional[float] = None   # fleet queue depth / size
    shed_rate: Optional[float] = None           # front-door sheds per second
    p99_ms: Optional[float] = None              # served latency p99
    alert_firing: bool = False     # any scale-relevant alert firing NOW
    alert_transition: bool = False  # a not-firing -> firing edge this tick
    data_ok: bool = True           # telemetry fresh + readable


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    action: str      # "up" | "down" | "hold"
    target: int      # fleet size the action aims at (== replicas on hold)
    reason: str      # machine-stable slug (counter label, journal field)
    detail: str = ""


class AutoscalePolicy:
    """The pure policy: ``decide(signals)`` in, ``ScaleDecision`` out.

    Scale-up fires when EITHER a trend signal stays hot for
    ``up_window_s`` (sustained, not a blip) OR an alert transition
    arrives (immediate), subject to ``max_replicas`` and
    ``up_cooldown_s``. Scale-down needs every present signal cold for
    ``down_window_s``, then clears ``down_cooldown_s``, the anti-flap
    guard (no retire within ``flap_guard_s`` of the previous retire's
    COMPLETION — ``note_retired`` stamps it), and the quorum floor
    (while any alert fires the fleet never shrinks below ``quorum``,
    default ``min_replicas``). Stale/absent data (``data_ok=False``)
    holds AND resets both sustain windows: after a telemetry gap a hot
    signal must re-sustain from scratch — never scale on a gap."""

    def __init__(self, min_replicas: int = 1, max_replicas: int = 4,
                 quorum: Optional[int] = None,
                 up_queue_per_replica: float = 2.0,
                 down_queue_per_replica: float = 0.5,
                 up_shed_rate: float = 1.0,
                 down_shed_rate: float = 0.0,
                 up_p99_ms: Optional[float] = None,
                 down_p99_ms: Optional[float] = None,
                 up_window_s: float = 2.0, down_window_s: float = 5.0,
                 up_cooldown_s: float = 5.0, down_cooldown_s: float = 10.0,
                 flap_guard_s: float = 10.0, step: int = 1):
        if not 1 <= int(min_replicas) <= int(max_replicas):
            raise ValueError(
                f"bad autoscale band [{min_replicas}, {max_replicas}]: "
                "need 1 <= min <= max")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.quorum = self.min_replicas if quorum is None else int(quorum)
        self.up_queue_per_replica = float(up_queue_per_replica)
        self.down_queue_per_replica = float(down_queue_per_replica)
        self.up_shed_rate = float(up_shed_rate)
        self.down_shed_rate = float(down_shed_rate)
        self.up_p99_ms = up_p99_ms if up_p99_ms is None else float(up_p99_ms)
        self.down_p99_ms = (down_p99_ms if down_p99_ms is None
                            else float(down_p99_ms))
        self.up_window_s = float(up_window_s)
        self.down_window_s = float(down_window_s)
        self.up_cooldown_s = float(up_cooldown_s)
        self.down_cooldown_s = float(down_cooldown_s)
        self.flap_guard_s = float(flap_guard_s)
        self.step = max(1, int(step))
        # sustain-window state (None = condition not currently met)
        self._hot_since: Optional[float] = None
        self._cold_since: Optional[float] = None
        # -inf so the first decision is never cooldown-blocked
        self._last_up_at = float("-inf")
        self._last_down_at = float("-inf")
        self._last_retire_at = float("-inf")

    # -- event stamps --------------------------------------------------------

    def note_retired(self, now: float) -> None:
        """Stamp a retire's COMPLETION (drains take real time; the
        anti-flap clock runs from when the replica actually left, not
        from when the decision was made)."""
        self._last_retire_at = float(now)

    # -- signal classification -----------------------------------------------

    def _hot(self, s: ScaleSignals) -> Optional[str]:
        """The name of the first hot trend signal, else None."""
        if s.queue_per_replica is not None and \
                s.queue_per_replica >= self.up_queue_per_replica:
            return "queue"
        if s.shed_rate is not None and s.shed_rate >= self.up_shed_rate:
            return "shed"
        if self.up_p99_ms is not None and s.p99_ms is not None and \
                s.p99_ms >= self.up_p99_ms:
            return "p99"
        return None

    def _cold(self, s: ScaleSignals) -> bool:
        """Every PRESENT signal below its down threshold (hysteresis:
        the down thresholds sit below the up ones), with at least one
        signal present — silence is not coldness."""
        seen = False
        if s.queue_per_replica is not None:
            seen = True
            if s.queue_per_replica > self.down_queue_per_replica:
                return False
        if s.shed_rate is not None:
            seen = True
            if s.shed_rate > self.down_shed_rate:
                return False
        if self.down_p99_ms is not None and s.p99_ms is not None:
            seen = True
            if s.p99_ms > self.down_p99_ms:
                return False
        return seen

    # -- the decision --------------------------------------------------------

    def decide(self, s: ScaleSignals) -> ScaleDecision:
        now = float(s.now)
        if not s.data_ok:
            # fail-static: no decision on a gap, and the gap erases any
            # partial sustain — a burst interrupted by a collector
            # failover must re-prove itself once data is back
            self._hot_since = None
            self._cold_since = None
            return ScaleDecision("hold", s.replicas, "fail-static",
                                 "telemetry stale or absent")
        if s.replicas < self.min_replicas:
            # band repair is not telemetry-driven: the floor holds even
            # through cooldowns (but NOT through a data gap, above —
            # the fleet size came from the router, the go-ahead to act
            # is still a live control loop's)
            return ScaleDecision("up", self.min_replicas, "below-band",
                                 f"{s.replicas} < min {self.min_replicas}")
        hot = self._hot(s)
        cold = self._cold(s)
        if hot is not None:
            self._hot_since = now if self._hot_since is None \
                else self._hot_since
        else:
            self._hot_since = None
        if cold:
            self._cold_since = now if self._cold_since is None \
                else self._cold_since
        else:
            self._cold_since = None

        sustained = (self._hot_since is not None
                     and now - self._hot_since >= self.up_window_s)
        if s.alert_transition or sustained:
            reason = "alert-transition" if s.alert_transition \
                else "trend-sustained"
            detail = hot or ""
            if s.replicas >= self.max_replicas:
                return ScaleDecision("hold", s.replicas, "at-max", detail)
            if now - self._last_up_at < self.up_cooldown_s:
                return ScaleDecision("hold", s.replicas, "up-cooldown",
                                     reason)
            self._last_up_at = now
            self._hot_since = None   # a fresh burst must re-sustain
            target = min(s.replicas + self.step, self.max_replicas)
            return ScaleDecision("up", target, reason, detail)

        if self._cold_since is not None and \
                now - self._cold_since >= self.down_window_s:
            if s.replicas <= self.min_replicas:
                return ScaleDecision("hold", s.replicas, "at-min")
            if now - self._last_down_at < self.down_cooldown_s:
                return ScaleDecision("hold", s.replicas, "down-cooldown")
            if now - self._last_retire_at < self.flap_guard_s:
                return ScaleDecision("hold", s.replicas, "anti-flap",
                                     "a replica retired "
                                     f"{now - self._last_retire_at:.1f}s ago")
            target = max(s.replicas - self.step, self.min_replicas)
            if s.alert_firing and target < self.quorum:
                return ScaleDecision("hold", s.replicas, "quorum-floor",
                                     f"alert firing, quorum {self.quorum}")
            self._last_down_at = now
            return ScaleDecision("down", target, "trend-cold")

        return ScaleDecision("hold", s.replicas, "steady")


# -- complete-bucket guard ----------------------------------------------------


def complete_buckets(series_points: Sequence[Sequence[float]], step: float,
                     to: float) -> List[Tuple[float, float]]:
    """Drop the trailing PARTIAL downsample bucket from one series'
    ``/query`` points. Buckets carry last-sample-per-bucket values
    stamped at the bucket START (``telemetry.store.downsample``); a
    bucket whose span ``[t, t + step)`` extends past the query's
    ``to`` has only seen part of its window and systematically
    under-represents it — the autoscaler must never act on it.
    ``step <= 0`` (raw points) passes everything at/before ``to``."""
    if step <= 0:
        return [(float(t), float(v)) for t, v in series_points
                if t <= to]
    return [(float(t), float(v)) for t, v in series_points
            if t + step <= to]


# -- collector readers --------------------------------------------------------


class HttpCollectorReader:
    """The autoscaler's read client for a collector's HTTP endpoints
    (``/query``, ``/alerts``), with the same comma-separated failover
    discipline as the shipper's push side: reads stick to the first
    URL that answers and rotate on error — a killed primary fails the
    read over to the standby, whose stale pre-promotion store then
    reads as a data gap (fail-static) until promotion catches it
    up."""

    def __init__(self, urls, timeout: float = 3.0):
        if isinstance(urls, str):
            urls = [u.strip() for u in urls.split(",") if u.strip()]
        self.urls = [u.rstrip("/") for u in urls]
        if not self.urls:
            raise ValueError("HttpCollectorReader needs at least one URL")
        self.timeout = float(timeout)
        self._i = 0   # guarded-by: GIL (single int slot; loop-thread only)

    def _get(self, path: str) -> Any:
        last: Optional[BaseException] = None
        for k in range(len(self.urls)):
            idx = (self._i + k) % len(self.urls)
            try:
                with urllib.request.urlopen(self.urls[idx] + path,
                                            timeout=self.timeout) as r:
                    out = json.loads(r.read())
                self._i = idx
                return out
            except Exception as e:
                last = e
        raise ConnectionError(
            f"no collector answered {path!r} (tried {self.urls}): "
            f"{type(last).__name__}: {last}")

    def query(self, metric: str, labels: Optional[Dict[str, str]] = None,
              start: float = 0.0, end: Optional[float] = None,
              step: float = 0.0) -> Dict[str, Any]:
        params = {"metric": metric, "from": repr(float(start)),
                  "step": repr(float(step))}
        if end is not None:
            params["to"] = repr(float(end))
        if labels:
            params["labels"] = ",".join(f"{k}={v}"
                                        for k, v in sorted(labels.items()))
        return self._get("/query?" + urllib.parse.urlencode(params))

    def alerts(self) -> Dict[str, Any]:
        return self._get("/alerts")


class LocalCollectorReader:
    """The in-process twin: wrap a live
    :class:`~paddle_tpu_torch.telemetry.collector.TelemetryCollector` (bench
    rows, unit tests) behind the same reader surface."""

    def __init__(self, collector):
        self._col = collector

    def query(self, metric, labels=None, start=0.0, end=None, step=0.0):
        return self._col.query(metric, labels, start=start, end=end,
                               step=step)

    def alerts(self):
        return self._col.alerts_json()


# -- the control loop ---------------------------------------------------------


class Autoscaler:
    """Watch the collector, size the fleet.

    Each tick reads the queue-depth trend (``/query`` over
    ``trend_window_s`` at ``trend_step_s`` buckets, partial trailing
    bucket dropped), the shed-counter rate, and the alert snapshot;
    assembles one :class:`ScaleSignals`; asks the policy; then acts —
    ``router.grow()`` per missing replica on "up",
    ``router.retire(victim, drain=True)`` on "down" (the victim is the
    highest-numbered replica, so a 1→N→1 swing retires in LIFO order).
    A read error or a freshest-sample age beyond ``stale_after_s``
    arrives at the policy as ``data_ok=False`` — the fail-static rule
    does the rest.

    ``start()`` runs the loop on a daemon thread at ``interval``
    seconds; ``tick(now=...)`` runs ONE evaluation synchronously
    (tests, drills). ``alert_rules`` filters which rule names count as
    scale triggers (None = every firing rule)."""

    def __init__(self, router, reader, policy: AutoscalePolicy,
                 interval: float = 0.5,
                 queue_metric: str = "paddle_tpu_serving_queue_depth",
                 shed_metric: str = "paddle_tpu_fleet_shed_total",
                 labels: Optional[Dict[str, str]] = None,
                 trend_window_s: float = 5.0, trend_step_s: float = 0.5,
                 stale_after_s: float = 2.0,
                 alert_rules: Optional[Sequence[str]] = None,
                 retire_timeout: Optional[float] = 60.0):
        self.router = router
        self.reader = reader
        self.policy = policy
        self.interval = float(interval)
        self.queue_metric = queue_metric
        self.shed_metric = shed_metric
        self.labels = dict(labels or {})
        self.trend_window_s = float(trend_window_s)
        self.trend_step_s = float(trend_step_s)
        self.stale_after_s = float(stale_after_s)
        self.alert_rules = None if alert_rules is None else set(alert_rules)
        self.retire_timeout = retire_timeout
        self._last_firing: set = set()   # (rule, key) seen firing last tick
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # guarded-by: _lock
        self._counters: Dict[str, float] = {"ticks": 0, "scale_ups": 0,
                                            "scale_downs": 0}
        self._holds: Dict[str, int] = {}       # guarded-by: _lock
        self._last_hold_reason: Optional[str] = None
        from ..telemetry import get_registry
        self.telemetry_inst = get_registry().next_instance("autoscaler")
        self._telemetry_cid = get_registry().add_collector(
            Autoscaler._families, owner=self)

    @property
    def journal(self):
        from ..telemetry import get_journal
        return get_journal()

    # -- signal assembly -----------------------------------------------------

    def _trend_queue(self, now: float) -> Tuple[Optional[float],
                                                Optional[float]]:
        """(fleet queue depth per replica, freshest sample age). Sums
        the newest COMPLETE bucket of every matching series (a retired
        replica's series simply stops producing buckets and drops out
        of the sum)."""
        doc = self.reader.query(
            self.queue_metric, self.labels,
            start=now - self.trend_window_s, end=now,
            step=self.trend_step_s)
        freshest: Optional[float] = None
        total = 0.0
        saw = False
        for series in doc.get("series", ()):
            pts = complete_buckets(series.get("points", ()),
                                   float(doc.get("step", 0.0)),
                                   float(doc.get("to", now)))
            raw = series.get("points", ())
            if raw:
                age = now - float(raw[-1][0])
                freshest = age if freshest is None else min(freshest, age)
            if pts:
                total += pts[-1][1]
                saw = True
        if not saw:
            return None, freshest
        return total / max(1, len(self.router.replica_names)), freshest

    def _trend_shed(self, now: float) -> Optional[float]:
        """Front-door shed rate over the trend window (counter delta /
        time between the window's first and last samples)."""
        doc = self.reader.query(self.shed_metric, self.labels,
                                start=now - self.trend_window_s, end=now,
                                step=0.0)
        rate = None
        for series in doc.get("series", ()):
            pts = series.get("points", ())
            if len(pts) < 2:
                continue
            (t0, v0), (t1, v1) = pts[0], pts[-1]
            if t1 <= t0:
                continue
            dv = v1 - v0
            if dv < 0:
                dv = v1   # counter reset: count from zero
            rate = (rate or 0.0) + dv / (t1 - t0)
        return rate

    def _alert_state(self, commit: bool = True) -> Tuple[bool, bool]:
        """(any relevant alert firing, a new firing edge this tick).

        ``commit=False`` reads without advancing the edge-detection
        baseline.  Used on stale ticks: a collector failover briefly
        serves an empty (or replayed) ``/alerts`` view, and committing
        that view would make the *old* alerts look like a fresh firing
        edge the moment data recovers — a spurious scale-up.  Fail-static
        applies to the alert baseline exactly as it does to trends.
        """
        snap = self.reader.alerts()
        firing = {(a.get("rule"), a.get("key"))
                  for a in snap.get("firing", ())
                  if self.alert_rules is None
                  or a.get("rule") in self.alert_rules}
        transition = bool(firing - self._last_firing)
        if commit:
            self._last_firing = firing
        return bool(firing), transition

    def signals(self, now: Optional[float] = None) -> ScaleSignals:
        """Assemble one tick's :class:`ScaleSignals` from the reader
        (public: the drill asserts on it directly)."""
        now = time.time() if now is None else float(now)
        replicas = len(self.router.replica_names)
        try:
            qpr, age = self._trend_queue(now)
            shed = self._trend_shed(now)
            stale = age is None or age > self.stale_after_s
            alert_firing, alert_transition = self._alert_state(
                commit=not stale)
        except Exception as e:
            _log().debug("autoscaler read failed (fail-static): %s: %s",
                         type(e).__name__, e)
            return ScaleSignals(now=now, replicas=replicas, data_ok=False)
        return ScaleSignals(now=now, replicas=replicas,
                            queue_per_replica=None if stale else qpr,
                            shed_rate=None if stale else shed,
                            alert_firing=alert_firing,
                            alert_transition=alert_transition and not stale,
                            data_ok=not stale)

    # -- acting --------------------------------------------------------------

    def _pick_victim(self) -> str:
        """Highest-numbered replica name (LIFO: the burst capacity
        leaves first; ``r0`` — the seed replica — leaves last)."""
        names = self.router.replica_names

        def rank(n: str):
            digits = "".join(c for c in n if c.isdigit())
            return (int(digits) if digits else -1, n)

        return max(names, key=rank)

    def tick(self, now: Optional[float] = None) -> ScaleDecision:
        """One full evaluate-and-act cycle; returns the decision."""
        sig = self.signals(now)
        dec = self.policy.decide(sig)
        with self._lock:
            self._counters["ticks"] += 1
            if dec.action == "hold":
                self._holds[dec.reason] = self._holds.get(dec.reason, 0) + 1
        if dec.action == "hold":
            # journal only the EDGES: a steady hold every tick would
            # drown the fleet journal
            if dec.reason != self._last_hold_reason:
                self.journal.emit("autoscale.hold", reason=dec.reason,
                                  inst=self.telemetry_inst,
                                  replicas=sig.replicas, detail=dec.detail)
            self._last_hold_reason = dec.reason
            return dec
        self._last_hold_reason = None
        if dec.action == "up":
            for _ in range(dec.target - sig.replicas):
                name = self.router.grow()
                with self._lock:
                    self._counters["scale_ups"] += 1
                self.journal.emit("autoscale.up", replica=name,
                                  inst=self.telemetry_inst,
                                  reason=dec.reason, detail=dec.detail,
                                  replicas=len(self.router.replica_names))
        elif dec.action == "down":
            for _ in range(sig.replicas - dec.target):
                victim = self._pick_victim()
                self.router.retire(victim, drain=True,
                                   timeout=self.retire_timeout)
                self.policy.note_retired(time.time() if now is None
                                         else float(now))
                with self._lock:
                    self._counters["scale_downs"] += 1
                self.journal.emit("autoscale.down", replica=victim,
                                  inst=self.telemetry_inst,
                                  reason=dec.reason,
                                  replicas=len(self.router.replica_names))
        return dec

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Autoscaler":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="pdtpu-fleet-autoscaler")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception as e:   # the loop must outlive one bad tick
                _log().warning("autoscaler tick failed: %s: %s",
                               type(e).__name__, e)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(5.0, 2 * self.interval))
            self._thread = None
        from ..telemetry import get_registry
        get_registry().remove_collector(self._telemetry_cid)

    def __enter__(self) -> "Autoscaler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- observability -------------------------------------------------------

    def counters(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._counters)
            out["holds"] = dict(self._holds)
        return out

    def _families(self):
        from ..telemetry.registry import counter_family, gauge_family

        labels = {"inst": self.telemetry_inst}
        with self._lock:
            c = dict(self._counters)
            holds = dict(self._holds)
        return [
            counter_family("paddle_tpu_autoscaler_ticks_total",
                           "Autoscaler control-loop evaluations",
                           [(labels, c["ticks"])]),
            counter_family("paddle_tpu_autoscaler_scale_ups_total",
                           "Replicas grown by the autoscaler",
                           [(labels, c["scale_ups"])]),
            counter_family("paddle_tpu_autoscaler_scale_downs_total",
                           "Replicas retired by the autoscaler",
                           [(labels, c["scale_downs"])]),
            counter_family("paddle_tpu_autoscaler_holds_total",
                           "Hold decisions, by reason (fail-static = "
                           "paused on stale/absent telemetry)",
                           [({**labels, "reason": r}, v)
                            for r, v in sorted(holds.items())]),
            gauge_family("paddle_tpu_autoscaler_replicas",
                         "Current fleet size as the autoscaler sees it",
                         [(labels, len(self.router.replica_names))]),
        ]


__all__ = ["AutoscalePolicy", "Autoscaler", "HttpCollectorReader",
           "LocalCollectorReader", "ScaleDecision", "ScaleSignals",
           "complete_buckets"]
