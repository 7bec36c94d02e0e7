"""Process-wide metrics registry: counters, gauges, log-bucket
histograms with labels, plus pull-time *collectors* (counterpart of
``paddle_tpu.telemetry.registry``: the same metric names, so the JAX
package's collector and alert rules read the port's series unchanged).

Every subsystem publishes into one registry under one naming
convention — ``paddle_tpu_<subsystem>_<name>{labels}`` — and two
exporters read it: Prometheus text exposition (:meth:`MetricsRegistry.
render_prometheus`, what the ``/metrics`` endpoint serves) and JSON
(:meth:`MetricsRegistry.render_json`, what bench rows and flight-dump
meta embed). :meth:`MetricsRegistry.validate` is the CI contract: a
metric violating the convention (bad name, missing help, counter
without ``_total``, duplicate series) is a named violation, not a
silently-odd scrape.

Two publication styles, chosen by cost:

- **Direct metrics** (:class:`Counter`/:class:`Gauge`/
  :class:`Histogram`) for event-shaped facts with no retained state
  (checkpoints written, preemptions). ``inc``/``set``/``observe`` take
  one small lock — fine on cold paths.
- **Collectors** (:meth:`MetricsRegistry.add_collector`) for
  subsystems that already keep thread-safe accumulators
  (``StepTimer``, ``PipelineMetrics``, ``ServingMetrics``, PS client
  counters): a callback renders their CURRENT state into metric
  families at scrape time. The hot path pays nothing — which is how
  the training-loop instrumentation stays inside the <2% dispatch
  budget with zero added device↔host syncs — and the exported series
  can never disagree with the subsystem's own ``report()`` because
  they are read from the same store. Collectors hold a weakref to
  their owner and drop out of the registry when it is collected, so
  short-lived trainers/servers (tests, notebooks) do not accumulate.
"""

from __future__ import annotations

import json
import math
import re
import threading
import weakref
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

# paddle_tpu_<subsystem>_<name>, lowercase snake throughout
METRIC_NAME_RE = re.compile(r"^paddle_tpu_[a-z][a-z0-9]*(_[a-z0-9]+)+$")
LABEL_NAME_RE = re.compile(r"^[a-z_][a-z0-9_]*$")

# default histogram bounds: log-spaced seconds, ~1.6 ratio, 1us..~2000s
DEFAULT_TIME_BUCKETS = tuple(1e-6 * (1.6 ** i) for i in range(45))


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricFamily:
    """One exported family: name, type, help, and its samples.

    ``samples`` is a list of ``(labels_dict, value)``; for histograms
    ``value`` is ``{"bounds": [...], "counts": [...], "sum": s,
    "count": n}`` with ``counts`` per-bucket (NOT cumulative; one
    extra overflow bucket past the last bound — exporters derive the
    cumulative ``_bucket`` series)."""

    __slots__ = ("name", "type", "help", "samples")

    def __init__(self, name: str, type_: str, help_: str,
                 samples: Optional[List[Tuple[Dict[str, str], Any]]] = None):
        self.name = name
        self.type = type_
        self.help = help_
        self.samples = samples if samples is not None else []

    def add(self, labels: Dict[str, str], value) -> "MetricFamily":
        self.samples.append((dict(labels), value))
        return self


def counter_family(name: str, help_: str,
                   samples: Iterable[Tuple[Dict[str, str], float]] = ()
                   ) -> MetricFamily:
    return MetricFamily(name, "counter", help_, list(samples))


def gauge_family(name: str, help_: str,
                 samples: Iterable[Tuple[Dict[str, str], float]] = ()
                 ) -> MetricFamily:
    return MetricFamily(name, "gauge", help_, list(samples))


def histogram_family(name: str, help_: str, labels: Dict[str, str],
                     bounds: Sequence[float], counts: Sequence[int],
                     sum_: float, count: int) -> MetricFamily:
    fam = MetricFamily(name, "histogram", help_)
    fam.add(labels, {"bounds": list(bounds), "counts": list(counts),
                     "sum": float(sum_), "count": int(count)})
    return fam


class _Metric:
    """Base for the direct (push-style) metric types."""

    type = "untyped"

    def __init__(self, name: str, help_: str,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[Tuple[str, str], ...], Any] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}")
        return _label_key(labels)

    def collect(self) -> MetricFamily:
        with self._lock:
            fam = MetricFamily(self.name, self.type, self.help)
            for key, value in sorted(self._children.items()):
                fam.add(dict(key), value)
            return fam


class Counter(_Metric):
    """Monotonic counter; name must end in ``_total``."""

    type = "counter"

    def inc(self, by: float = 1, **labels) -> None:
        if by < 0:
            raise ValueError(f"{self.name}: counters only go up (by={by})")
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0) + by

    def value(self, **labels) -> float:
        with self._lock:
            return self._children.get(self._key(labels), 0)


class Gauge(_Metric):
    type = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = float(value)

    def value(self, **labels) -> float:
        with self._lock:
            return self._children.get(self._key(labels), 0.0)


class Histogram(_Metric):
    """Fixed log-bucket histogram (one overflow bucket past the last
    bound)."""

    type = "histogram"

    def __init__(self, name: str, help_: str, labelnames: Sequence[str] = (),
                 bounds: Sequence[float] = DEFAULT_TIME_BUCKETS):
        super().__init__(name, help_, labelnames)
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError(f"{name}: bucket bounds must be sorted")

    def observe(self, value: float, **labels) -> None:
        import bisect
        key = self._key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = {"counts": [0] * (len(self.bounds) + 1),
                         "sum": 0.0, "count": 0}
                self._children[key] = child
            child["counts"][bisect.bisect_left(self.bounds, value)] += 1
            child["sum"] += value
            child["count"] += 1

    def collect(self) -> MetricFamily:
        with self._lock:
            fam = MetricFamily(self.name, self.type, self.help)
            for key, child in sorted(self._children.items()):
                fam.add(dict(key), {"bounds": list(self.bounds),
                                    "counts": list(child["counts"]),
                                    "sum": child["sum"],
                                    "count": child["count"]})
            return fam


class MetricsRegistry:
    """Thread-safe registry of direct metrics + scrape-time collectors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        # collector id -> (callback, owner weakref or None)
        self._collectors: Dict[int, Tuple[Callable[[], List[MetricFamily]],
                                          Optional[weakref.ref]]] = {}
        self._next_id = 0
        self._inst_counts: Dict[str, int] = {}
        self._last_merge_conflicts: List[str] = []

    # -- instance ids ------------------------------------------------------
    def next_instance(self, kind: str) -> str:
        """Process-monotonic instance id for ``kind`` (``trainer``,
        ``serving``...) — the ``inst`` label that keeps two live
        instances' series distinct."""
        with self._lock:
            n = self._inst_counts.get(kind, 0)
            self._inst_counts[kind] = n + 1
            return str(n)

    # -- direct metrics ----------------------------------------------------
    def _get_or_create(self, cls, name: str, help_: str,
                       labelnames: Sequence[str], **kw):
        _check_name(name, cls.type, help_, labelnames)
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name} re-registered as a different "
                        f"type/labelset ({m.type}{m.labelnames} vs "
                        f"{cls.type}{tuple(labelnames)})")
                return m
            m = cls(name, help_, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help_: str,
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help_, labelnames)

    def gauge(self, name: str, help_: str,
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help_, labelnames)

    def histogram(self, name: str, help_: str,
                  labelnames: Sequence[str] = (),
                  bounds: Sequence[float] = DEFAULT_TIME_BUCKETS
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help_, labelnames,
                                   bounds=bounds)

    # -- collectors --------------------------------------------------------
    def add_collector(self, fn: Callable[..., List[MetricFamily]],
                      owner: Optional[Any] = None) -> int:
        """Register a scrape-time callback returning metric families.
        ``owner`` (weakly referenced) scopes the collector's lifetime:
        when the owner is garbage-collected the collector drops out —
        AND the live owner is passed as the callback's one argument
        (``fn(owner)``), so publishers don't hand-roll their own
        weakref dance; with no owner the callback is called bare
        (``fn()``). Returns a handle for :meth:`remove_collector`
        (components with an explicit shutdown, e.g.
        ``PredictorServer.close``, remove theirs eagerly instead of
        exporting live-looking gauges until gc)."""
        with self._lock:
            cid = self._next_id
            self._next_id += 1
            ref = weakref.ref(owner) if owner is not None else None
            self._collectors[cid] = (fn, ref)
            return cid

    def remove_collector(self, cid: int) -> None:
        with self._lock:
            self._collectors.pop(cid, None)

    # -- scraping ----------------------------------------------------------
    def collect(self) -> List[MetricFamily]:
        """Snapshot every family, merging same-name families from
        multiple collectors (same type+help required — a conflicting
        re-declaration is recorded and surfaced by :meth:`validate`;
        the ``inst`` label keeps publishers' samples distinct)."""
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors.items())
        fams: List[MetricFamily] = [m.collect() for m in metrics]
        dead: List[int] = []
        errors: List[str] = []
        for cid, (fn, ref) in collectors:
            obj = None
            if ref is not None:
                obj = ref()
                if obj is None:
                    dead.append(cid)
                    continue
            # one broken collector must not poison the process-wide
            # scrape (telemetry never takes down the run it observes):
            # its failure becomes a validate() violation instead
            try:
                fams.extend(fn() if ref is None else fn(obj))
            except Exception as e:
                errors.append(
                    f"collector {getattr(fn, '__qualname__', fn)!r} "
                    f"raised {type(e).__name__}: {e}")
        if dead:
            with self._lock:
                for cid in dead:
                    self._collectors.pop(cid, None)
        merged: Dict[str, MetricFamily] = {}
        conflicts: List[str] = []
        for fam in fams:
            have = merged.get(fam.name)
            if have is None:
                merged[fam.name] = MetricFamily(fam.name, fam.type, fam.help,
                                                list(fam.samples))
            else:
                if have.type != fam.type or have.help != fam.help:
                    conflicts.append(
                        f"{fam.name}: declared as {have.type} "
                        f"({have.help!r}) by one publisher and {fam.type} "
                        f"({fam.help!r}) by another — the merged TYPE/HELP "
                        "lines are wrong for one of them")
                have.samples.extend(fam.samples)
        self._last_merge_conflicts = conflicts + errors
        return [merged[k] for k in sorted(merged)]

    def counter_values(self) -> Dict[str, float]:
        """Flat ``{name{label="v",...}: value}`` of every counter
        sample — the bench snapshot/delta surface."""
        out: Dict[str, float] = {}
        for fam in self.collect():
            if fam.type != "counter":
                continue
            for labels, value in fam.samples:
                out[_series_key(fam.name, labels)] = float(value)
        return out

    # -- validation (the CI naming-convention contract) --------------------
    def validate(self) -> List[str]:
        """Walk every exported family and return naming-convention
        violations (empty == clean): name pattern, non-empty help,
        counter ``_total`` suffix, label-name pattern, duplicate
        series, cross-publisher type/help conflicts, unit-suffix
        hygiene for histograms."""
        fams = self.collect()
        return (list(getattr(self, "_last_merge_conflicts", []))
                + validate_families(fams))

    # -- exporters ---------------------------------------------------------
    def render_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4) of every family."""
        return render_families_prometheus(self.collect())

    def render_json(self) -> str:
        """JSON export of the same snapshot (bench rows, flight dumps)."""
        return json.dumps(self.snapshot(), sort_keys=True)

    def snapshot(self) -> Dict[str, Any]:
        return families_snapshot(self.collect())


# -- family-list exporters (shared by the registry and merged views) ----------


def render_families_prometheus(fams: Iterable[MetricFamily]) -> str:
    """Prometheus text exposition (format 0.0.4) of a family list, the
    renderer behind ``MetricsRegistry.render_prometheus``."""
    lines: List[str] = []
    for fam in fams:
        lines.append(f"# HELP {fam.name} {_esc_help(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.type}")
        if fam.type == "histogram":
            for labels, h in fam.samples:
                cum = 0
                bounds = list(h["bounds"]) + [math.inf]
                for le, c in zip(bounds, h["counts"]):
                    cum += c
                    lab = dict(labels)
                    lab["le"] = _fmt_float(le)
                    lines.append(f"{fam.name}_bucket{_fmt_labels(lab)} "
                                 f"{cum}")
                lines.append(f"{fam.name}_sum{_fmt_labels(labels)} "
                             f"{_fmt_float(h['sum'])}")
                lines.append(f"{fam.name}_count{_fmt_labels(labels)} "
                             f"{h['count']}")
        else:
            for labels, value in fam.samples:
                lines.append(f"{fam.name}{_fmt_labels(labels)} "
                             f"{_fmt_float(value)}")
    return "\n".join(lines) + "\n"


def families_snapshot(fams: Iterable[MetricFamily]) -> Dict[str, Any]:
    """JSON-shaped snapshot of a family list (the ``render_json``
    payload)."""
    out: Dict[str, Any] = {}
    for fam in fams:
        out[fam.name] = {
            "type": fam.type,
            "help": fam.help,
            "samples": [{"labels": labels, "value": value}
                        for labels, value in fam.samples],
        }
    return out


def families_from_snapshot(snap: Dict[str, Any]) -> List[MetricFamily]:
    """Rebuild a :func:`families_snapshot` dict into metric families: the
    inverse used wherever a registry export crossed a process boundary as
    JSON (a replica process's ``METRICS`` verb) and must be merged,
    validated or rendered like a live collection."""
    fams: List[MetricFamily] = []
    for fname in sorted(snap or {}):
        d = snap[fname]
        fam = MetricFamily(fname, d["type"], d["help"])
        for s in d["samples"]:
            fam.add(dict(s["labels"]), s["value"])
        fams.append(fam)
    return fams


def validate_families(fams: Iterable[MetricFamily]) -> List[str]:
    """Naming-convention violations of a family list (empty == clean);
    the per-family half of ``MetricsRegistry.validate``."""
    out: List[str] = []
    seen_series: Dict[str, str] = {}
    for fam in fams:
        out.extend(_family_violations(fam))
        for labels, _ in fam.samples:
            for ln in labels:
                if not LABEL_NAME_RE.match(ln):
                    out.append(f"{fam.name}: bad label name {ln!r}")
            key = _series_key(fam.name, labels)
            if key in seen_series:
                out.append(f"duplicate series {key} (missing an "
                           "'inst' label on a per-instance collector?)")
            seen_series[key] = fam.name
    return out


def merge_exports(named: Dict[str, Iterable[MetricFamily]],
                  label: str = "replica") -> List[MetricFamily]:
    """Merge several publishers' family lists into one export, stamping
    every sample with ``{label: name}``: a fleet router merges each
    replica's ``telemetry_families()`` and serves the result from one
    ``/metrics`` endpoint. Same-name families merge into one (the first
    publisher's type and help win); a sample that already carries
    ``label`` keeps it (nested merges do not re-stamp)."""
    if not LABEL_NAME_RE.match(label):
        raise ValueError(f"merge label {label!r} violates the label "
                         "naming convention")
    merged: Dict[str, MetricFamily] = {}
    for name in sorted(named):
        for fam in named[name]:
            have = merged.get(fam.name)
            if have is None:
                have = merged[fam.name] = MetricFamily(fam.name, fam.type, fam.help)
            for labels, value in fam.samples:
                stamped = dict(labels)
                stamped.setdefault(label, name)
                have.add(stamped, value)
    return [merged[k] for k in sorted(merged)]


class FamiliesView:
    """Registry-shaped read-only view over a families callback: what
    :class:`~paddle_tpu_torch.telemetry.http.TelemetryServer` scrapes
    (``render_prometheus``/``render_json``) without a
    :class:`MetricsRegistry`; how a fleet router serves its replicas'
    merged series from one endpoint."""

    def __init__(self, collect_fn: Callable[[], List[MetricFamily]]):
        self._collect_fn = collect_fn

    def collect(self) -> List[MetricFamily]:
        return self._collect_fn()

    def render_prometheus(self) -> str:
        return render_families_prometheus(self.collect())

    def snapshot(self) -> Dict[str, Any]:
        return families_snapshot(self.collect())

    def render_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)

    def validate(self) -> List[str]:
        return validate_families(self.collect())


def _series_key(name: str, labels: Dict[str, str]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_esc_label(str(v))}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _esc_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _esc_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _fmt_float(v) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _check_name(name: str, type_: str, help_: str,
                labelnames: Sequence[str]) -> None:
    errs = _name_violations(name, type_, help_)
    for ln in labelnames:
        if not LABEL_NAME_RE.match(ln):
            errs.append(f"{name}: bad label name {ln!r}")
    if errs:
        raise ValueError("; ".join(errs))


def _name_violations(name: str, type_: str, help_: str) -> List[str]:
    out = []
    if not METRIC_NAME_RE.match(name):
        out.append(f"metric name {name!r} violates the "
                   "paddle_tpu_<subsystem>_<name> convention")
    if not (help_ or "").strip():
        out.append(f"{name}: missing help text")
    if type_ == "counter" and not name.endswith("_total"):
        out.append(f"counter {name} must end in _total")
    if type_ != "counter" and name.endswith("_total"):
        out.append(f"{type_} {name} must not end in _total")
    return out


def _family_violations(fam: MetricFamily) -> List[str]:
    out = _name_violations(fam.name, fam.type, fam.help)
    if fam.type not in ("counter", "gauge", "histogram"):
        out.append(f"{fam.name}: unknown metric type {fam.type!r}")
    if fam.type == "histogram":
        for _, h in fam.samples:
            if not isinstance(h, dict) or \
                    len(h.get("counts", [])) != len(h.get("bounds", [])) + 1:
                out.append(f"{fam.name}: histogram sample needs "
                           "len(counts) == len(bounds)+1")
    return out


# -- the process-wide default registry ----------------------------------------

_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """THE process-wide registry every subsystem publishes into (and
    the default the ``/metrics`` endpoint serves)."""
    return _default_registry


def counter_deltas(before: Dict[str, float], after: Dict[str, float],
                   per: float = 1.0) -> Dict[str, float]:
    """``(after - before) / per`` for every counter series that moved —
    the bench "telemetry snapshot" shape (``per`` = steps or requests
    measured, so rows are comparable across iteration counts)."""
    out: Dict[str, float] = {}
    for key, v in after.items():
        d = v - before.get(key, 0.0)
        if d:
            out[key] = round(d / (per or 1.0), 6)
    return out


__all__ = [
    "Counter", "FamiliesView", "Gauge", "Histogram", "MetricFamily",
    "MetricsRegistry", "METRIC_NAME_RE", "DEFAULT_TIME_BUCKETS",
    "counter_deltas", "counter_family", "families_from_snapshot",
    "families_snapshot", "gauge_family",
    "get_registry", "histogram_family", "merge_exports",
    "render_families_prometheus", "validate_families",
]
