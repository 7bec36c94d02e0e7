"""Declarative alert engine over collector time series (counterpart of
``paddle_tpu.telemetry.alerts``, copied and adapted: the same grammar,
lint messages, state machine and preset pack over the same metric names).

An alert rule is one line of a small expression grammar evaluated
against the :class:`~paddle_tpu_torch.telemetry.collector.SeriesStore` a
collector maintains (per-origin bounded rings of every pushed metric
sample). Four forms cover the failure shapes the metric name table
actually produces::

    paddle_tpu_serving_breaker_open > 0 for 10s            # threshold
    rate(paddle_tpu_serving_rejected_total[30s]) > 1 for 30s   # rate
    p99(paddle_tpu_serving_latency_seconds[60s]) > 0.5 for 60s # quantile
    absent(paddle_tpu_serving_submitted_total[15s]) for 15s    # absence
    absent(origin[10s]) for 10s                 # origin push staleness

- **threshold** — the latest sample of every matching series compared
  against the bound (gauges, mostly: breaker open, queue depth).
- **rate** — per-second increase of a counter over the bracketed
  window (rejects/s, pushes-lost/s; the rate of a ``*_seconds_total``
  counter is a FRACTION of wall time, which is how the feeder
  starvation preset reads).
- **quantile** — ``p50``/``p90``/``p95``/``p99`` of a histogram's
  bucket counts DELTA over the window (the ``_bucket`` series done
  server-side; an idle window yields no verdict rather than a stale
  all-time quantile).
- **absence** — a tracked series (or, with the special target
  ``origin``, any origin's push stream) with no sample newer than the
  window. The replica-down pager: a SIGKILLed process stops pushing,
  its origin goes stale, the alert fires.

Every rule carries ``for N s``: the condition must hold continuously
that long before the alert transitions to **firing** (one flap does
not page), and a firing alert whose condition clears transitions to
**resolved** (kept listed for a while — ``/alerts`` shows both).
Matching is per SERIES (labels subset-match; the merged store's
``origin`` label included), so one rule yields one alert instance per
origin/replica/inst that trips it.

Rules are data (name + expr + severity), loadable from a JSON file,
and statically lintable against the known metric name table —
``tools/alert_check.py`` validates a rule file offline (unknown
metric, unknown label, malformed expr, form/metric-type mismatch ⇒
named findings, exit 0/1/3 like ``lint_gate.py``), and the CI ships
:data:`PRESET_PACK` through it.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

# -- the known metric name table ----------------------------------------------
# Every family any subsystem exports (the MIGRATION.md "Telemetry"
# table, kept in code so the alert linter has a machine-readable
# ground truth): name -> (type, label names the publisher stamps).
# ``origin`` (collector merge), ``replica`` (fleet merge), and ``inst``
# are legal on ANY series — see UNIVERSAL_LABELS.

# ``stale`` is stamped by the collector's merged export on origins
# past half their expiry (it never reaches the SeriesStore rings, but
# a rule matcher naming it must not lint as unknown)
UNIVERSAL_LABELS = frozenset({"origin", "replica", "inst", "stale"})

METRIC_TABLE: Dict[str, Tuple[str, frozenset]] = {
    # trainer / fit / resilience
    "paddle_tpu_trainer_steps_total": ("counter", frozenset()),
    "paddle_tpu_trainer_dispatches_total": ("counter", frozenset({"kind"})),
    "paddle_tpu_trainer_dispatch_seconds_total": ("counter", frozenset()),
    "paddle_tpu_trainer_global_step": ("gauge", frozenset()),
    "paddle_tpu_trainer_guard_incidents_total": ("counter", frozenset()),
    "paddle_tpu_trainer_checkpoints_total": ("counter", frozenset({"kind"})),
    "paddle_tpu_trainer_preemptions_total": ("counter", frozenset()),
    "paddle_tpu_trainer_resizes_total": ("counter", frozenset()),
    "paddle_tpu_resilience_reshards_total": ("counter", frozenset()),
    # input pipeline
    "paddle_tpu_feeder_stage_seconds_total": ("counter", frozenset({"stage"})),
    "paddle_tpu_feeder_batches_total": ("counter", frozenset()),
    "paddle_tpu_feeder_chunks_total": ("counter", frozenset()),
    "paddle_tpu_feeder_h2d_bytes_total": ("counter", frozenset()),
    "paddle_tpu_feeder_encode_saved_bytes_total": ("counter", frozenset()),
    "paddle_tpu_feeder_consumer_starved_seconds_total":
        ("counter", frozenset()),
    # serving
    "paddle_tpu_serving_submitted_total": ("counter", frozenset()),
    "paddle_tpu_serving_completed_total": ("counter", frozenset()),
    "paddle_tpu_serving_rejected_total": ("counter", frozenset({"reason"})),
    "paddle_tpu_serving_timeouts_total": ("counter", frozenset()),
    "paddle_tpu_serving_errors_total": ("counter", frozenset()),
    "paddle_tpu_serving_hangs_total": ("counter", frozenset()),
    "paddle_tpu_serving_workers_replaced_total": ("counter", frozenset()),
    "paddle_tpu_serving_reloads_total": ("counter", frozenset({"outcome"})),
    "paddle_tpu_serving_coalesced_batches_total": ("counter", frozenset()),
    "paddle_tpu_serving_coalesced_requests_total": ("counter", frozenset()),
    "paddle_tpu_serving_latency_seconds": ("histogram", frozenset()),
    "paddle_tpu_serving_queue_depth": ("gauge", frozenset()),
    "paddle_tpu_serving_queue_capacity": ("gauge", frozenset()),
    "paddle_tpu_serving_workers": ("gauge", frozenset()),
    "paddle_tpu_serving_workers_busy": ("gauge", frozenset()),
    "paddle_tpu_serving_breaker_open": ("gauge", frozenset()),
    "paddle_tpu_serving_breaker_half_open": ("gauge", frozenset()),
    "paddle_tpu_serving_breaker_trips_total": ("counter", frozenset()),
    "paddle_tpu_serving_generation": ("gauge", frozenset()),
    # async-PS
    "paddle_tpu_ps_trainer_step": ("gauge", frozenset()),
    "paddle_tpu_ps_pushes_total": ("counter", frozenset()),
    "paddle_tpu_ps_pulls_total": ("counter", frozenset()),
    "paddle_tpu_ps_reconnects_total": ("counter", frozenset()),
    "paddle_tpu_ps_retries_total": ("counter", frozenset()),
    "paddle_tpu_ps_pushes_lost_total": ("counter", frozenset()),
    # fleet router
    "paddle_tpu_fleet_submitted_total": ("counter", frozenset()),
    "paddle_tpu_fleet_routed_total": ("counter", frozenset({"replica"})),
    "paddle_tpu_fleet_rerouted_total": ("counter", frozenset()),
    "paddle_tpu_fleet_shed_total": ("counter", frozenset()),
    "paddle_tpu_fleet_replicas_replaced_total": ("counter", frozenset()),
    "paddle_tpu_fleet_replicas_grown_total": ("counter", frozenset()),
    "paddle_tpu_fleet_replicas_retired_total": ("counter", frozenset()),
    "paddle_tpu_fleet_reloads_total": ("counter", frozenset({"outcome"})),
    "paddle_tpu_fleet_reload_rollbacks_total": ("counter", frozenset()),
    "paddle_tpu_fleet_replicas_live": ("gauge", frozenset()),
    "paddle_tpu_fleet_replicas_ready": ("gauge", frozenset()),
    # autoscaler (the closed loop over this plane)
    "paddle_tpu_autoscaler_ticks_total": ("counter", frozenset()),
    "paddle_tpu_autoscaler_scale_ups_total": ("counter", frozenset()),
    "paddle_tpu_autoscaler_scale_downs_total": ("counter", frozenset()),
    "paddle_tpu_autoscaler_holds_total": ("counter", frozenset({"reason"})),
    "paddle_tpu_autoscaler_replicas": ("gauge", frozenset()),
    # telemetry shipping (the shipper's and the collector's own publishers)
    "paddle_tpu_shipper_shipped_total": ("counter", frozenset()),
    "paddle_tpu_shipper_dropped_total": ("counter", frozenset()),
    "paddle_tpu_shipper_snapshots_total": ("counter", frozenset()),
    "paddle_tpu_shipper_flushes_total": ("counter", frozenset({"outcome"})),
    "paddle_tpu_shipper_flush_seconds_total": ("counter", frozenset()),
    "paddle_tpu_collector_events_total": ("counter", frozenset()),
    "paddle_tpu_collector_snapshots_total": ("counter", frozenset()),
    "paddle_tpu_collector_origins": ("gauge", frozenset()),
    "paddle_tpu_collector_alerts_firing": ("gauge", frozenset()),
    "paddle_tpu_collector_alert_transitions_total":
        ("counter", frozenset({"state"})),
    # the durable series store (collector-side persistence)
    "paddle_tpu_collector_segments_corrupt_total": ("counter", frozenset()),
    "paddle_tpu_collector_store_appends_total": ("counter", frozenset()),
    "paddle_tpu_collector_store_bytes_total": ("counter", frozenset()),
    "paddle_tpu_collector_store_append_seconds_total":
        ("counter", frozenset()),
    "paddle_tpu_collector_store_append_failures_total":
        ("counter", frozenset()),
    "paddle_tpu_collector_store_segments": ("gauge", frozenset()),
    "paddle_tpu_telemetry_scrape_aborted_total": ("counter", frozenset()),
}

# the special absence target: any tracked origin's push stream
ORIGIN_TARGET = "origin"

_CMP_FNS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
}

_SERIES_RE = re.compile(
    r"^(?P<name>[a-z_][a-z0-9_]*)(\{(?P<labels>[^}]*)\})?$")
_DUR_RE = re.compile(r"^(\d+(?:\.\d+)?)(ms|s|m|h)$")
_QUANT_FNS = {"p50": 0.50, "p90": 0.90, "p95": 0.95, "p99": 0.99}
_DUR_UNITS = {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0}


class AlertRuleError(ValueError):
    """A rule failed to parse (the linter reports this as a
    ``alert:malformed-expr`` finding instead of raising)."""


def parse_duration(text: str) -> float:
    m = _DUR_RE.match(text.strip())
    if not m:
        raise AlertRuleError(f"bad duration {text!r} (want e.g. 30s, 5m)")
    return float(m.group(1)) * _DUR_UNITS[m.group(2)]


def _parse_labels(text: Optional[str]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for part in (text or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise AlertRuleError(f"bad label matcher {part!r} (want k=v)")
        k, _, v = part.partition("=")
        out[k.strip()] = v.strip().strip('"')
    return out


def _parse_series(text: str) -> Tuple[str, Dict[str, str]]:
    m = _SERIES_RE.match(text.strip())
    if not m:
        raise AlertRuleError(
            f"bad series {text!r} (want metric_name{{label=value,...}})")
    return m.group("name"), _parse_labels(m.group("labels"))


def _split_windowed(text: str) -> Tuple[str, Optional[float]]:
    """``series[30s]`` → (``series``, 30.0); plain series → (.., None)."""
    if text.endswith("]") and "[" in text:
        series, _, win = text[:-1].rpartition("[")
        return series, parse_duration(win)
    return text, None


@dataclass
class AlertRule:
    """One parsed rule. ``form`` is threshold|rate|quantile|absence;
    ``metric`` is None only for the ``absent(origin[..])`` form."""

    name: str
    expr: str
    form: str
    metric: Optional[str]
    labels: Dict[str, str] = field(default_factory=dict)
    op: str = ">"
    threshold: float = 0.0
    window_s: Optional[float] = None
    q: Optional[float] = None
    for_s: float = 0.0
    severity: str = "warn"
    annotations: Dict[str, Any] = field(default_factory=dict)

    def describe(self) -> Dict[str, Any]:
        return {"name": self.name, "expr": self.expr, "form": self.form,
                "metric": self.metric, "for_s": self.for_s,
                "severity": self.severity}


def parse_rule(name: str, expr: str, severity: str = "warn",
               annotations: Optional[Dict[str, Any]] = None) -> AlertRule:
    """Parse one rule expression (grammar in the module docstring)."""
    text = " ".join(expr.split())
    for_s = 0.0
    if " for " in text:
        text, _, dur = text.rpartition(" for ")
        for_s = parse_duration(dur)
    kw: Dict[str, Any] = dict(name=name, expr=expr, severity=severity,
                              annotations=dict(annotations or {}),
                              for_s=for_s)

    if text.startswith("absent(") and text.endswith(")"):
        inner, window = _split_windowed(text[len("absent("):-1].strip())
        if window is None:
            raise AlertRuleError(
                f"{name}: absent() needs a staleness window, e.g. "
                "absent(metric[15s])")
        if inner == ORIGIN_TARGET:
            return AlertRule(form="absence", metric=None,
                             window_s=window, **kw)
        metric, labels = _parse_series(inner)
        return AlertRule(form="absence", metric=metric, labels=labels,
                         window_s=window, **kw)

    # the comparison tail: <atom> <op> <number>
    m = re.match(r"^(?P<atom>.+?)\s*(?P<op>>=|<=|==|!=|>|<)\s*"
                 r"(?P<num>-?\d+(?:\.\d+)?(?:e-?\d+)?)$", text)
    if not m:
        raise AlertRuleError(
            f"{name}: expected '<expr> <op> <number> [for <dur>]', "
            f"got {expr!r}")
    atom, op, num = m.group("atom").strip(), m.group("op"), float(m.group("num"))
    kw.update(op=op, threshold=num)

    fn_m = re.match(r"^(?P<fn>rate|p50|p90|p95|p99)\((?P<arg>.+)\)$", atom)
    if fn_m:
        fn, arg = fn_m.group("fn"), fn_m.group("arg").strip()
        inner, window = _split_windowed(arg)
        if window is None:
            raise AlertRuleError(
                f"{name}: {fn}() needs a window, e.g. {fn}(metric[30s])")
        metric, labels = _parse_series(inner)
        if fn == "rate":
            return AlertRule(form="rate", metric=metric, labels=labels,
                             window_s=window, **kw)
        return AlertRule(form="quantile", metric=metric, labels=labels,
                         window_s=window, q=_QUANT_FNS[fn], **kw)

    metric, labels = _parse_series(atom)
    return AlertRule(form="threshold", metric=metric, labels=labels, **kw)


def parse_rules(specs: List[Dict[str, Any]]) -> List[AlertRule]:
    """Parse the JSON-able rule-pack shape: a list of ``{"name": ...,
    "expr": ..., "severity"?: ..., "annotations"?: {...}}``."""
    out = []
    for spec in specs:
        out.append(parse_rule(spec["name"], spec["expr"],
                              severity=spec.get("severity", "warn"),
                              annotations=spec.get("annotations")))
    return out


def load_rules(path: str) -> List[AlertRule]:
    """Load + parse a JSON rule file (the ``--rules`` input of the
    collector daemon and ``tools/alert_check.py``)."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if isinstance(doc, dict):
        doc = doc.get("rules", [])
    return parse_rules(doc)


# -- static lint (tools/alert_check.py) ---------------------------------------


def lint_rules(specs: List[Dict[str, Any]],
               table: Optional[Dict[str, Tuple[str, frozenset]]] = None
               ) -> List[str]:
    """Validate a rule pack (the raw JSON-able list) against the known
    metric name table. Returns named findings (empty == clean):

    - ``alert:malformed-expr`` — the expression does not parse;
    - ``alert:unknown-metric`` — the metric is not in the table;
    - ``alert:unknown-label`` — a label matcher the publisher never
      stamps (and is not a universal origin/replica/inst label);
    - ``alert:type-mismatch`` — ``rate()`` of a non-counter,
      ``p99()`` of a non-histogram, or a bare threshold on a
      histogram;
    - ``alert:bad-duration`` — ``for_s`` shorter than the window makes
      a rate/quantile rule flappy (info-grade, still listed);
    - ``alert:duplicate-name`` — two rules sharing a name would share
      one alert state.
    """
    table = METRIC_TABLE if table is None else table
    findings: List[str] = []
    seen: Dict[str, int] = {}
    for i, spec in enumerate(specs):
        if not isinstance(spec, dict):
            # user-malformed input is a FINDING (exit 1), never a
            # linter crash (exit 3)
            findings.append(
                f"alert:malformed-expr rule[{i}]: expected an object "
                f"{{name, expr, ...}}, got {type(spec).__name__}")
            continue
        rname = str(spec.get("name") or f"rule[{i}]")
        if not spec.get("name"):
            findings.append(f"alert:malformed-expr {rname}: missing 'name'")
        if rname in seen:
            findings.append(
                f"alert:duplicate-name {rname}: also rule #{seen[rname]} — "
                "two rules sharing a name share one alert state")
        seen[rname] = i
        expr = spec.get("expr")
        if not expr:
            findings.append(f"alert:malformed-expr {rname}: missing 'expr'")
            continue
        try:
            rule = parse_rule(rname, expr,
                              severity=spec.get("severity", "warn"))
        except AlertRuleError as e:
            findings.append(f"alert:malformed-expr {rname}: {e}")
            continue
        if spec.get("severity") not in (None, "info", "warn", "page"):
            findings.append(
                f"alert:malformed-expr {rname}: severity "
                f"{spec['severity']!r} not in info|warn|page")
        if rule.metric is None:  # absent(origin[..]) — nothing to check
            continue
        entry = table.get(rule.metric)
        if entry is None:
            findings.append(
                f"alert:unknown-metric {rname}: {rule.metric!r} is not in "
                "the metric name table (typo, or a family this build does "
                "not export)")
            continue
        mtype, mlabels = entry
        for ln in rule.labels:
            if ln not in mlabels and ln not in UNIVERSAL_LABELS:
                findings.append(
                    f"alert:unknown-label {rname}: {rule.metric} has no "
                    f"label {ln!r} (publisher stamps "
                    f"{sorted(mlabels) or 'none'}; "
                    f"{sorted(UNIVERSAL_LABELS)} are always legal)")
        if rule.form == "rate" and mtype != "counter":
            findings.append(
                f"alert:type-mismatch {rname}: rate() of {rule.metric} "
                f"({mtype}) — rate is only meaningful on counters")
        if rule.form == "quantile" and mtype != "histogram":
            findings.append(
                f"alert:type-mismatch {rname}: p{int((rule.q or 0) * 100)}()"
                f" of {rule.metric} ({mtype}) — quantiles need a histogram")
        if rule.form == "threshold" and mtype == "histogram":
            findings.append(
                f"alert:type-mismatch {rname}: bare threshold on histogram "
                f"{rule.metric} — compare a quantile (p99(...)) instead")
        if rule.form in ("rate", "quantile") and rule.window_s and \
                0 < rule.for_s < rule.window_s / 2:
            findings.append(
                f"alert:bad-duration {rname}: for {rule.for_s:g}s is much "
                f"shorter than the {rule.window_s:g}s window — the rule "
                "will flap on one noisy sample")
    return findings


# -- the preset pack ----------------------------------------------------------
# Derived from the MIGRATION.md metric name table: the conditions two
# bench rounds and five drills said should page, as data. Ships
# through tools/alert_check.py in CI (tier-1).

PRESET_PACK: List[Dict[str, Any]] = [
    {"name": "feeder_starvation", "severity": "warn",
     "expr": "rate(paddle_tpu_feeder_consumer_starved_seconds_total[30s])"
             " > 0.5 for 30s",
     "annotations": {"summary": "training loop starved of input >50% of "
                                "wall time (the BENCH_r05 degraded-link "
                                "signature)"}},
    {"name": "serving_shed_rate", "severity": "warn",
     "expr": "rate(paddle_tpu_serving_rejected_total[30s]) > 1 for 30s",
     "annotations": {"summary": "serving front door shedding >1 req/s"}},
    {"name": "fleet_shed_rate", "severity": "warn",
     "expr": "rate(paddle_tpu_fleet_shed_total[30s]) > 1 for 30s",
     "annotations": {"summary": "fleet router shedding >1 req/s (every "
                                "replica rejecting)"}},
    {"name": "serving_p99_latency", "severity": "warn",
     "expr": "p99(paddle_tpu_serving_latency_seconds[60s]) > 0.5 for 60s",
     "annotations": {"summary": "served p99 latency above 500ms"}},
    {"name": "serving_breaker_open", "severity": "page",
     "expr": "paddle_tpu_serving_breaker_open > 0 for 10s",
     "annotations": {"summary": "a replica's circuit breaker is open"}},
    {"name": "ps_pushes_lost", "severity": "warn",
     "expr": "rate(paddle_tpu_ps_pushes_lost_total[60s]) > 0.1 for 60s",
     "annotations": {"summary": "async-PS dropping gradient pushes "
                                "(at-most-once replies lost)"}},
    {"name": "guard_incidents", "severity": "warn",
     "expr": "rate(paddle_tpu_trainer_guard_incidents_total[60s]) > 0.1 "
             "for 60s",
     "annotations": {"summary": "NaN/Inf guard discarding steps"}},
    {"name": "journal_drops", "severity": "warn",
     "expr": "rate(paddle_tpu_shipper_dropped_total[60s]) > 1 for 60s",
     "annotations": {"summary": "telemetry shipper dropping journal "
                                "events (collector unreachable or "
                                "buffer-bound too low)"}},
    {"name": "origin_down", "severity": "page",
     "expr": "absent(origin[10s]) for 10s",
     "annotations": {"summary": "a process that was shipping telemetry "
                                "went silent (replica/trainer down?)"}},
]


def preset_rules(for_s: Optional[float] = None,
                 window_s: Optional[float] = None) -> List[AlertRule]:
    """The parsed preset pack. ``for_s``/``window_s`` override every
    rule's durations — the drill/test knob that keeps the SAME preset
    conditions but on a seconds-not-minutes clock."""
    rules = parse_rules(PRESET_PACK)
    for r in rules:
        if for_s is not None:
            r.for_s = float(for_s)
        if window_s is not None and r.window_s is not None:
            r.window_s = float(window_s)
    return rules


# -- the engine ---------------------------------------------------------------


def _json_value(v):
    """Alert values cross JSON surfaces (``/alerts`` bodies, journaled
    transitions, flight-dump detail): a non-finite float (an overflow-
    bucket quantile is legitimately +inf) must not serialize as the
    invalid-JSON ``Infinity`` token — it becomes the string ``"inf"``
    instead. Comparisons happen BEFORE this, on the real float."""
    import math

    if isinstance(v, float) and not math.isfinite(v):
        return repr(v)
    return v


class AlertEngine:
    """Firing→resolved state machine over a rule list.

    :meth:`evaluate` reads the store once per tick and advances every
    rule's per-series state: condition true → *pending* (since t);
    held ``for_s`` → **firing** (one transition); condition false
    while firing → **resolved** (one transition). A series/origin that
    vanishes from the store (origin expiry after a ``replace()``)
    clears its condition — which is how a replica-down absence alert
    resolves once the dead origin is retired. Transitions are returned
    AND handed to ``on_transition(dict)`` (the collector journals them
    and can trigger a flight dump); state reads are
    :meth:`snapshot`."""

    def __init__(self, rules: List[AlertRule],
                 on_transition: Optional[Callable[[Dict[str, Any]],
                                                  None]] = None,
                 resolved_keep_s: float = 600.0):
        import threading

        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise AlertRuleError(f"duplicate rule names in {sorted(names)}")
        # swapped as a whole list under _lock (load_rules); readers
        # iterate whichever complete snapshot reference they grabbed —
        # per-instance alert STATE is what _lock actually guards
        self.rules = list(rules)   # lint: allow(thread:unguarded-access)
        self.on_transition = on_transition
        self.resolved_keep_s = float(resolved_keep_s)
        # guards _active/_resolved/transitions_total: the eval thread
        # mutates them while /alerts scrapes and drill polls snapshot()
        # from other threads
        self._lock = threading.Lock()
        # (rule name, series key) -> {"state": pending|firing, "since",
        # "value"}; resolved instances move to _resolved
        self._active: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._resolved: List[Dict[str, Any]] = []
        self.transitions_total: Dict[str, int] = {"firing": 0, "resolved": 0}

    # -- condition evaluation ------------------------------------------------

    def _conditions(self, rule: AlertRule, store,
                    now: float) -> Dict[str, float]:
        """``{series key: measured value}`` for every series where the
        rule's condition holds RIGHT NOW."""
        cmp_fn = _CMP_FNS[rule.op]
        out: Dict[str, float] = {}
        if rule.form == "absence":
            if rule.metric is None:
                pairs = store.origin_staleness(now)
            else:
                pairs = store.staleness(rule.metric, rule.labels, now)
            for key, age in pairs:
                if age > (rule.window_s or 0.0):
                    out[key] = age
            return out
        if rule.form == "threshold":
            pairs = store.latest_values(rule.metric, rule.labels, now)
        elif rule.form == "rate":
            pairs = store.rates(rule.metric, rule.labels, rule.window_s, now)
        else:  # quantile
            pairs = store.quantiles(rule.metric, rule.labels, rule.q,
                                    rule.window_s, now)
        for key, value in pairs:
            if value is not None and cmp_fn(value, rule.threshold):
                out[key] = value
        return out

    # -- the tick ------------------------------------------------------------

    def evaluate(self, store, now: Optional[float] = None
                 ) -> List[Dict[str, Any]]:
        import time as _time

        now = _time.time() if now is None else now
        transitions: List[Dict[str, Any]] = []
        # condition evaluation reads the store (its own lock) OUTSIDE
        # the engine lock; state mutation happens under it; callbacks
        # (journal emits, flight dumps — potentially slow) run AFTER
        # release so a dump never blocks an /alerts scrape
        conditions = [(rule, self._conditions(rule, store, now))
                      for rule in self.rules]
        with self._lock:
            for rule, true_now in conditions:
                # advance/enter
                for key, value in true_now.items():
                    st = self._active.get((rule.name, key))
                    if st is None:
                        st = {"state": "pending", "since": now,
                              "value": value}
                        self._active[(rule.name, key)] = st
                    st["value"] = value
                    if st["state"] == "pending" and \
                            now - st["since"] >= rule.for_s:
                        st["state"] = "firing"
                        st["fired_at"] = now
                        transitions.append(self._transition(rule, key, st,
                                                            "firing", now))
                # clear
                for (rname, key) in [k for k in self._active
                                     if k[0] == rule.name]:
                    if key in true_now:
                        continue
                    st = self._active.pop((rname, key))
                    if st["state"] == "firing":
                        st["resolved_at"] = now
                        st["rule"] = rule.name
                        st["key"] = key
                        st["severity"] = rule.severity
                        st["expr"] = rule.expr
                        self._resolved.append(st)
                        transitions.append(self._transition(rule, key, st,
                                                            "resolved",
                                                            now))
                    # a pending instance that cleared never fired: dropped
            self._resolved = [
                r for r in self._resolved
                if now - r["resolved_at"] <= self.resolved_keep_s]
            for t in transitions:
                self.transitions_total[t["state"]] += 1
        for t in transitions:
            if self.on_transition is not None:
                try:
                    self.on_transition(t)
                except Exception:  # alerting must not kill the eval loop
                    pass
        return transitions

    def _transition(self, rule: AlertRule, key: str, st: Dict[str, Any],
                    state: str, now: float) -> Dict[str, Any]:
        return {"rule": rule.name, "key": key, "state": state, "t": now,
                "value": _json_value(st.get("value")),
                "severity": rule.severity,
                "expr": rule.expr, "for_s": rule.for_s,
                "since": st.get("since"),
                "annotations": dict(rule.annotations)}

    # -- durable state (the collector's on-disk store) -----------------------

    def state(self) -> Dict[str, Any]:
        """JSON-able dump of the firing/pending/resolved state — what
        the collector's segment log persists so a restart (or a standby
        promotion) resumes every ``for_s`` clock and firing instance
        instead of re-arming from scratch."""
        with self._lock:
            return {
                "active": [[rname, key, dict(st, value=_json_value(
                    st.get("value")))]
                           for (rname, key), st in sorted(
                               self._active.items())],
                "resolved": [dict(r, value=_json_value(r.get("value")))
                             for r in self._resolved],
                "transitions_total": dict(self.transitions_total),
            }

    def restore(self, state: Dict[str, Any]) -> None:
        """Silently adopt a :meth:`state` dump: firing instances come
        back FIRING (their original ``since``/``fired_at`` clocks
        intact, NO ``firing`` transition emitted — the pager already
        went off before the restart), pending ones keep their held
        time, the resolved list and transition counters carry over.
        Instances of rules this engine no longer has are dropped."""
        known = {r.name for r in self.rules}
        with self._lock:
            self._active = {
                (rname, key): dict(st)
                for rname, key, st in (state.get("active") or [])
                if rname in known}
            self._resolved = [dict(r) for r in state.get("resolved") or []
                              if r.get("rule") in known]
            for k, v in (state.get("transitions_total") or {}).items():
                self.transitions_total[k] = int(v)

    def set_rules(self, rules: List[AlertRule]) -> List[Dict[str, Any]]:
        """Hot-swap the rule list (SIGHUP / ``POST /rules``). State is
        keyed by rule NAME, so a rule that persists across the reload
        keeps its firing/pending instances (an edited threshold takes
        effect at the next evaluation); instances of rules that
        vanished are closed — firing ones emit a ``resolved``
        transition (returned AND handed to ``on_transition``), pending
        ones are dropped silently."""
        import time as _time

        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise AlertRuleError(f"duplicate rule names in {sorted(names)}")
        now = _time.time()
        transitions: List[Dict[str, Any]] = []
        with self._lock:
            old_by_name = {r.name: r for r in self.rules}
            keep = set(names)
            for (rname, key) in [k for k in self._active
                                 if k[0] not in keep]:
                st = self._active.pop((rname, key))
                if st["state"] == "firing":
                    rule = old_by_name[rname]
                    st["resolved_at"] = now
                    st.update(rule=rname, key=key, severity=rule.severity,
                              expr=rule.expr)
                    self._resolved.append(st)
                    transitions.append(self._transition(rule, key, st,
                                                        "resolved", now))
            for t in transitions:
                self.transitions_total[t["state"]] += 1
            self.rules = list(rules)
        for t in transitions:
            if self.on_transition is not None:
                try:
                    self.on_transition(t)
                except Exception:
                    pass
        return transitions

    # -- reads ---------------------------------------------------------------

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The ``/alerts`` payload: firing + pending instances and the
        recently-resolved list."""
        import time as _time

        now = _time.time() if now is None else now
        firing, pending = [], []
        with self._lock:
            # rules are copied under the SAME lock as the instance
            # table: set_rules()/restore() mutate both at runtime now,
            # and a scrape racing a hot-reload/promotion must see one
            # consistent pair (plus .get below: recovery assigns
            # .rules outside the engine lock by design)
            by_name = {r.name: r for r in self.rules}
            active = {k: dict(v) for k, v in self._active.items()}
            resolved_src = [dict(r) for r in self._resolved]
            trans = dict(self.transitions_total)
        for (rname, key), st in sorted(active.items()):
            rule = by_name.get(rname)
            if rule is None:
                continue  # instance of a rule mid-swap: next tick's view
            entry = {"rule": rname, "key": key, "state": st["state"],
                     "since": st["since"], "held_s": round(now - st["since"],
                                                           3),
                     "value": _json_value(st.get("value")),
                     "severity": rule.severity,
                     "expr": rule.expr, "for_s": rule.for_s,
                     "annotations": dict(rule.annotations)}
            (firing if st["state"] == "firing" else pending).append(entry)
        resolved = [{"rule": r["rule"], "key": r["key"],
                     "resolved_at": r["resolved_at"],
                     "fired_at": r.get("fired_at"),
                     "value": _json_value(r.get("value")),
                     "severity": r["severity"],
                     "expr": r["expr"]}
                    for r in resolved_src]
        return {"firing": firing, "pending": pending, "resolved": resolved,
                "rules": [r.describe() for r in self.rules],
                "transitions_total": trans}

    def firing(self) -> List[Dict[str, Any]]:
        return self.snapshot()["firing"]


__all__ = [
    "METRIC_TABLE", "ORIGIN_TARGET", "PRESET_PACK", "UNIVERSAL_LABELS",
    "AlertEngine", "AlertRule", "AlertRuleError", "lint_rules", "load_rules",
    "parse_duration", "parse_rule", "parse_rules", "preset_rules",
]
