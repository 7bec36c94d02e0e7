"""paddle_tpu_torch.telemetry — the process's own telemetry (counterpart
of the process half of ``paddle_tpu.telemetry``, copied and adapted: the
JAX package is not imported).

- :mod:`registry` — the process-wide **metrics registry** (counters,
  gauges, log-bucket histograms with labels; scrape-time collectors for
  zero hot-path cost) that the Trainer, the feeder, the guard, the
  checkpoints, the async-PS trainer and the serving queue publish into,
  under the JAX package's ``paddle_tpu_<subsystem>_<name>{labels}``
  names, with Prometheus-text and JSON exporters.
- :mod:`journal` — the **structured run journal**: a JSONL event stream
  with a run id and a monotonic sequence; span ids minted at
  submit/dispatch time correlate a feeder fill with its dispatch, a
  served request's submit with its completion, and an async-PS step's
  pulls and pushes.
- :mod:`recorder` — the **flight recorder**: the journal's bounded ring
  flushed to disk (atomic, CRC-manifested like checkpoints) on guard
  escalation, preemption, a resize, a ``ReshardError`` and an unhandled
  ``fit`` exception; ``tools/flight_dump.py`` renders a dump.
- :mod:`http` — the opt-in ``GET /metrics`` + ``GET /healthz`` endpoint
  behind ``Trainer.serve_metrics()`` and ``PredictorServer.serve_metrics()``.
- :mod:`shipper` — the **push pipeline** to a telemetry collector,
  started by ``PDTPU_TELEMETRY_ADDR`` or ``ship_to(addr)``; its wire is
  the JAX shipper's.
- :mod:`collector` — the **collector daemon** (``python -m
  paddle_tpu_torch.telemetry.collector``, or in-process): any process
  pushes its journal and registry snapshots to it over the framed wire;
  it keeps per-origin time series, a fleet-wide journal, and serves
  ``/metrics`` (merged under ``origin``), ``/alerts``,
  ``/timeline?trace=<span>`` and ``/query``; a standby replicates its
  segment log over ``SEGMENTS``.
- :mod:`store` — the **durable series store**: the segmented,
  CRC-framed, retention-bounded log the collector writes every ingest
  through and replays on a restart or a standby's promotion.
- :mod:`alerts` — the **declarative alert engine** the collector
  evaluates (threshold, rate, absence and quantile rules with ``for_s``
  and a firing→resolved state machine), with the preset pack.

``RunJournal.ingest``, ``families_from_snapshot``, ``merge_exports`` and
``FamiliesView`` are what the serving fleet (:mod:`paddle_tpu_torch.fleet`)
reads: a router ingests its replica processes' journals and serves their
merged series under a ``replica`` label.

Every wire, file and name is the JAX package's: a shipper, collector,
standby or store directory of one package works with the other's.
"""

from .journal import (RunJournal, get_journal, new_run_id, parse_sample,
                      set_journal)
from .recorder import (FlightRecorder, default_flight_dir, flight_dump,
                       get_recorder)
from .registry import (Counter, FamiliesView, Gauge, Histogram, MetricFamily,
                       MetricsRegistry, counter_deltas, counter_family,
                       families_from_snapshot, families_snapshot,
                       gauge_family, get_registry,
                       histogram_family, merge_exports,
                       render_families_prometheus, validate_families)
from .http import TelemetryServer, serve_metrics
from .alerts import (AlertEngine, AlertRule, PRESET_PACK, lint_rules,
                     load_rules, parse_rule, preset_rules)
from .collector import (CollectorProcess, SeriesStore, TelemetryCollector,
                        assemble_timeline, render_timeline_text)
from .store import SegmentStore, downsample
from .shipper import (Shipper, active_shipper, maybe_auto_ship, parse_addrs,
                      ship_to, stop_shipping)

__all__ = [
    "AlertEngine", "AlertRule", "CollectorProcess", "Counter",
    "FamiliesView", "FlightRecorder", "Gauge", "Histogram",
    "MetricFamily", "MetricsRegistry", "PRESET_PACK", "RunJournal",
    "SegmentStore", "SeriesStore", "Shipper", "TelemetryCollector",
    "TelemetryServer", "active_shipper", "assemble_timeline",
    "counter_deltas", "counter_family", "default_flight_dir",
    "downsample", "families_from_snapshot",
    "families_snapshot", "flight_dump", "gauge_family", "get_journal",
    "get_recorder", "get_registry", "histogram_family", "lint_rules",
    "load_rules", "maybe_auto_ship", "merge_exports", "new_run_id",
    "parse_addrs", "parse_rule", "parse_sample", "preset_rules",
    "render_families_prometheus", "render_timeline_text", "serve_metrics",
    "set_journal", "ship_to", "stop_shipping", "validate_families",
]
