"""Step-time breakdown: per-dispatch wall time + the unified profile report
(counterpart of ``paddle_tpu.profiling.steptime``).

The Trainer records every ``step``/``run_steps`` dispatch into a
:class:`StepTimer`: two ``perf_counter`` reads around the call, a ring
append and, with a journal, one ``trainer.dispatch`` event. Nothing here
touches the card: the reads bracket the host's submission of the
dispatch (a captured ``run_steps`` is one graph replay a step, queued
asynchronously), with no synchronize and no device read, so the
recorded time is what the training-loop thread spent in the call — a
lower bound on device time, and all of it for a host-bound step.
``Trainer.profile_report()`` (:func:`profile_report`) merges the dispatch
timeline with ``pipeline_report()`` into one compute / h2d / host-encode
/ starvation breakdown, emitted on ``fit``'s ``end_epoch``, ``preempted``,
``resized`` and interval ``profile`` events; :func:`export_chrome_trace`
writes the retained spans through ``core.profiler.timeline``.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional, Tuple

# ring-buffer cap on retained spans: a week-long fit must not grow an
# unbounded list just because the timer is always on
_MAX_SPANS = 8192


class StepTimer:
    """Per-dispatch wall-time accumulator. WRITES happen on the
    training-loop thread only (no locking needed; the DeviceFeeder
    stages have their own thread-safe PipelineMetrics); the telemetry
    scrape READS cross-thread without the loop thread's cooperation —
    plain int/float reads are monitoring-grade (exact at the next
    quiescent point), and container state is snapshotted under the GIL
    before iteration so a concurrent insert can never tear a scrape.

    ``journal`` (a :class:`paddle_tpu_torch.telemetry.RunJournal`) makes the
    timer the journal's dispatch feed: every recorded dispatch emits a
    ``trainer.dispatch`` event carrying the chunk's span id (minted by
    the DeviceFeeder fill thread, or fresh here) — the training-side
    half of the submit→execution correlation story. One ring append +
    one journal emit per DISPATCH (not per step) keeps the cost inside
    the <2% K=16 budget the tests pin."""

    def __init__(self, journal=None, inst: Optional[str] = None):
        self.journal = journal
        self.inst = inst
        self.reset()

    def reset(self) -> None:
        self.dispatches = 0
        self.steps = 0
        self.dispatch_s = 0.0
        self.by_kind: Dict[str, int] = {}
        self.first_t0: Optional[float] = None
        self.last_t1: Optional[float] = None
        self._spans: deque = deque(maxlen=_MAX_SPANS)

    def record_dispatch(self, t0: float, t1: float, num_steps: int = 1,
                        kind: str = "step", span: Optional[str] = None,
                        base_step: Optional[int] = None) -> None:
        """Record one step()/run_steps() call: ``t0``/``t1`` are
        ``time.perf_counter()`` readings around the dispatch. ``span``
        is the chunk's trace id (one is minted when journaling without
        it); ``base_step`` is the global step the dispatch started at."""
        self.dispatches += 1
        self.steps += num_steps
        self.dispatch_s += t1 - t0
        self.by_kind[kind] = self.by_kind.get(kind, 0) + 1
        if self.first_t0 is None:
            self.first_t0 = t0
        self.last_t1 = t1
        self._spans.append((kind, num_steps, t0, t1))
        if self.journal is not None:
            self.journal.emit(
                "trainer.dispatch",
                span=span if span is not None else self.journal.new_span(),
                dispatch=kind, num_steps=num_steps, base_step=base_step,
                dur_s=round(t1 - t0, 6))

    def telemetry_families(self, inst: Optional[str] = None) -> list:
        """Render the accumulators as registry metric families (the
        trainer's scrape-time collector calls this — zero hot-path
        publication cost)."""
        from ..telemetry.registry import counter_family

        labels = {"inst": inst if inst is not None else (self.inst or "0")}
        # dict(d) is a GIL-atomic snapshot: the scrape thread must not
        # iterate by_kind while the loop thread inserts a new kind
        by_kind = dict(self.by_kind)
        return [
            counter_family(
                "paddle_tpu_trainer_steps_total",
                "Optimizer steps completed by this trainer",
                [(labels, self.steps)]),
            counter_family(
                "paddle_tpu_trainer_dispatches_total",
                "Device dispatches (step / fused run_steps launches)",
                [({**labels, "kind": k}, v)
                 for k, v in sorted(by_kind.items())]),
            counter_family(
                "paddle_tpu_trainer_dispatch_seconds_total",
                "Training-loop thread seconds spent inside dispatch calls",
                [(labels, round(self.dispatch_s, 6))]),
        ]

    def spans_us(self) -> List[Tuple[str, float, float, int]]:
        """Retained dispatch spans as ``(name, start_us, dur_us, tid)``
        tuples — the shape ``core.profiler.timeline`` consumes."""
        return [(f"trainer.{kind}[{n}]", t0 * 1e6, (t1 - t0) * 1e6, 1)
                for kind, n, t0, t1 in self._spans]

    def report(self) -> Dict[str, Any]:
        span = ((self.last_t1 - self.first_t0)
                if self.first_t0 is not None else 0.0)
        return {
            "steps": self.steps,
            "dispatches": self.dispatches,
            "dispatch_s": round(self.dispatch_s, 6),
            "span_s": round(span, 6),
            "avg_step_ms": (round(self.dispatch_s / self.steps * 1e3, 4)
                            if self.steps else None),
            "avg_dispatch_ms": (round(self.dispatch_s / self.dispatches * 1e3,
                                      4) if self.dispatches else None),
            "spans_retained": len(self._spans),
        }


def profile_report(trainer, fusion: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
    """The unified step profile: dispatch timing + input-pipeline stage
    attribution + (optionally) a cached kernel table, with a named
    bottleneck. The JAX package's schema:

    - ``steps`` / ``dispatches`` / ``avg_step_ms`` / ``span_s`` — from
      the per-dispatch :class:`StepTimer`;
    - ``breakdown`` — seconds per attribution bucket: ``compute_s``
      (training-loop thread inside dispatch calls), ``h2d_s`` (the
      EXPOSED transfer time — what the pipeline actually stalled for;
      the staging ring's hidden portion rides separately as
      ``overlap_hidden_s`` and must not crown h2d the bottleneck),
      ``host_encode_s`` (wire encode), ``reader_s`` (host reader
      wait), ``starved_s`` (loop thread waiting for input). With
      prefetch the feeder buckets overlap compute — ``starved_s`` is
      the non-overlapped input-bound signal;
    - ``bottleneck`` — the largest bucket, with ``input_bound`` carried
      from the pipeline report;
    - ``pipeline`` — the full ``pipeline_report()``;
    - ``fusion`` — the step's kernel table when one has been computed
      (``Trainer.fusion_report``), else None;
    - ``collective`` — static bytes-on-wire attribution of the per-step
      gradient exchange (``Trainer.collective_bytes``), or None off-mesh.
    """
    st = trainer.step_timer.report()
    pipe = trainer.pipeline_report()
    stages = pipe.get("stages_s", {})
    hidden = pipe.get("overlap_hidden_s", 0.0)
    breakdown = {
        "compute_s": st["dispatch_s"],
        "h2d_s": max(0.0, stages.get("h2d", 0.0) - hidden),
        "host_encode_s": stages.get("encode", 0.0),
        "reader_s": stages.get("reader", 0.0),
        "starved_s": pipe.get("consumer_starved_s", 0.0),
    }
    bottleneck = (max(breakdown, key=breakdown.get)
                  if any(v > 0 for v in breakdown.values()) else None)
    return {
        **st,
        "breakdown": {k: round(v, 6) for k, v in breakdown.items()},
        "overlap_hidden_s": round(hidden, 6),
        "bottleneck": bottleneck,
        "input_bound": pipe.get("input_bound", False),
        "pipeline": pipe,
        "fusion": fusion,
        "collective": getattr(trainer, "collective_bytes", None),
    }


def export_chrome_trace(trainer, path: str) -> int:
    """Dump the trainer's retained dispatch spans (plus any host spans
    the ``core.profiler`` collected while enabled) as chrome://tracing
    JSON. Returns the number of events written."""
    from ..core import profiler

    return profiler.timeline(path, extra_spans=trainer.step_timer.spans_us())


__all__ = ["StepTimer", "export_chrome_trace", "profile_report"]
