"""Continuous-batching primitives: the pure planning half of the serving
scheduler (a copy of ``paddle_tpu.fleet.batching``, numpy only).

Continuous batching coalesces queued requests into ONE dispatch of the
largest bucket that fits within a latency budget (:class:`BatchPolicy`),
amortising the fixed per-dispatch cost (host→device copies, the launch
of every kernel, the output sync) across real rows instead of zeros.
Only the exported bucket set is ever dispatched.

This module is lock-free planning — bucket selection, feed merging,
per-request row spans, output re-slicing — driven by the worker loop in
:mod:`paddle_tpu_torch.serving`, which owns the queue and the deadlines.
Correctness contract: a coalesced request's sliced output equals the
same request run through ``Predictor.run`` inside the bucket the
scheduler dispatched (the scheduler only changes which pad rows
surround the request's rows, and every row of the program is
independent).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """Continuous-batching tuning for ``PredictorServer``.

    ``max_wait_ms``: how long the scheduler may hold a dequeued request
    past its submit time to gather more coalescable work. Already-queued
    requests are taken for free (no added wait); the budget only bounds
    *idle waiting* for requests that have not arrived yet, so a lone
    request is dispatched at most ``max_wait_ms`` after submit and a
    burst is dispatched immediately. The wait never extends past the
    tightest deadline in the forming batch.

    ``max_requests``: optional cap on requests per coalesced dispatch
    (None = bounded only by the largest bucket).

    ``slo_queue_threshold``: opt-in SLO-aware batch sizing (None =
    always fill). Below the threshold queue depth the scheduler stops
    filling at the smallest bucket that covers the work already here
    and spends no idle wait; at or above it the always-fill plan
    applies. The decision is :meth:`plan`."""

    max_wait_ms: float = 2.0
    max_requests: Optional[int] = None
    slo_queue_threshold: Optional[int] = None

    def plan(self, queue_depth: int, first_rows: int,
             buckets: Sequence[int]) -> Tuple[int, float]:
        """The coalescing plan for a dispatch forming NOW: ``(target_rows,
        idle_wait_ms)``. ``queue_depth`` is the requests still queued
        behind the seed request, ``first_rows`` the seed's rows."""
        if self.slo_queue_threshold is None or \
                queue_depth >= self.slo_queue_threshold:
            return int(buckets[-1]), self.max_wait_ms
        want = min(int(first_rows) + int(queue_depth), int(buckets[-1]))
        return pick_bucket(want, buckets), 0.0


def pick_bucket(total_rows: int, buckets: Sequence[int]) -> int:
    """Smallest bucket holding ``total_rows`` (buckets ascending; the
    caller guarantees a fit)."""
    for b in buckets:
        if b >= total_rows:
            return int(b)
    raise ValueError(f"{total_rows} rows exceed the largest bucket "
                     f"(buckets: {list(buckets)})")


def nonbatched_key(feed: Dict[str, Any], feed_names: Sequence[str],
                   batched_feeds) -> Tuple[bytes, ...]:
    """Byte-exact identity of a request's NON-batched feeds. Two requests
    may only share a dispatch when these agree: a non-batched feed has
    one value per dispatch."""
    return tuple(np.asarray(feed[k]).tobytes()
                 for k in feed_names if k not in batched_feeds)


def merge_feeds(requests, feed_names: Sequence[str], batched_feeds,
                bucket: int) -> Dict[str, np.ndarray]:
    """One padded bucket-sized feed from a compatible request group:
    batched feeds are row-concatenated in group order and zero-padded up
    to ``bucket``; non-batched feeds take the first request's value."""
    out: Dict[str, np.ndarray] = {}
    total = sum(r.n for r in requests)
    for k in feed_names:
        if k not in batched_feeds:
            out[k] = np.asarray(requests[0].feed[k])
            continue
        parts = [np.asarray(r.feed[k]) for r in requests]
        if bucket > total:
            parts.append(np.zeros((bucket - total,) + parts[0].shape[1:],
                                  parts[0].dtype))
        out[k] = parts[0] if len(parts) == 1 and bucket == total \
            else np.concatenate(parts, axis=0)
    return out


def row_spans(requests) -> List[Tuple[int, int]]:
    """[(row_offset, n), ...] of each request inside the merged batch, in
    group order."""
    spans = []
    off = 0
    for r in requests:
        spans.append((off, r.n))
        off += r.n
    return spans


def slice_rows(out, offset: int, n: int, bucket: int):
    """Slice one request's rows back out of a bucket-sized output (values
    whose leading dim is not the bucket are returned whole). Identity
    when the request IS the whole bucket."""
    if offset == 0 and n == bucket:
        return out

    def _one(v):
        if hasattr(v, "shape") and len(v.shape) >= 1 and \
                int(v.shape[0]) == bucket:
            return v[offset:offset + n]
        return v

    if isinstance(out, dict):
        return {k: _one(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_one(v) for v in out)
    return _one(out)


__all__ = ["BatchPolicy", "merge_feeds", "nonbatched_key", "pick_bucket",
           "row_spans", "slice_rows"]
