"""The device dataset cache: keep the encoded epoch on the card and feed
it again device to device (counterpart of ``paddle_tpu.data.device_cache``).

Epoch 1 streams as usual, and each encoded (wire-dtype, pre-decode)
chunk that crossed the link is offered to the cache and, within its
budget, kept on the card; epoch 2 on feeds the step from the kept chunks,
device to device, with no host-to-device bytes. The cache keeps exactly
what crossed the link, so the step's decode and augmentation run
unchanged and a cached epoch is bit-identical to a streamed one.

Admission is budgeted against the card's memory left over by the step:
its total (``torch.cuda.mem_get_info``) times a safety margin, less the
advisor's estimate of the step (params, optimizer and program state, the
bytes a forward saves for its backward). It degrades gracefully:

- the dataset fits: **full**, epoch 2 on never touches the link;
- the budget runs out mid-epoch: **partial**, the admitted prefix is
  served from the card and the rest streams (admission stops at the first
  refusal, so the kept region is a contiguous prefix);
- no budget at all (the CPU with no explicit budget, or nothing left):
  **off**, every epoch streams.

A mesh's chunks are the DTensors ``put_batch`` made: the per-device
bytes charged are each rank's local shards.

Invalidation: ``fit(resume=True)`` (the restored position lies
mid-epoch) and ``resilience.reshard_restore`` (a new mesh) drop the
chunks through ``trainer.device_cache``. The cache assumes a reader
that gives the same batches in the same order every epoch.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


def _log():
    return logging.getLogger("paddle_tpu_torch.device_cache")


def _local(v):
    return v.to_local() if hasattr(v, "to_local") else v


def device_feed_nbytes(feed: Dict[str, Any]) -> int:
    """Total bytes of a feed's tensors: the wire bytes a streamed transfer
    of the same chunk would have moved (the tensors hold the encoded wire
    dtype; the decode runs in the step)."""
    total = 0
    for v in feed.values():
        if isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        else:
            total += np.asarray(v).nbytes
    return total


def device_feed_resident_nbytes(feed: Dict[str, Any]) -> int:
    """The bytes a feed keeps on its busiest device: a plain tensor counts
    whole on its device, a DTensor its local shard (this rank's)."""
    per_dev: Dict[Any, int] = {}
    for v in feed.values():
        if not isinstance(v, torch.Tensor):
            per_dev[None] = per_dev.get(None, 0) + np.asarray(v).nbytes
            continue
        t = _local(v)
        per_dev[t.device] = per_dev.get(t.device, 0) + t.numel() * t.element_size()
    return max(per_dev.values()) if per_dev else 0


def residual_hbm_bytes(trainer, sample_feed: Dict[str, Any], safety: float = 0.8,
                       hbm_budget_bytes: Optional[int] = None) -> Optional[int]:
    """The card's memory left over by the training step, the cache's
    automatic budget: ``safety`` times the card's total (or
    ``hbm_budget_bytes``) less the advisor's estimate of the step. None
    on the CPU without an explicit budget."""
    from ..profiling.advisor import device_hbm_bytes, memory_estimate

    budget = (hbm_budget_bytes if hbm_budget_bytes is not None
              else device_hbm_bytes(trainer.device))
    if budget is None:
        return None
    est = memory_estimate(trainer, sample_feed, project_remat=False)
    return max(0, int(safety * budget) - int(est["est_total_bytes"]))


class DeviceCache:
    """The dataset cache ``fit(device_cache=...)`` drives: epoch 1
    offers each transferred chunk; epoch 2 on serves the admitted prefix
    device to device. Offers and serves happen on the training loop's
    thread; the lock guards reads of its counters from other threads
    (telemetry scrapes).

    States (``.state``): ``"cold"`` (nothing offered yet),
    ``"admitting"`` (epoch 1 in flight), ``"full"`` / ``"partial"``
    (sealed; epoch 2+ serves), ``"off"`` (no budget or budget
    exhausted before the first chunk), ``"invalid"`` (explicitly
    invalidated — reload/reshard)."""

    def __init__(self, budget_bytes: Optional[int] = None,
                 trainer=None, safety: float = 0.8):
        self.budget_bytes = budget_bytes   # None -> resolve at first offer
        self.safety = float(safety)
        self._trainer = trainer
        self._lock = threading.Lock()
        self._chunks: List[Tuple[int, Dict[str, Any], int]] = []  # (n, feed, wire_b)
        self._resident = 0          # per-device bytes admitted
        self._rejected = False      # first rejection ends admission (prefix)
        self._sealed = False
        self._complete = False      # sealed covering the WHOLE epoch
        self._invalid_reason: Optional[str] = None
        self._off_reason: Optional[str] = None
        self.hits = 0
        self.hit_bytes = 0

    # -- construction --------------------------------------------------------
    @classmethod
    def make(cls, obj, trainer=None) -> Optional["DeviceCache"]:
        """Normalize ``fit(device_cache=...)``: ``None``/``False`` →
        no cache; ``True``/``"auto"`` → advisor-budgeted; an int → that
        explicit per-device byte budget; a DeviceCache → itself (bound
        to the trainer)."""
        if obj is None or obj is False:
            return None
        if isinstance(obj, cls):
            obj._trainer = trainer if trainer is not None else obj._trainer
            return obj
        if obj is True or obj == "auto":
            return cls(trainer=trainer)
        if isinstance(obj, (int, np.integer)):
            return cls(budget_bytes=int(obj), trainer=trainer)
        raise TypeError(
            f"device_cache: expected None|bool|'auto'|int budget|"
            f"DeviceCache, got {type(obj).__name__}")

    def bind(self, trainer) -> "DeviceCache":
        self._trainer = trainer
        return self

    # -- state ---------------------------------------------------------------
    def _state_locked(self) -> str:
        if self._invalid_reason is not None:
            return "invalid"
        if self._off_reason is not None:
            return "off"
        if self._sealed:
            return "full" if self._complete else "partial"
        return "admitting" if self._chunks or self._rejected else "cold"

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    @property
    def ready(self) -> bool:
        """Sealed with at least one chunk: epoch 2+ can serve."""
        with self._lock:
            return (self._sealed and bool(self._chunks)
                    and self._invalid_reason is None)

    @property
    def complete(self) -> bool:
        """Sealed AND covering the whole epoch (zero streaming left)."""
        return self.ready and self._complete

    @property
    def cached_steps(self) -> int:
        """Optimizer steps (== reader batches) the cached prefix
        covers."""
        with self._lock:
            return sum(n for n, _, _ in self._chunks)

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident

    def _resolve_budget(self, n: int, device_feed) -> Optional[int]:
        if self.budget_bytes is not None:
            return self.budget_bytes
        if self._trainer is None:
            return None
        try:
            # the estimate runs one step: a fused chunk carries (K, batch,
            # ...), so it takes the chunk's first step
            sample = {k: (v[0] if n > 1 else v) for k, v in device_feed.items()}
            self.budget_bytes = residual_hbm_bytes(self._trainer, sample,
                                                   safety=self.safety)
        except Exception as e:
            _log().warning("device cache: residual-HBM estimate failed "
                           "(%s: %s); cache off", type(e).__name__, e)
            self.budget_bytes = None
        return self.budget_bytes

    # -- epoch-1 admission ---------------------------------------------------
    def offer(self, n: int, device_feed: Dict[str, Any]) -> bool:
        """Offer one transferred chunk (``n`` steps of device-resident
        encoded feed) for admission. Returns True when retained. The
        first rejection permanently ends admission so the cached region
        is a contiguous epoch prefix."""
        with self._lock:
            if (self._sealed or self._rejected
                    or self._invalid_reason is not None
                    or self._off_reason is not None):
                return False
        budget = self._resolve_budget(n, device_feed)
        if budget is None:
            with self._lock:
                reason = "no HBM budget (CPU device? pass " \
                         "an explicit device_cache byte budget)"
                self._off_reason = reason
            _log().info("device cache off: %s", reason)
            return False
        per_dev = device_feed_resident_nbytes(device_feed)
        wire_b = device_feed_nbytes(device_feed)
        with self._lock:
            if self._resident + per_dev > budget:
                self._rejected = True
                if not self._chunks:
                    self._off_reason = (
                        f"first chunk ({per_dev} B/device) exceeds the "
                        f"{budget} B residual-HBM budget")
                return False
            self._chunks.append((int(n), device_feed, wire_b))
            self._resident += per_dev
            return True

    def seal(self, epoch_steps: int) -> None:
        """End of a fully-observed epoch 1: freeze the cache.
        ``epoch_steps`` is the epoch's true step count — equal to the
        cached prefix means the whole dataset is resident (full);
        greater means partial."""
        with self._lock:
            if self._invalid_reason is not None or not self._chunks:
                return
            self._sealed = True
            complete = (not self._rejected
                        and sum(n for n, _, _ in self._chunks)
                        == int(epoch_steps))
            self._complete = complete
        _log().info(
            "device cache sealed: %s, %d steps / %d bytes resident per "
            "device", "full" if complete else "partial",
            self.cached_steps, self.resident_bytes)

    # -- epoch-2+ serving ----------------------------------------------------
    def chunks(self, metrics=None) -> Iterator[Tuple[int, Dict[str, Any]]]:
        """Yield the cached prefix as ``(n, device_feed)`` chunks —
        zero h2d bytes. ``metrics`` (a ``PipelineMetrics``) records each
        hit's wire bytes under the cache attribution (never the h2d
        stage)."""
        with self._lock:
            snapshot = list(self._chunks) if self._sealed \
                and self._invalid_reason is None else []
        for n, feed, wire_b in snapshot:
            with self._lock:
                self.hits += 1
                self.hit_bytes += wire_b
            if metrics is not None:
                metrics.record_cache_hit(wire_b)
            yield n, feed

    # -- invalidation --------------------------------------------------------
    def invalidate(self, reason: str) -> None:
        """Drop every cached chunk (HBM released as soon as the step
        stops referencing them). Called on checkpoint reload and
        elastic reshard — and safe to call any time; a later fit
        streams and re-admits from scratch via :meth:`reset`."""
        with self._lock:
            had = bool(self._chunks)
            self._chunks = []
            self._resident = 0
            self._sealed = self._complete = False
            self._rejected = False
            self._invalid_reason = str(reason)
        if had:
            _log().info("device cache invalidated (%s)", reason)

    def reset(self) -> None:
        """Clear an invalidation so a fresh epoch can re-admit."""
        with self._lock:
            self._invalid_reason = None
            self._off_reason = None
            self._chunks = []
            self._resident = 0
            self._sealed = self._complete = False
            self._rejected = False

    @property
    def invalid_reason(self) -> Optional[str]:
        return self._invalid_reason

    def report(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "state": self._state_locked(),
                "budget_bytes": self.budget_bytes,
                "resident_bytes": self._resident,
                "cached_steps": sum(n for n, _, _ in self._chunks),
                "cached_chunks": len(self._chunks),
                "hits": self.hits,
                "hit_bytes": self.hit_bytes,
                "invalid_reason": self._invalid_reason,
                "off_reason": self._off_reason,
            }


__all__ = ["DeviceCache", "device_feed_nbytes", "device_feed_resident_nbytes",
           "residual_hbm_bytes"]
