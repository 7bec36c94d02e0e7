"""Profiling spans + aggregate table (counterpart of
``paddle_tpu.core.profiler``).

Analog of the reference's host profiler (platform/profiler.h:27/73/127:
RecordEvent RAII ranges, EnableProfiler/DisableProfiler with a sorted
aggregate table) and CUPTI device tracer (device_tracer.h:49). Device
timelines come from ``torch.profiler`` (CUPTI on the card): given a
``trace_dir``, :func:`enable_profiler` starts one with the CPU and, where
there is a card, CUDA activities, and :func:`disable_profiler` writes its
chrome trace to ``<trace_dir>/trace.json``. The host-side RecordEvent span
API and the calls/total/min/max/ave table are reimplemented here, each
span also a ``torch.profiler.record_function`` range so it shows in
device traces.

The report scopes (:func:`report_scopes`) serve
``profiling.fusion_report``: while one runs, each layer a program's
``LayerHelper`` names opens a ``layer:<name>`` range (closed by the next
layer or the program's end), and the hand kernels' wrappers open one named
after the kernel (:func:`kernel_range`), so a profiled step maps each
device kernel to its layer and wrapper. Outside a report they cost one
flag read.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch
from torch.profiler import record_function

_enabled = False
_events: Dict[str, List[float]] = defaultdict(list)
_spans: List[tuple] = []   # (name, start_us, dur_us, tid) for the timeline dump
_trace_dir: Optional[str] = None
_torch_prof = None


@contextlib.contextmanager
def record_event(name: str) -> Iterator[None]:
    """RAII-style span (RecordEvent, profiler.h:73). Also a
    ``torch.profiler.record_function`` range, so spans show up in device
    traces."""
    if not _enabled:
        with record_function(name):
            yield
        return
    t0 = time.perf_counter()
    with record_function(name):
        yield
    t1 = time.perf_counter()
    _events[name].append((t1 - t0) * 1e3)  # ms
    _spans.append((name, t0 * 1e6, (t1 - t0) * 1e6, threading.get_ident() % 10000))


def enable_profiler(trace_dir: Optional[str] = None) -> None:
    """EnableProfiler analog; with ``trace_dir`` it also starts a
    ``torch.profiler`` trace (CPU, and CUDA where there is a card)."""
    global _enabled, _trace_dir, _torch_prof
    _enabled = True
    _events.clear()
    _spans.clear()
    _trace_dir = trace_dir
    if trace_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        _torch_prof = profile(activities=activities)
        _torch_prof.start()


def disable_profiler(sorted_key: str = "total", print_table: bool = True) -> List[dict]:
    """DisableProfiler analog: stop tracing (writing the device trace to
    ``<trace_dir>/trace.json``), return + print aggregate rows."""
    global _enabled, _torch_prof
    _enabled = False
    if _torch_prof is not None:
        prof, _torch_prof = _torch_prof, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(_trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(_trace_dir, "trace.json"))
    rows = []
    for name, samples in _events.items():
        rows.append(
            dict(
                name=name,
                calls=len(samples),
                total=sum(samples),
                min=min(samples),
                max=max(samples),
                ave=sum(samples) / len(samples),
            )
        )
    key = sorted_key if sorted_key in ("total", "calls", "min", "max", "ave") else "total"
    rows.sort(key=lambda r: r[key], reverse=True)
    if print_table and rows:
        hdr = f"{'Event':<40}{'Calls':>8}{'Total(ms)':>12}{'Min':>10}{'Max':>10}{'Ave':>10}"
        print(hdr)
        print("-" * len(hdr))
        for r in rows:
            print(
                f"{r['name']:<40}{r['calls']:>8}{r['total']:>12.3f}"
                f"{r['min']:>10.3f}{r['max']:>10.3f}{r['ave']:>10.3f}"
            )
    return rows


@contextlib.contextmanager
def profiler(trace_dir: Optional[str] = None, sorted_key: str = "total") -> Iterator[None]:
    """``fluid.profiler.profiler`` context-manager analog (profiler.py:221)."""
    enable_profiler(trace_dir)
    try:
        yield
    finally:
        disable_profiler(sorted_key)


def start_profiler(state: str = "All", trace_dir=None):
    """profiler.py start_profiler analog."""
    enable_profiler(trace_dir)


def stop_profiler(sorted_key: str = "total", profile_path=None):
    """profiler.py stop_profiler analog — prints the aggregate table."""
    return disable_profiler(sorted_key=sorted_key)


def cuda_profiler(*args, **kwargs):
    """profiler.py:39 cuda_profiler (nvprof control), an explicit stub as
    in the JAX package, so ported drivers fail loudly rather than
    silently."""
    raise NotImplementedError(
        "cuda_profiler is nvprof control; use profiler(trace_dir) / torch.profiler traces")


def reset_profiler():
    """profiler.py reset_profiler analog: drop collected spans."""
    _events.clear()
    _spans.clear()


def timeline(path: str, extra_spans=None) -> int:
    """tools/timeline.py:115 analog: dump recorded host spans as
    chrome://tracing JSON (device-side timelines come from the
    ``torch.profiler`` trace of :func:`enable_profiler`). Returns the
    number of events written.

    ``extra_spans`` — additional ``(name, start_us, dur_us, tid)``
    tuples merged into the dump; the Trainer's always-on per-dispatch
    spans (``profiling.steptime``) export through here so a trace
    exists even when the global profiler was never enabled."""
    events = [
        {"name": name, "ph": "X", "ts": ts, "dur": dur,
         "pid": 0, "tid": tid, "cat": "host"}
        for name, ts, dur, tid in list(_spans) + list(extra_spans or [])
    ]
    events.sort(key=lambda e: e["ts"])
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)


# -- report scopes (profiling.fusion_report) ----------------------------------

_NULL = contextlib.nullcontext()
_reporting = 0          # reports running (kernel ranges on any thread)
_report_thread: Optional[int] = None  # the thread whose programs open layer ranges
_tls = threading.local()


@contextlib.contextmanager
def report_scopes() -> Iterator[None]:
    """Open layer and kernel ranges while the block runs (one report at
    a time; layer ranges on the calling thread, kernel ranges on every
    thread, for the backward's kernels launched from autograd's)."""
    global _reporting, _report_thread
    _reporting += 1
    _report_thread = threading.get_ident()
    try:
        yield
    finally:
        _reporting -= 1
        if not _reporting:
            _report_thread = None


def kernel_range(name: str):
    """A ``record_function(name)`` range around a hand kernel's launch
    while a report runs; otherwise a shared no-op context."""
    return record_function(name) if _reporting else _NULL


def program_scope():
    """The extent of one program run: layer ranges open only inside one
    (a remat recompute in the backward runs outside and opens none), and
    the last one closes at its end."""
    if not _reporting or threading.get_ident() != _report_thread:
        return _NULL
    return _program_run()


@contextlib.contextmanager
def _program_run():
    _tls.depth = getattr(_tls, "depth", 0) + 1
    try:
        yield
    finally:
        _tls.depth -= 1
        _close_layer()


def enter_layer(name: str) -> None:
    """Start attributing what runs next to layer ``name`` (closing the
    previous layer's range), inside a program run of a report."""
    if not _reporting or not getattr(_tls, "depth", 0):
        return
    _close_layer()
    rf = record_function(f"layer:{name}")
    rf.__enter__()
    _tls.layer = rf


def _close_layer() -> None:
    rf = getattr(_tls, "layer", None)
    if rf is not None:
        _tls.layer = None
        rf.__exit__(None, None, None)
