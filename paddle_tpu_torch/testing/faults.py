"""Deterministic fault injection (counterpart of
``paddle_tpu.testing.faults``), every fault exactly reproducible.

- **Bad batches**: :func:`nan_batch_reader` poisons one batch of a reader
  with NaN/Inf at an exact batch index, :func:`nan_feed` one feed (they
  drive the Trainer's guard).
- **Scripted crashes**: :func:`crash_at_step` (an event handler that dies
  after step k), :func:`crashing` (arms a named
  :func:`~paddle_tpu_torch.resilience.crash_point` in the save path, so a
  kill mid-save happens at an exact phase) and :func:`acting` (runs a side
  effect at a crash point without dying there).
- **Membership changes**: :func:`visible_devices` and
  :func:`membership_meshes` give the devices and meshes of a worker count.

- **Artifact corruption**: :func:`truncate_file` / :func:`flip_byte`
  tear a committed checkpoint or inference artifact the way a torn disk
  write would (a hot reload of it must fail and roll back).
- **Serving faults**: :class:`FaultyPredictor` wraps a Predictor with a
  scripted ``run`` behavior — :func:`hanging_predictor` (a wedged call,
  drives the dispatch watchdog), :func:`failing_predictor` (a
  crash-looping call, drives the circuit breaker) — with call counts
  shared across ``clone()`` so a worker pool sees one fault script;
  :func:`kill_server` is the replica-death drill (abrupt
  ``PredictorServer.kill``: never-dispatched requests fail retryable,
  dispatched ones fail at most once).
- **Wire faults** (the cross-process fleet): :class:`LinkProxy`, a
  deterministic localhost TCP proxy a ``RemoteReplica`` routes through,
  with :func:`partition` (drop both ways, half-open sockets),
  :func:`heal` and :func:`slow_link` (a delay per chunk); and
  :func:`kill_process` (a real SIGKILL of a replica process).
- **A slow host-to-device link**: :func:`slow_h2d`, a ``DeviceFeeder``
  completion wait for its staging ring.
"""

from __future__ import annotations

import contextlib
import os
import socket
import threading
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from .. import resilience

InjectedCrash = resilience.InjectedCrash


# -- bad batches ---------------------------------------------------------------


def nan_batch_reader(reader: Callable[[], Iterator], at_batch: int,
                     column: int = 0, value: float = float("nan")):
    """Wrap a paddle-style reader (``reader() -> iterator of sample
    lists``): batch ``at_batch`` (0-based) has ``value`` splatted over
    sample column ``column`` (an integer column as float64). The same
    batch every epoch."""

    def poisoned():
        for i, samples in enumerate(reader()):
            if i == at_batch:
                samples = [
                    tuple(np.full_like(np.asarray(v, dtype=np.float64)
                                       if np.asarray(v).dtype.kind in "iu"
                                       else np.asarray(v), value)
                          if j == column else v
                          for j, v in enumerate(s))
                    for s in samples]
            yield samples
    return poisoned


def nan_feed(feed: Dict[str, np.ndarray], name: str,
             value: float = float("nan")) -> Dict[str, np.ndarray]:
    """A copy of a feed dict with ``name`` wholly non-finite (f32)."""
    out = dict(feed)
    out[name] = np.full_like(np.asarray(feed[name], dtype=np.float32), value)
    return out


# -- scripted crashes ----------------------------------------------------------


def crash_at_step(step: int, kind: str = "end_step"):
    """Event handler for ``fit``: raises :class:`InjectedCrash` once the
    event ``kind`` comes at step ``step`` or later, the in-process stand-in
    for ``kill -9`` between steps (checkpoints on disk stay as a real crash
    leaves them)."""

    def handler(event):
        if event.kind == kind and event.step >= step:
            raise InjectedCrash(f"scripted crash at step {event.step}")
    return handler


@contextlib.contextmanager
def crashing(tag: str):
    """Arm crash point ``tag`` for the block: the next time the save path
    reaches it, :class:`InjectedCrash` is raised there."""
    resilience.crash_points.add(tag)
    try:
        yield
    finally:
        resilience.crash_points.discard(tag)


@contextlib.contextmanager
def acting(tag: str, callback: Callable[[], None], once: bool = True):
    """Run ``callback()`` when crash point ``tag`` fires, without raising
    there: the process under test runs on while something else dies at an
    exact phase (a pserver stopped mid-shard-split). ``once`` disarms it
    after the first firing. Yields a one-element list, the firing count."""
    fired = [0]

    def _cb():
        if once and fired[0]:
            return
        fired[0] += 1
        callback()

    resilience.crash_callbacks[tag] = _cb
    try:
        yield fired
    finally:
        resilience.crash_callbacks.pop(tag, None)


# -- membership changes --------------------------------------------------------


def visible_devices(n: int):
    """The first ``n`` of the process's devices of the default type: the
    CUDA cards when there are any, else the CPU world (one ``cpu`` device a
    rank of the running gloo world, or the one CPU). Raises ``ValueError``
    past the count."""
    import torch
    import torch.distributed as dist

    if torch.cuda.is_available():
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        devs = [torch.device("cpu")] * world
    if not 1 <= int(n) <= len(devs):
        raise ValueError(f"visible_devices({n}): process has {len(devs)} "
                         "devices")
    return devs[:int(n)]


def membership_meshes(counts, axis: str = "dp"):
    """One ``{axis: n}`` mesh for each entry of ``counts``, each over the
    ranks of :func:`visible_devices` (n), built by ``parallel.make_mesh``:
    the same counts give the same meshes every run. The port's mesh covers
    every rank of its world (one process a device), so a count is the
    world's size; a drill that changes the count starts a new world."""
    from ..parallel.mesh import make_mesh

    return [make_mesh({axis: int(n)}, devices=list(range(len(visible_devices(int(n))))))
            for n in counts]


# -- artifact corruption -------------------------------------------------------


def truncate_file(ckpt_dir: str, name: Optional[str] = None,
                  keep_bytes: Optional[int] = None) -> str:
    """Truncate a file inside a committed checkpoint (default: the
    largest npz, to half its size) — the torn-tail failure mode."""
    name = name or _largest_npz(ckpt_dir)
    p = os.path.join(ckpt_dir, name)
    size = os.path.getsize(p)
    with open(p, "r+b") as f:
        f.truncate(size // 2 if keep_bytes is None else keep_bytes)
    return name


def flip_byte(ckpt_dir: str, name: Optional[str] = None,
              offset: Optional[int] = None) -> str:
    """XOR one byte of a checkpoint file (default: the largest npz,
    middle byte) — the silent-bitrot failure mode that only a checksum
    catches."""
    name = name or _largest_npz(ckpt_dir)
    p = os.path.join(ckpt_dir, name)
    off = os.path.getsize(p) // 2 if offset is None else offset
    with open(p, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))
    return name


def _largest_npz(ckpt_dir: str) -> str:
    npz = [n for n in os.listdir(ckpt_dir) if n.endswith(".npz")]
    if not npz:
        raise FileNotFoundError(f"no npz files in {ckpt_dir}")
    return max(npz, key=lambda n: os.path.getsize(os.path.join(ckpt_dir, n)))


# -- serving faults ----------------------------------------------------------


class FaultyPredictor:
    """Duck-typed :class:`paddle_tpu_torch.io.Predictor` wrapper for serving
    fault injection: validation/bucketing surfaces delegate to the real
    predictor, ``run`` routes through ``behavior(base, feed, call_index)``
    — which may hang, raise, or serve normally. The call counter and the
    behavior are SHARED across :meth:`clone`, so a
    ``serving.PredictorServer`` worker pool executes one deterministic
    fault script regardless of which worker dequeues which request."""

    def __init__(self, base, behavior: Callable, _counter=None, _lock=None):
        self._base = base
        self._behavior = behavior
        self._counter = _counter if _counter is not None else [0]
        self._lock = _lock if _lock is not None else threading.Lock()

    # validation/bucketing surface: delegate
    @property
    def feed_names(self):
        return self._base.feed_names

    @property
    def batch_buckets(self):
        return self._base.batch_buckets

    @property
    def batched_feeds(self):
        return self._base.batched_feeds

    @property
    def batch_size(self):
        return self._base.batch_size

    @property
    def device(self):
        return self._base.device

    def feed_spec(self, batch=None):
        return self._base.feed_spec(batch)

    def validate_feed(self, feed, allow_padding=False):
        return self._base.validate_feed(feed, allow_padding=allow_padding)

    def run(self, feed):
        with self._lock:
            i = self._counter[0]
            self._counter[0] += 1
        return self._behavior(self._base, feed, i)

    def clone(self) -> "FaultyPredictor":
        return FaultyPredictor(self._base.clone(), self._behavior,
                               _counter=self._counter, _lock=self._lock)


def hanging_predictor(base, release: "threading.Event",
                      hang_calls: int = 1,
                      skip_calls: int = 0) -> FaultyPredictor:
    """``run`` blocks on ``release`` for calls ``[skip_calls,
    skip_calls + hang_calls)`` (then serves normally) — the
    wedged-executable fault that drives the serving watchdog. Always
    ``release.set()`` in test teardown or the abandoned worker thread
    outlives the test."""

    def behavior(b, feed, i):
        if skip_calls <= i < skip_calls + hang_calls:
            release.wait()
        return b.run(feed)

    return FaultyPredictor(base, behavior)


def kill_server(server, reason: str = "injected replica kill"):
    """Abrupt replica death for fleet drills: delegates to
    :meth:`paddle_tpu_torch.serving.PredictorServer.kill` — the in-process
    stand-in for the serving process being ``kill -9``'d. Queued
    (never-dispatched) requests fail with ``ServerClosed`` (a
    ``FleetRouter`` reroutes them), dispatched in-flight requests fail
    with ``ReplicaDied`` exactly once (at-most-once, never retried),
    and the flight recorder captures the kill with the in-flight
    request's span. Deterministic: no subprocess, no signal timing —
    the kill happens exactly where the drill calls it."""
    server.kill(reason=reason)
    return server


def failing_predictor(base, fail_calls: int = 1_000_000,
                      skip_calls: int = 0,
                      exc: Optional[Callable[[], BaseException]] = None
                      ) -> FaultyPredictor:
    """``run`` raises on calls ``[skip_calls, skip_calls + fail_calls)``
    (then serves normally) — the crash-looping executable that trips the
    circuit breaker; a finite ``fail_calls`` lets the half-open probe
    find a recovered executable."""

    def behavior(b, feed, i):
        if skip_calls <= i < skip_calls + fail_calls:
            raise (exc() if exc is not None
                   else RuntimeError(f"injected executable failure #{i}"))
        return b.run(feed)

    return FaultyPredictor(base, behavior)


# -- wire faults (the cross-process fleet) ------------------------------------


class LinkProxy:
    """Deterministic TCP link fault injector for the cross-process
    fleet: a localhost forwarding proxy a :class:`~paddle_tpu_torch.fleet.
    remote.RemoteReplica` is pointed THROUGH (``RemoteReplica(
    proxy.addr, proc=proc)``), whose forwarding can be scripted:

    - :meth:`partition` — stop forwarding BOTH ways without closing
      either side's socket: a real half-open connection. The
      endpoints' ``send()`` keeps succeeding into kernel buffers and
      no reply ever arrives — exactly the observable behavior of a
      network partition, with none of the iptables/root — until
      :meth:`heal` resumes delivery (buffered bytes then arrive, like
      a healed route).
    - :meth:`slow` — delay every forwarded chunk by ``delay_ms``: the
      slow-but-alive replica that drives the router's probe-latency
      demotion.

    All state changes are instant and exact (a flag the pump threads
    read per chunk) — no packet-loss roulette, reproducible from
    tier-1 tests."""

    def __init__(self, target: "tuple", host: str = "127.0.0.1"):
        self.target = (str(target[0]), int(target[1]))
        self._mode = "pass"
        self._delay_ms = 0.0
        self._lock = threading.Lock()
        self._conns: list = []
        self._ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._ls.bind((host, 0))
        self._ls.listen(64)
        self.addr = (host, self._ls.getsockname()[1])
        self._closed = False
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="pdtorch-linkproxy-accept").start()

    # -- fault script --------------------------------------------------------
    def partition(self) -> "LinkProxy":
        """Blackhole the link both ways (half-open: sockets stay
        open, nothing is delivered)."""
        with self._lock:
            self._mode = "partition"
        return self

    def heal(self) -> "LinkProxy":
        with self._lock:
            self._mode = "pass"
        return self

    def slow(self, delay_ms: float) -> "LinkProxy":
        """Delay each forwarded chunk by ``delay_ms`` (0 restores)."""
        with self._lock:
            self._delay_ms = float(delay_ms)
        return self

    # -- plumbing ------------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._ls.accept()
            except OSError:
                return
            try:
                up = socket.create_connection(self.target, timeout=5.0)
            except OSError:
                conn.close()
                continue
            with self._lock:
                self._conns += [conn, up]
            for a, b in ((conn, up), (up, conn)):
                threading.Thread(target=self._pump, args=(a, b),
                                 daemon=True,
                                 name="pdtorch-linkproxy-pump").start()

    def _pump(self, src: socket.socket, dst: socket.socket) -> None:
        while True:
            with self._lock:
                mode, delay = self._mode, self._delay_ms
            if mode == "partition":
                # do not even read: bytes pile up in kernel buffers on
                # the sender's side of the blackhole, delivered only
                # if/when the link heals
                time.sleep(0.01)
                continue
            try:
                src.settimeout(0.05)
                data = src.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            if not data:
                break
            if delay > 0:
                time.sleep(delay / 1e3)
            # a read that raced the partition flip HOLDS its chunk
            # until heal — dropping it would desync the framed byte
            # stream for the healed link (a partition delays bytes,
            # it never corrupts the stream)
            while not self._closed:
                with self._lock:
                    if self._mode != "partition":
                        break
                time.sleep(0.01)
            try:
                dst.sendall(data)
            except OSError:
                break
        for s in (src, dst):
            try:
                s.close()
            except OSError:
                pass

    def close(self) -> None:
        self._closed = True
        try:
            self._ls.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = self._conns, []
        for s in conns:
            try:
                s.close()
            except OSError:
                pass

    def __enter__(self) -> "LinkProxy":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def partition(link: LinkProxy) -> LinkProxy:
    """Drop everything both ways on a :class:`LinkProxy` link — a real
    half-open TCP partition (sockets stay open, sends succeed, replies
    never come). Pair with :func:`heal`."""
    return link.partition()


def heal(link: LinkProxy) -> LinkProxy:
    """Resume delivery on a partitioned/slowed link."""
    return link.heal().slow(0.0)


def slow_link(link: LinkProxy, delay_ms: float) -> LinkProxy:
    """Delay every chunk on the link by ``delay_ms`` — the
    slow-but-alive failure mode behind probe-latency demotion."""
    return link.slow(delay_ms)


def slow_h2d(delay_ms: float):
    """A ``DeviceFeeder(wait_fn=...)`` completion wait under which each
    chunk's transfer completes ``delay_ms`` after its submission,
    independently of the other chunks: a latency-bound link, which the
    2-deep staging ring pipelines (two transfers in flight) and the
    blocking put serializes. Deterministic: no bandwidth model, no
    jitter. The wait ends by synchronizing the chunk's own copy (its CUDA
    event; a CPU put is already done)."""
    from ..data.feeder import wait_staged

    delay_s = float(delay_ms) / 1e3

    def wait(item, t_submit):
        remaining = t_submit + delay_s - time.perf_counter()
        if remaining > 0:
            time.sleep(remaining)
        wait_staged(item)

    return wait


def kill_process(replica) -> None:
    """SIGKILL a fleet replica PROCESS, no cleanup, no warning — the
    real thing, unlike :func:`kill_server`'s in-process stand-in.
    Accepts a :class:`~paddle_tpu_torch.fleet.remote.RemoteReplica`, a
    :class:`~paddle_tpu_torch.fleet.remote.ReplicaProcess`, or a bare pid.
    Deterministic: the kill lands exactly where the drill calls it
    (the kernel delivers bytes the victim already wrote — which is
    what makes the never-dispatched/dispatched classification on the
    surviving side exact)."""
    proc = getattr(replica, "proc", replica)
    if isinstance(proc, int):
        os.kill(proc, 9)
        return
    kill = getattr(proc, "kill", None)
    if kill is None:
        raise TypeError(f"kill_process: cannot kill {replica!r}")
    kill()


__all__ = ["FaultyPredictor", "LinkProxy", "failing_predictor", "flip_byte", "hanging_predictor",
           "heal", "kill_process", "kill_server", "partition", "slow_h2d", "slow_link",
           "truncate_file"]
