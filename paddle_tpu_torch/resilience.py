"""Checkpoint manifests, resume scanning and preemption (counterpart of
the manifest half of ``paddle_tpu.resilience``).

- **Manifests** (:func:`write_manifest` / :func:`validate_checkpoint`):
  every ``io.save_trainer`` checkpoint and ``io.save_inference_model``
  artifact carries ``manifest.json`` with a format version,
  ``global_step``, per-file CRC32 checksums and sizes, and the flat
  shape/dtype spec of every array collection. The file format is the JAX
  package's, so each package validates the other's directories. A torn,
  truncated or bit-flipped directory raises :class:`CheckpointCorrupt`.
- **Atomic commit** (in ``io.save_trainer``): files are written to a
  ``<dir>.tmp.<pid>`` sibling, fsynced, manifested last and renamed into
  place; scanners ignore ``*.tmp.*`` leftovers, and
  :func:`sweep_tmp_dirs` removes them.
- **Resume scanning** (:func:`list_checkpoints` /
  :func:`restore_latest`): restore the newest checkpoint that validates,
  falling back over corrupt ones.
- **Preemption** (:class:`PreemptionHandler`): SIGTERM/SIGINT sets a flag;
  ``fit`` checkpoints at the next step boundary and returns.
- **Fault injection** (:func:`crash_point`): named crash points in the
  save paths let tests kill a save at an exact phase.
- **The NaN/Inf guard's policy** (:class:`GuardPolicy`, :class:`Incident`,
  :func:`escalate_if_needed`, :func:`record_incident`): ``Trainer(guard=)``
  discards a non-finite step on the device and records an incident here.

- **Elastic restores** (:func:`reshard_restore`,
  ``restore_latest(elastic=True)``, :class:`ResizeRequest`): a checkpoint
  written at one mesh restores at another, after
  ``analysis.contracts.check_artifacts`` has proved it feasible; a
  scheduled resize checkpoints at a step boundary and returns, for the
  launcher to relaunch at the new size.

Not carried yet: the CRC-framed segment log of the telemetry store
(:func:`frame_record` and its siblings raise :class:`NotYetPorted`;
ROADMAP queue 1, item 24; an incident is logged, not journaled, until
then), and with it the journal lines, counters and flight dumps that the
JAX package's elastic paths emit.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import signal
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from .core.errors import EnforceError, NotYetPorted

MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 1
TMP_MARKER = ".tmp."  # uncommitted checkpoint dirs carry this in their name


def _log():
    return logging.getLogger("paddle_tpu_torch.resilience")


class CheckpointCorrupt(EnforceError):
    """A checkpoint or artifact directory failed validation (torn write,
    truncated or bit-flipped file, missing member, unreadable manifest).
    Carries ``path`` and ``reason`` so callers can fall back."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"corrupt checkpoint at {path}: {reason}")
        self.path = path
        self.reason = reason


class ReshardError(EnforceError):
    """A restore implies a mesh reshard: the checkpoint's recorded
    ``meta.mesh_axes`` (or ZeRO axes) differ from the trainer's. The
    checkpoint is fine, so resume scanning re-raises instead of falling
    back to an older one."""

    def __init__(self, path: str, saved_axes, target_axes, reason: str):
        super().__init__(f"cannot restore {path}: {reason}")
        self.path = path
        self.saved_axes = dict(saved_axes) if saved_axes else None
        self.target_axes = dict(target_axes) if target_axes else None
        self.reason = reason


# -- fault injection hooks ---------------------------------------------------
# The save paths call crash_point(tag) at each phase boundary; both
# registries are empty in production. Tests arm a tag to simulate kill -9 at
# that phase (crash_points -> raise InjectedCrash) or to run a side effect
# there (crash_callbacks).

crash_points: set = set()
crash_callbacks: Dict[str, Any] = {}


class InjectedCrash(BaseException):
    """Raised by an armed crash point. A BaseException, so ordinary
    ``except Exception`` recovery code cannot swallow it: it models abrupt
    process death."""


def crash_point(tag: str) -> None:
    if crash_callbacks:
        cb = crash_callbacks.get(tag)
        if cb is not None:
            cb()
    if crash_points and tag in crash_points:
        raise InjectedCrash(tag)


# -- manifest ----------------------------------------------------------------


def _crc32_file(path: str, chunk: int = 1 << 20) -> Tuple[int, int]:
    crc, size = 0, 0
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                return crc & 0xFFFFFFFF, size
            crc = zlib.crc32(b, crc)
            size += len(b)


def write_manifest(dirname: str, meta: Optional[Dict[str, Any]] = None,
                   arrays: Optional[Dict[str, Dict[str, Any]]] = None) -> Dict[str, Any]:
    """Write ``manifest.json`` covering every regular file already in
    ``dirname``: format version, per-file CRC32 and size, the checkpoint
    ``meta`` (``global_step`` ...) and the flat shape/dtype spec of each
    array collection (``arrays``: npz filename → {flat key: {"shape",
    "dtype"}}). Written last, so its presence implies the files it
    describes were fully written."""
    files = {}
    for name in sorted(os.listdir(dirname)):
        p = os.path.join(dirname, name)
        if not os.path.isfile(p) or name == MANIFEST_NAME:
            continue
        crc, size = _crc32_file(p)
        files[name] = {"crc32": crc, "size": size}
    man = {"format_version": MANIFEST_VERSION,
           "global_step": int((meta or {}).get("global_step", 0)),
           "meta": meta or {},
           "files": files,
           "arrays": arrays or {}}
    tmp = os.path.join(dirname, MANIFEST_NAME + ".part")
    with open(tmp, "w") as f:
        json.dump(man, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(dirname, MANIFEST_NAME))
    return man


def read_manifest(dirname: str) -> Optional[Dict[str, Any]]:
    """Parse a directory's ``manifest.json`` without the CRC pass. Returns
    None for a legacy (pre-manifest) directory; raises
    :class:`CheckpointCorrupt` for a missing directory or an
    unreadable or newer-version manifest."""
    if not os.path.isdir(dirname):
        raise CheckpointCorrupt(dirname, "not a directory")
    mpath = os.path.join(dirname, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath) as f:
            man = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorrupt(dirname, f"unreadable manifest: {e}") from e
    ver = man.get("format_version")
    if not isinstance(ver, int) or ver > MANIFEST_VERSION:
        raise CheckpointCorrupt(
            dirname, f"manifest format_version {ver!r} not supported "
            f"(this build reads <= {MANIFEST_VERSION})")
    return man


def validate_checkpoint(dirname: str) -> Optional[Dict[str, Any]]:
    """Verify a directory against its manifest: returns the manifest,
    None for a legacy directory, and raises :class:`CheckpointCorrupt` on
    a missing file or a size or checksum mismatch. One streaming pass over
    every file, so a restore reads the checkpoint twice: size checks alone
    cannot catch a flipped bit."""
    man = read_manifest(dirname)
    if man is None:
        return None  # legacy checkpoint: the caller decides how far to trust it
    for name, spec in (man.get("files") or {}).items():
        p = os.path.join(dirname, name)
        if not os.path.isfile(p):
            raise CheckpointCorrupt(dirname, f"missing file {name!r}")
        crc, size = _crc32_file(p)
        if size != spec.get("size"):
            raise CheckpointCorrupt(
                dirname, f"{name!r} truncated/grown: {size} bytes on disk "
                f"vs {spec.get('size')} in manifest")
        if crc != spec.get("crc32"):
            raise CheckpointCorrupt(
                dirname, f"{name!r} checksum mismatch: crc32 {crc:#010x} "
                f"on disk vs {spec.get('crc32'):#010x} in manifest")
    if (man.get("meta") or {}).get("zero"):
        # a shard file the manifest does not cover is from another
        # checkpoint generation: the directory is refused as a unit
        covered = set(man.get("files") or {})
        stray = sorted(name for name in os.listdir(dirname)
                       if ".zero" in name and name.endswith(".npz")
                       and os.path.isfile(os.path.join(dirname, name))
                       and name not in covered)
        if stray:
            raise CheckpointCorrupt(
                dirname, f"shard files {stray[:3]} on disk are not in the "
                "manifest — a mix of two checkpoint generations; refusing "
                "to restore any of it")
    return man


def _segments_not_ported(*args, **kwargs):
    raise NotYetPorted("the CRC-framed segment log (frame_record, iter_records, "
                       "seal_segment, check_segment) comes with the telemetry "
                       "store (ROADMAP queue 1, item 24)")


frame_record = iter_records = seal_segment = check_segment = _segments_not_ported


# -- checkpoint-directory scanning ------------------------------------------


@dataclasses.dataclass
class CheckpointInfo:
    path: str
    tag: str                      # directory basename (epoch_N / step_N)
    global_step: int              # from the manifest (or legacy meta.json); -1 unknown
    mtime: float

    @property
    def sort_key(self):
        return (self.global_step, self.mtime, self.tag)


def _read_step(path: str) -> int:
    for name in (MANIFEST_NAME, "meta.json"):
        p = os.path.join(path, name)
        try:
            with open(p) as f:
                return int(json.load(f).get("global_step", -1))
        except (OSError, ValueError, TypeError):
            continue
    return -1


def list_checkpoints(root: str) -> List[CheckpointInfo]:
    """Committed checkpoint directories under ``root``, oldest first
    (ascending ``global_step``, mtime breaking ties). ``*.tmp.*``
    leftovers are ignored; nothing is validated here."""
    out: List[CheckpointInfo] = []
    if not os.path.isdir(root):
        return out
    for name in os.listdir(root):
        if TMP_MARKER in name:
            continue
        p = os.path.join(root, name)
        if not os.path.isdir(p):
            continue
        if not any(os.path.exists(os.path.join(p, f))
                   for f in (MANIFEST_NAME, "meta.json", "params.npz")):
            continue
        out.append(CheckpointInfo(path=p, tag=name, global_step=_read_step(p),
                                  mtime=os.path.getmtime(p)))
    out.sort(key=lambda c: c.sort_key)
    return out


def sweep_tmp_dirs(root: str, tag: Optional[str] = None) -> List[str]:
    """Remove uncommitted ``*.tmp.*`` leftovers under ``root`` (all of
    them, or only ``<tag>.tmp.*``). One process owns a checkpoint
    directory, as ``fit`` does: a live concurrent writer's tmp dir would
    be swept too, and its commit would then fail loudly."""
    removed = []
    if not os.path.isdir(root):
        return removed
    prefix = f"{tag}{TMP_MARKER}" if tag is not None else None
    for name in os.listdir(root):
        if TMP_MARKER not in name:
            continue
        if prefix is not None and not name.startswith(prefix):
            continue
        p = os.path.join(root, name)
        if os.path.isdir(p):
            shutil.rmtree(p, ignore_errors=True)
            removed.append(p)
    if removed:
        _log().info("swept %d stale tmp checkpoint dir(s) under %s", len(removed), root)
    return removed


def restore_latest(root: str, trainer, elastic: bool = False,
                   sample_feed: Optional[Dict[str, Any]] = None
                   ) -> Optional[Dict[str, Any]]:
    """Restore ``trainer`` from the newest checkpoint under ``root`` that
    validates and loads, falling back over corrupt ones (warning for
    each). Returns the checkpoint's meta, or None when none restores.

    A checkpoint saved at other mesh axes than the trainer's is not
    corrupt: without ``elastic`` its :class:`ReshardError` propagates
    (falling back to an older checkpoint would discard progress); with
    ``elastic=True`` the restore goes through :func:`reshard_restore`,
    ``sample_feed`` giving the batch its feasibility check reads (the
    ``fit(resume=True, elastic=True)`` path)."""
    from . import io as _io

    for info in reversed(list_checkpoints(root)):
        try:
            try:
                _io.load_trainer(info.path, trainer)
            except ReshardError:
                # (the JAX package journals and flight-dumps the error here:
                # ROADMAP queue 1, item 24)
                if not elastic:
                    raise
                rep = reshard_restore(info.path, trainer, sample_feed=sample_feed)
                _log().info("elastic resume: resharded %s from mesh %s onto %s "
                            "(%d bytes re-placed in %.3fs)", info.path, rep["saved_axes"],
                            rep["target_axes"], rep["bytes_moved"], rep["seconds"])
        except CheckpointCorrupt as e:
            _log().warning("skipping corrupt checkpoint %s (%s); falling back "
                           "to an older one", info.path, e.reason)
            continue
        meta = dict(trainer._last_loaded_meta or {})
        meta.setdefault("global_step", trainer.global_step)
        _log().info("resumed from %s at global_step=%d", info.path, trainer.global_step)
        return meta
    return None


def normalize_mesh_axes(axes: Optional[Dict[str, Any]]) -> Dict[str, int]:
    """Canonical ``{axis: size}`` with size-1 axes dropped: ``{"dp": 1}``
    and no mesh place arrays identically."""
    return {str(k): int(v) for k, v in (axes or {}).items() if int(v) > 1}


def mesh_axes(mesh) -> Optional[Dict[str, int]]:
    """The ``meta.mesh_axes`` of a mesh (``parallel.Mesh`` or
    ``parallel.mesh.AbstractMesh``): ``{axis: size}`` in axis order, or
    None for no mesh. ``io.save_trainer`` records it, and the load gate and
    ``analysis.contracts`` compare against it."""
    if mesh is None:
        return None
    return {str(a): int(mesh.shape[a]) for a in mesh.axis_names}


def trainer_mesh_axes(trainer) -> Optional[Dict[str, int]]:
    """:func:`mesh_axes` of the trainer's mesh (None on one device)."""
    return mesh_axes(getattr(trainer, "mesh", None))


def reshard_restore(checkpoint_dir: str, trainer,
                    sample_feed: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Restore a checkpoint onto a trainer whose mesh differs from the
    saved ``meta.mesh_axes`` (resilience.py:535): dp N→M either way, one
    device included, and a ZeRO layout change.

    The checkpoint's arrays are stored unsharded (a ZeRO checkpoint's rows
    gather back to them), so the reshard is the placement that the target
    trainer's rule table gives them: ``io.load_trainer`` places them as
    ``startup`` places its params. Params, optimizer state, program
    state, the loss-scale state and the step restore bit for bit.

    Feasibility is proved first, by ``analysis.contracts.check_artifacts``
    on the manifest, the trainer and ``sample_feed`` (the batch the target
    data shards must divide; without it the batch is unchecked): a
    ``ckpt:reshard-infeasible`` finding raises :class:`ReshardError` with
    that finding's text before any state of the trainer is touched.

    Returns ``meta``, ``saved_axes``, ``target_axes``, ``global_step``,
    ``bytes_moved`` (the checkpoint's bytes, from the manifest's file
    sizes) and ``seconds`` (the restore's wall time)."""
    from . import io as _io
    from .analysis import contracts as _contracts

    t0 = time.perf_counter()
    man = read_manifest(checkpoint_dir)  # CheckpointCorrupt if unreadable
    saved_axes = ((man or {}).get("meta") or {}).get("mesh_axes")
    target_axes = trainer_mesh_axes(trainer)
    report = _contracts.check_artifacts(trainer=trainer, checkpoint_dir=checkpoint_dir,
                                        sample_feed=sample_feed)
    infeasible = report.by_code("ckpt:reshard-infeasible")
    if infeasible:
        # (journaled and flight-dumped in the JAX package: item 24)
        raise ReshardError(checkpoint_dir, saved_axes, target_axes, infeasible[0].message)
    _io.load_trainer(checkpoint_dir, trainer, allow_reshard=True)
    # (the JAX package drops its device dataset cache here, whose arrays
    # are laid out for the old mesh: item 23; and counts the reshard in
    # paddle_tpu_resilience_reshards_total: item 24)
    bytes_moved = sum(int(spec.get("size", 0))
                      for spec in ((man or {}).get("files") or {}).values())
    return {
        "meta": dict(trainer._last_loaded_meta or {}),
        "saved_axes": dict(saved_axes) if saved_axes else None,
        "target_axes": dict(target_axes) if target_axes else None,
        "global_step": trainer.global_step,
        "bytes_moved": bytes_moved,
        "seconds": time.perf_counter() - t0,
    }


class ResizeRequest:
    """A scheduled grow or shrink of an elastic run (resilience.py:690).
    Where :class:`PreemptionHandler` reacts to a SIGTERM nobody planned, a
    ResizeRequest watches a request file that an operator or a scheduler
    drops beside the run::

        with ResizeRequest("/run/resize.json") as rz:
            fit(trainer, ..., resize=rz)

        # elsewhere: echo '{"dp": 4}' > /run/resize.json

    ``fit(resize=...)`` polls :attr:`requested` at the step boundary where
    it polls preemption: once the file exists (or the optional
    ``signal_num`` arrived), the run checkpoints there and returns with a
    ``"resized"`` event, so the launcher can relaunch at the new size and
    ``fit(resume=True, elastic=True)`` reshards the checkpoint onto the new
    mesh. The file's JSON body (:attr:`target`, e.g. ``{"dp": 4}``) is
    advisory; an empty or unparsable file reads as ``{}``.

    :meth:`consume` removes the file and clears the flag (the launcher
    calls it after acting, so a request does not trigger the next run).
    The signal handler installs only in the main thread; the file watch
    works from any thread."""

    def __init__(self, path: str, signal_num: Optional[int] = None):
        self.path = path
        self.signal_num = signal_num
        self._flag = threading.Event()
        self._old: Any = None
        self.installed = False

    @property
    def requested(self) -> bool:
        return self._flag.is_set() or os.path.exists(self.path)

    @property
    def target(self) -> Dict[str, Any]:
        """The request's body ({} when absent, empty or not a JSON object)."""
        try:
            with open(self.path) as f:
                body = f.read().strip()
            doc = json.loads(body) if body else {}
            return doc if isinstance(doc, dict) else {}
        except (OSError, ValueError):
            return {}

    def request(self, target: Optional[Dict[str, Any]] = None) -> None:
        """Drop the request file, atomically (what an in-process scheduler
        calls)."""
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(dict(target or {}), f)
        os.replace(tmp, self.path)

    def consume(self) -> Dict[str, Any]:
        """Read and clear: the target, with the file removed and the flag
        reset."""
        target = self.target
        try:
            os.remove(self.path)
        except OSError:
            pass
        self._flag.clear()
        return target

    def _handle(self, signum, frame):
        self._flag.set()
        _log().warning("received %s: elastic resize requested; checkpointing at the "
                       "next step boundary", signal.Signals(signum).name)

    def __enter__(self) -> "ResizeRequest":
        if self.signal_num is not None and \
                threading.current_thread() is threading.main_thread():
            self._old = signal.signal(self.signal_num, self._handle)
            self.installed = True
        return self

    def __exit__(self, *exc):
        if self.installed:
            try:
                signal.signal(self.signal_num, self._old)
            except (ValueError, TypeError):
                pass
            self.installed = False
        return False


# -- preemption --------------------------------------------------------------


class PreemptionHandler:
    """SIGTERM/SIGINT → "checkpoint at the next step boundary and exit
    cleanly".

    A context manager; ``requested`` flips on the first signal (its
    number in ``signum``). A second
    signal of the same kind restores the previous handler and re-raises
    it, so a stuck run can still be killed. Signal handlers install only
    in the main thread; elsewhere the handler is an inert flag
    (``installed`` is False)."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, signals=None):
        self.signals = tuple(signals) if signals is not None else self.SIGNALS
        self._flag = threading.Event()
        self._old: Dict[int, Any] = {}
        self.installed = False
        self.signum: Optional[int] = None

    @property
    def requested(self) -> bool:
        return self._flag.is_set()

    def _handle(self, signum, frame):
        if self._flag.is_set():
            # second signal: restore the old handler and deliver it again;
            # a handler not installed from Python reads back as None
            old = self._old.get(signum) or signal.SIG_DFL
            try:
                signal.signal(signum, old)
            except (ValueError, TypeError):
                signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        self.signum = signum
        self._flag.set()
        _log().warning("received %s: checkpointing at the next step boundary, then "
                       "exiting (signal again to abort immediately)",
                       signal.Signals(signum).name)

    def __enter__(self) -> "PreemptionHandler":
        if threading.current_thread() is threading.main_thread():
            for s in self.signals:
                self._old[s] = signal.signal(s, self._handle)
            self.installed = True
        return self

    def __exit__(self, *exc):
        if self.installed:
            for s, old in self._old.items():
                try:
                    signal.signal(s, old)
                except (ValueError, TypeError):
                    pass
            self._old.clear()
            self.installed = False
        return False


# -- NaN/Inf guard policy ----------------------------------------------------


@dataclasses.dataclass
class GuardPolicy:
    """How ``Trainer(guard=GuardPolicy(...))`` degrades on a non-finite
    step (resilience.py:786).

    The step computes on the device one bitmask of the checked values
    that hold a NaN or an Inf (the grads, unless a loss scaler owns them,
    and every float output it returns); a non-zero mask discards the
    update there (params, optimizer state and program state keep their
    values from before the step) and the host records an
    :class:`Incident`. More than ``max_incidents`` incidents within the
    trailing ``window`` steps raise ``FloatingPointError``
    (``max_incidents=0``: the first one does).

    The step reads back at once only whether its update stands (one flag,
    shared with a loss scaler's skip). ``defer_readback`` (default)
    examines the bitmask (which values, the incident record, the
    escalation) one step late; ``Trainer.drain_guard()`` examines the last
    one (``fit`` does at its end). False examines it at once, so
    escalation raises at the step at fault. ``record_feed_digest`` keeps the step's feed until then, for
    the incident's crc32. A loss scaler's state is not rolled back on a
    discarded step: its backoff must stay."""

    max_incidents: int = 8
    window: int = 1000  # in optimizer steps
    record_feed_digest: bool = True
    defer_readback: bool = True


@dataclasses.dataclass
class Incident:
    """One discarded non-finite step."""

    step: int                   # global_step of the discarded update
    outputs: Tuple[str, ...]    # which checked values were non-finite
    feed_digest: Optional[str]  # crc32 of the offending batch (or None)
    wall_time: float

    def __str__(self):
        return (f"non-finite step {self.step}: {', '.join(self.outputs)}"
                + (f" (feed crc32 {self.feed_digest})" if self.feed_digest else ""))


def feed_digest(feed: Dict[str, Any], index: Optional[int] = None) -> str:
    """crc32 of a feed dict (one batch) over its names and bytes in name
    order; ``index`` selects step ``i`` of a stacked ``(K, batch, ...)``
    feed. Tensors are read back to the host (called on incidents only)."""
    import numpy as np
    import torch

    crc = 0
    for k in sorted(feed):
        v = feed[k]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            v = (v.view(torch.int16) if v.dtype == torch.bfloat16 else v).numpy()
        v = np.asarray(v)
        if index is not None and v.ndim >= 1:
            v = v[index]
        crc = zlib.crc32(k.encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(v).tobytes(), crc)
    return f"{crc & 0xFFFFFFFF:#010x}"


def escalate_if_needed(incidents: List[Incident], policy: GuardPolicy,
                       current_step: int) -> None:
    """Raise ``FloatingPointError`` when more than ``policy.max_incidents``
    incidents fall in the trailing ``policy.window`` steps up to
    ``current_step``; scans the step-ordered list from its tail."""
    recent: List[Incident] = []
    for inc in reversed(incidents):
        if inc.step <= current_step - policy.window:
            break
        if inc.step <= current_step:
            recent.append(inc)
    if len(recent) > policy.max_incidents:
        lines = "\n  ".join(str(i) for i in recent[:5])
        raise FloatingPointError(
            f"{len(recent)} non-finite steps within the last {policy.window} steps "
            f"(GuardPolicy.max_incidents={policy.max_incidents}); last incidents:"
            f"\n  {lines}")


# a long run with occasional incidents keeps a bounded log (escalation only
# reads the trailing window)
MAX_INCIDENT_LOG = 10_000


def record_incident(incidents: List[Incident], step: int, outputs: Tuple[str, ...],
                    digest: Optional[str]) -> Incident:
    inc = Incident(step=step, outputs=outputs, feed_digest=digest, wall_time=time.time())
    incidents.append(inc)
    if len(incidents) > MAX_INCIDENT_LOG:
        del incidents[:len(incidents) - MAX_INCIDENT_LOG]
    _log().warning("guard: discarded %s", inc)
    return inc


__all__ = ["CheckpointCorrupt", "CheckpointInfo", "GuardPolicy", "Incident",
           "InjectedCrash", "MANIFEST_NAME", "MANIFEST_VERSION", "MAX_INCIDENT_LOG",
           "PreemptionHandler", "ReshardError", "ResizeRequest", "TMP_MARKER",
           "crash_point", "escalate_if_needed", "feed_digest", "list_checkpoints",
           "mesh_axes", "normalize_mesh_axes", "read_manifest", "record_incident",
           "reshard_restore", "restore_latest", "sweep_tmp_dirs", "trainer_mesh_axes",
           "validate_checkpoint", "write_manifest"]
