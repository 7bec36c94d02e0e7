"""Cross-process serving fleet: out-of-process replicas over the
framed transport (counterpart of ``paddle_tpu_torch.fleet.remote``: the same
wire, byte for byte, so a router of either package drives a replica of
the other).

An in-process fleet shares one Python process and one GIL, and
``PredictorServer.kill()`` only stands in for death. This module lifts
the replica boundary onto the length-prefixed framed protocol the
async-PS path speaks (:mod:`paddle_tpu_torch.parallel.async_ps` — one
ASCII header line, binary bodies of a length named in the header, trace
tokens riding the header): each replica is a separate OS process
(:mod:`paddle_tpu_torch.fleet.replica_main`) running its own
``PredictorServer``, and the router talks to a :class:`RemoteReplica`
proxy that duck-types the ``PredictorServer`` surface
``FleetRouter`` routes over — so SIGKILL, TCP partitions, and
slow links are *real*, not injected.

Wire verbs (client → replica)::

    SUBMIT <meta_len> <payload_len> <deadline|-> trace=<span>  + body
    HEALTH | REPORT | METRICS | JOURNAL <since_seq>
    RELOAD <len> | KILL <len> | SHUTDOWN <len>                 + json

Replies: ``OK <id>`` (submit accepted), ``OK <len>`` + json (control),
``ERR <errname> <len>`` + json detail (typed errors reconstructed
client-side), and the per-request lifecycle pushed on the submit
connection — ``DISPATCHED <id>`` (written when a worker picks the
request up, BEFORE execution), then ``DONE <id> <meta_len>
<payload_len>`` + outputs or ``FAIL <id> <errname> <len>`` + detail.

**The at-most-once contract over a real wire** (the serving mirror of
``PSClient.push``): a SUBMIT is sent at most once — connection
*establishment* may retry, but once the header left the socket the
request is never resent. When the link dies before the outcome
arrives, the client classifies:

- process **provably dead** (owned child exited / fresh connect
  refused) and ``DISPATCHED`` never seen → :class:`~paddle_tpu.
  serving.ServerClosed` — the request provably never began executing
  (SIGKILL delivers bytes written before death, and the replica
  writes ``DISPATCHED`` before execution), so the router reroutes it
  transparently;
- ``DISPATCHED`` seen → :class:`~paddle_tpu_torch.serving.ReplicaDied`
  exactly once, never retried;
- **cannot prove death** (partition / half-open connection: probes
  time out, the peer may still be executing) → :class:`~paddle_tpu.
  serving.ReplicaDied` — reply lost after send, surfaced exactly
  once, never resent.

Health probes are bounded by construction (socket timeout + capped
retries with exponential backoff via :class:`~paddle_tpu_torch.parallel.
async_ps.FramedClient`), cache a *down* verdict for ``down_cooldown``
seconds (a partitioned replica must not stall every subsequent route
for a full probe timeout), and measure probe latency: a replica that
answers but slower than ``slow_after`` is marked ``slow`` — the
router demotes it below other ready replicas instead of treating
alive as healthy.

Trace tokens ride the SUBMIT header (`` trace=<span>``, same optional
trailing-token scheme as the PS wire): the span is minted at the
front door and adopted by the replica's ``PredictorServer.submit``,
so one trace id correlates both processes' journals end to end; the
``JOURNAL`` verb ships the replica's retained ring back over the same
link (``RunJournal.ingest``).

Tensors on the wire: a leaf's meta names its numpy dtype, and a
bfloat16 leaf (a torch tensor, or a ``WireSpec.cast("bfloat16")``
field) travels as its 16-bit patterns under ``"dtype": "bfloat16"``, the
bytes the JAX package's ``ml_dtypes`` arrays carry. :func:`unpack_tree`
returns numpy arrays, and a bf16 leaf without a wire spec as a bfloat16
tensor (numpy has no bfloat16 of its own). A replica process loads its
artifact onto the device its config names (the CUDA card unless it
says ``cpu``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..parallel.async_ps import (FramedClient, ReplyLost, child_python_env,
                                 read_exact, read_line)
from ..serving import (CircuitOpen, DeadlineExceeded, ReloadFailed,
                       ReplicaDied, ServerClosed, ServerOverloaded,
                       ServingError, WorkerHung)
from ..io import InvalidRequest


def _log():
    import logging
    return logging.getLogger("paddle_tpu_torch.fleet.remote")


# -- tree packing (feeds + outputs) -------------------------------------------


def _np_dtype(name: str):
    """The numpy dtype of a leaf's bytes: ``uint16`` for bfloat16."""
    from ..data.wire import _host_dtype
    return _host_dtype(name)


def _host_leaf(v) -> Tuple[np.ndarray, str]:
    """(contiguous host array, wire dtype name) of one leaf: a tensor comes
    to the host, bfloat16 as its bit patterns."""
    import torch

    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
        return a, a.dtype.name
    a = np.ascontiguousarray(np.asarray(v))
    return a, a.dtype.name


def _wire_spec(spec):
    """Normalize a ``WireSpec`` | its field dict (the JSON shape that
    rides a SUBMIT meta item) into a ``WireSpec``."""
    from ..data.wire import WireSpec

    if isinstance(spec, WireSpec):
        return spec
    if isinstance(spec, dict):
        return WireSpec(**spec)
    raise TypeError(f"feed wire spec: expected WireSpec or dict, "
                    f"got {type(spec).__name__}")


def pack_tree(obj, wire: Optional[Dict[str, Any]] = None) \
        -> Tuple[bytes, bytes]:
    """Encode a feed dict / output tree of arrays as ``(meta_json,
    payload)``: the meta names each leaf's place, shape, and dtype; the
    payload is the leaves' contiguous bytes concatenated in meta
    order. Supported shapes: dict of arrays, single array, list/tuple
    of arrays (scalars ride as 0-d arrays); a leaf may be a numpy array
    or a tensor (brought to the host).

    ``wire`` (dict-shaped feeds only) maps field names to
    :class:`~paddle_tpu_torch.data.wire.WireSpec`s: those fields cross the
    link in the narrower wire dtype (fewer bytes a SUBMIT), with the
    spec embedded in the meta item so the replica's :func:`unpack_tree`
    decodes back to the logical value — the wire schema itself is
    unchanged (same two bodies)."""
    chunks: List[bytes] = []

    def leaf(v, spec=None) -> Dict[str, Any]:
        a, dtype = _host_leaf(v)
        extra: Dict[str, Any] = {}
        if spec is not None and spec.kind != "passthrough":
            a = np.ascontiguousarray(spec.encode(a))
            dtype = spec.wire_dtype
            extra["wire"] = {
                "kind": spec.kind, "wire_dtype": spec.wire_dtype,
                "decode_dtype": spec.decode_dtype,
                "scale": spec.scale, "zero_point": spec.zero_point}
        b = a.tobytes()
        chunks.append(b)
        return {"shape": list(a.shape), "dtype": dtype,
                "nbytes": len(b), **extra}

    if isinstance(obj, dict):
        specs = {k: _wire_spec(s) for k, s in (wire or {}).items()}
        meta: Dict[str, Any] = {
            "kind": "dict",
            "items": [{"name": str(k), **leaf(obj[k], specs.get(str(k)))}
                      for k in sorted(obj, key=str)]}
    elif isinstance(obj, (list, tuple)):
        meta = {"kind": "list" if isinstance(obj, list) else "tuple",
                "items": [leaf(v) for v in obj]}
    else:
        meta = {"kind": "single", "items": [leaf(obj)]}
    return json.dumps(meta).encode(), b"".join(chunks)


def unpack_tree(meta_bytes: bytes, payload: bytes,
                counters: Optional[Dict[str, int]] = None):
    """Inverse of :func:`pack_tree`: wire-encoded items (a ``"wire"``
    spec in the meta) are decoded back to their logical dtype.
    ``counters`` (optional dict) accumulates ``wire_bytes`` (what
    actually crossed the link) and ``logical_bytes`` (what a
    passthrough transfer of the same values would have cost) — the
    replica's serving report reads them."""
    meta = json.loads(meta_bytes)
    leaves = []
    off = 0
    wire_bytes = logical_bytes = 0
    for item in meta["items"]:
        n = int(item["nbytes"])
        a = np.frombuffer(payload[off:off + n],
                          dtype=_np_dtype(item["dtype"]))
        a = a.reshape(item["shape"]).copy()
        w = item.get("wire")
        if w is not None:
            spec = _wire_spec(w)
            if spec.kind != "passthrough":
                a = spec.decode(a).numpy()
        elif item["dtype"] == "bfloat16":
            from ..data.wire import bf16_tensor
            a = bf16_tensor(a)
        wire_bytes += n
        logical_bytes += int(a.nbytes)
        leaves.append(a)
        off += n
    if counters is not None:
        counters["wire_bytes"] = counters.get("wire_bytes", 0) + wire_bytes
        counters["logical_bytes"] = (counters.get("logical_bytes", 0)
                                     + logical_bytes)
    if meta["kind"] == "dict":
        return {item["name"]: leaf
                for item, leaf in zip(meta["items"], leaves)}
    if meta["kind"] == "list":
        return leaves
    if meta["kind"] == "tuple":
        return tuple(leaves)
    return leaves[0]


# -- typed errors over the wire -----------------------------------------------

_ERROR_ATTRS = ("field", "reason", "queue_depth", "capacity", "retry_after",
                "dirname", "path")


def error_payload(e: BaseException) -> Tuple[str, Dict[str, Any]]:
    """``(errname, detail)`` for the ``ERR``/``FAIL`` frames: the class
    name plus the constructor attributes the client needs to rebuild
    the typed error."""
    detail: Dict[str, Any] = {"message": str(e)}
    for k in _ERROR_ATTRS:
        v = getattr(e, k, None)
        if v is not None:
            detail[k] = v
    return type(e).__name__, detail


def build_remote_error(name: str, detail: Dict[str, Any]) -> BaseException:
    """Rebuild a replica-side typed error from its wire payload —
    the client raises EXACTLY the class the in-process fleet would
    have, so ``FleetPending``'s reroute/at-most-once dispatch on
    exception type is wire-transparent."""
    from .. import resilience

    msg = str(detail.get("message", ""))
    if name == "InvalidRequest":
        return InvalidRequest(detail.get("field", "?"),
                              detail.get("reason", msg))
    if name == "ServerOverloaded":
        return ServerOverloaded(int(detail.get("queue_depth", 0)),
                                int(detail.get("capacity", 0)))
    if name == "CircuitOpen":
        return CircuitOpen(float(detail.get("retry_after", 0.0)))
    if name == "ReloadFailed":
        return ReloadFailed(detail.get("dirname", "?"),
                            detail.get("reason", msg))
    if name == "CheckpointCorrupt":
        return resilience.CheckpointCorrupt(detail.get("path", "?"),
                                            detail.get("reason", msg))
    cls = {"DeadlineExceeded": DeadlineExceeded, "WorkerHung": WorkerHung,
           "ServerClosed": ServerClosed, "ReplicaDied": ReplicaDied,
           "ServingError": ServingError}.get(name)
    if cls is not None:
        return cls(msg)
    return ServingError(f"{name}: {msg}")


class _ControlClient(FramedClient):
    """Control-plane client (HEALTH/REPORT/METRICS/JOURNAL and the
    one-shot RELOAD/KILL/SHUTDOWN connections): the framed reconnect-
    with-backoff machinery of :class:`FramedClient` with the replica's
    ``ERR <name> <len>`` + json-detail error frames raised typed."""

    peer_name = "fleet replica"

    def _on_err_reply(self, resp: str):
        _, name, blen = resp.split()
        body = self._read_exact(int(blen))
        raise build_remote_error(name, json.loads(body or b"{}"))

    def call(self, line: str, payload: bytes = b"",
             idempotent: bool = True, timeout: Optional[float] = None):
        """One ``OK <len>`` + json round trip."""
        _, body = self._request(line, payload, idempotent=idempotent,
                                body_len=lambda r: int(r.split()[1]),
                                timeout=timeout)
        return json.loads(body) if body else None


# -- artifact distribution ----------------------------------------------------

ARTIFACT_CHUNK = 1 << 18   # 256 KiB ARTIFACT chunk frames


def parse_hostport(addr) -> Tuple[str, int]:
    """``"host:port"`` or ``(host, port)`` → ``(host, port)``."""
    if isinstance(addr, str):
        host, _, port = addr.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"bad host address {addr!r} (want host:port)")
        return (host, int(port))
    host, port = addr
    return (str(host), int(port))


def ship_artifact(addr: Tuple[str, int], dirname: str,
                  timeout: float = 600.0,
                  chunk_bytes: int = ARTIFACT_CHUNK) -> str:
    """Stream a committed ``save_inference_model`` dir to the artifact
    store behind ``addr`` (a replica or a host agent — both speak the
    same door) and return the RECEIVER-side committed path.

    Protocol: ``FETCH`` negotiates (the manifest's file/CRC table under
    a content-addressed token — an already-committed token is a
    zero-byte no-op, and the reply's have-map resumes a torn transfer
    where it stopped), ``ARTIFACT`` frames carry per-chunk-CRC'd file
    bytes with no reply (pipelined), and a final ``FETCH commit``
    CRC-validates every staged file against the manifest before the
    receiver's atomic rename — a connection lost mid-stream leaves only
    a resumable staging dir, never a half-written artifact. Raises
    ``ConnectionError`` (connection-shaped, so the router's reload
    rollback machinery engages) when the receiver stays unreachable."""
    import zlib

    from ..io import artifact_fingerprint
    from ..resilience import MANIFEST_NAME, _crc32_file

    path = os.path.abspath(dirname)
    man, token = artifact_fingerprint(path)
    mf_crc, mf_size = _crc32_file(os.path.join(path, MANIFEST_NAME))
    # the manifest file ships verbatim like any other member, so the
    # committed copy is byte-identical to the source dir
    expected = {name: {"crc32": int(spec["crc32"]),
                       "size": int(spec["size"])}
                for name, spec in man["files"].items()}
    expected[MANIFEST_NAME] = {"crc32": mf_crc, "size": mf_size}
    negotiate = json.dumps({"token": token, "files": expected,
                            "commit": False}).encode()
    commit = json.dumps({"token": token, "commit": True}).encode()
    last_err: Optional[BaseException] = None
    for _attempt in range(3):
        cli = _ControlClient(tuple(addr), timeout=timeout, retries=2,
                             retry_backoff=0.05, connect=False)
        try:
            st = cli.call(f"FETCH {token} {len(negotiate)}", negotiate,
                          timeout=timeout)
            if st.get("complete"):
                return st["path"]
            have = dict(st.get("have") or {})
            sock = cli._sock
            for fname in sorted(expected):
                start = int(have.get(fname, 0))
                if start >= expected[fname]["size"]:
                    continue
                with open(os.path.join(path, fname), "rb") as f:
                    f.seek(start)
                    off = start
                    while True:
                        data = f.read(chunk_bytes)
                        if not data:
                            break
                        crc = zlib.crc32(data) & 0xFFFFFFFF
                        hdr = (f"ARTIFACT {token} {fname} {off} "
                               f"{len(data)} {crc:08x}\n").encode()
                        sock.sendall(hdr + data)
                        off += len(data)
            st = cli.call(f"FETCH {token} {len(commit)}", commit,
                          timeout=timeout)
            if st.get("complete"):
                return st["path"]
            # receiver rejected some staged files (corrupted in
            # flight): the next lap renegotiates and re-ships exactly
            # the files its have-map no longer covers
            last_err = ConnectionError(
                f"artifact {token} commit rejected by {addr}: "
                f"bad={st.get('bad')}")
        except (OSError, ConnectionError) as e:
            last_err = e
        finally:
            try:
                cli.close()
            except Exception:
                pass
    raise ConnectionError(
        f"could not ship artifact {dirname!r} to {addr}: {last_err}")


class ArtifactStore:
    """Receiver half of the FETCH/ARTIFACT pair: a per-host artifact
    cache keyed by content-addressed token. Chunks land in a
    ``<token>.staging`` sibling (resumable — the negotiate reply's
    have-map is just the staged sizes); commit CRC-validates every file
    against the negotiated table and renames the staging dir into place
    atomically, so the cache either holds a fully-validated artifact at
    ``<root>/<token>`` or nothing there at all. A bad chunk never
    errors the stream (ARTIFACT frames have no reply, the sender is
    pipelining): the staged file is dropped and the commit reply's
    ``bad`` list makes the sender re-ship it."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self._expected: Dict[str, Dict[str, Any]] = {}

    def _paths(self, token: str) -> Tuple[str, str]:
        if not token or "/" in token or "\\" in token or ".." in token:
            raise ValueError(f"bad artifact token {token!r}")
        return (os.path.join(self.root, token),
                os.path.join(self.root, token + ".staging"))

    @staticmethod
    def _safe_name(fname: str) -> bool:
        return bool(fname) and "/" not in fname and "\\" not in fname \
            and ".." not in fname and not fname.startswith(".")

    def handle_fetch(self, token: str, body: bytes) -> Dict[str, Any]:
        """One FETCH round trip: negotiate (``commit: false``) or
        commit (``commit: true``)."""
        req = json.loads(body or b"{}")
        final, staging = self._paths(token)
        with self._lock:
            if req.get("commit"):
                return self._commit_locked(token, final, staging)
            files = {name: spec
                     for name, spec in dict(req.get("files") or {}).items()
                     if self._safe_name(name)}
            return self._begin_locked(token, final, staging, files)

    def _begin_locked(self, token, final, staging, files):
        if os.path.isdir(final):
            return {"complete": True, "path": final}
        self._expected[token] = files
        os.makedirs(staging, exist_ok=True)
        have = {}
        for name in os.listdir(staging):
            p = os.path.join(staging, name)
            if os.path.isfile(p):
                have[name] = os.path.getsize(p)
        return {"complete": False, "have": have, "path": final}

    def handle_chunk(self, token: str, fname: str, off: int,
                     crc: int, data: bytes) -> None:
        """One ARTIFACT frame: append iff the chunk CRC matches and it
        lands exactly at the staged tail; anything else poisons the
        staged file (dropped, re-shipped after commit reports it)."""
        import zlib

        _, staging = self._paths(token)
        if not self._safe_name(fname):
            return
        with self._lock:
            if not os.path.isdir(staging):
                return    # no negotiation for this token: drop
            p = os.path.join(staging, fname)
            size = os.path.getsize(p) if os.path.exists(p) else 0
            if (zlib.crc32(data) & 0xFFFFFFFF) != crc or off != size:
                if os.path.exists(p):
                    os.unlink(p)
                return
            with open(p, "ab") as f:
                f.write(data)

    def _commit_locked(self, token, final, staging):
        from .. import resilience

        if os.path.isdir(final):
            return {"complete": True, "path": final}
        expected = self._expected.get(token)
        if expected is None or not os.path.isdir(staging):
            return {"complete": False, "bad": ["<no staging session>"],
                    "have": {}}
        bad = []
        for name, spec in expected.items():
            p = os.path.join(staging, name)
            try:
                crc, size = resilience._crc32_file(p)
            except OSError:
                bad.append(name)
                continue
            if size != int(spec["size"]) or crc != int(spec["crc32"]):
                os.unlink(p)
                bad.append(name)
        if bad:
            have = {}
            for name in expected:
                p = os.path.join(staging, name)
                if name not in bad and os.path.exists(p):
                    have[name] = os.path.getsize(p)
            return {"complete": False, "bad": sorted(bad), "have": have}
        for name in expected:
            with open(os.path.join(staging, name), "rb") as f:
                os.fsync(f.fileno())
        os.rename(staging, final)
        try:
            dfd = os.open(self.root, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass
        self._expected.pop(token, None)
        return {"complete": True, "path": final}


# -- the replica process ------------------------------------------------------


class ReplicaProcess:
    """Spawn-and-own one out-of-process replica: a child Python running
    :mod:`paddle_tpu_torch.fleet.replica_main` over a ``save_inference_model``
    artifact (config shipped as a JSON file; the golden feed as an
    npz next to it). ``wait_ready()`` blocks until the child prints
    ``PORT <n>`` — i.e. its ``PredictorServer`` is warmed and the
    listener is up — so several processes can be launched first and
    awaited together (they load and warm up concurrently)."""

    def __init__(self, dirname: str, server_kw: Optional[Dict] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 artifact_root: Optional[str] = None,
                 bind: Optional[str] = None, device=None):
        self.dirname = dirname
        self._cfg_dir = tempfile.mkdtemp(prefix="pdtorch_replica_")
        cfg = self._build_config(dirname, dict(server_kw or {}), host, port)
        # where the child loads the artifact (None: the CUDA card)
        cfg["device"] = None if device is None else str(device)
        if artifact_root:
            cfg["artifact_root"] = artifact_root
        if bind:
            cfg["bind"] = bind
        cfg_path = os.path.join(self._cfg_dir, "replica.json")
        with open(cfg_path, "w", encoding="utf-8") as f:
            json.dump(cfg, f)
        # PDTPU_TELEMETRY_ADDR is deliberately KEPT (each replica
        # process ships to the collector on its own) but the ORIGIN
        # override is not — it names ONE process, and inheriting it
        # would collapse the whole fleet onto a single origin
        env = child_python_env(pop=("PDTPU_TELEMETRY_ORIGIN",))
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.fleet.replica_main",
             cfg_path],
            stdout=subprocess.PIPE, text=True, env=env)
        self.addr: Optional[Tuple[str, int]] = None
        self._host = host

    def _build_config(self, dirname: str, kw: Dict, host: str,
                      port: int) -> Dict[str, Any]:
        bp = kw.pop("batch_policy", None)
        if bp is not None and dataclasses.is_dataclass(bp):
            bp = dataclasses.asdict(bp)
        breaker = kw.pop("breaker", None)
        if breaker is not None and dataclasses.is_dataclass(breaker):
            breaker = dataclasses.asdict(breaker)
        golden = kw.pop("golden_feed", None)
        golden_path = None
        if golden is not None:
            golden_path = os.path.join(self._cfg_dir, "golden.npz")
            np.savez(golden_path, **{k: np.asarray(v)
                                     for k, v in golden.items()})
        # anything left must be JSON-serializable (workers, queue_size,
        # deadlines, watchdog, warmup, reject_nonfinite, ...): a
        # non-serializable kwarg fails HERE, loudly, not in the child
        return {"dirname": dirname, "host": host, "port": int(port),
                "server_kw": kw, "batch_policy": bp, "breaker": breaker,
                "golden_feed": golden_path}

    @property
    def pid(self) -> int:
        return self._proc.pid

    def wait_ready(self, timeout: float = 300.0) -> Tuple[str, int]:
        """Block until the child printed ``PORT <n>``; returns the
        replica's address. Raises if the child exits first, and
        honors ``timeout`` even when the child hangs without printing
        anything (the pipe is select()ed, never blocking-read past
        the deadline)."""
        import select

        if self.addr is not None:
            return self.addr
        deadline = time.monotonic() + timeout
        line = ""
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            ready, _, _ = select.select([self._proc.stdout], [], [],
                                        min(remaining, 1.0))
            if not ready:
                continue
            line = self._proc.stdout.readline()
            if not line:
                rc = self._proc.poll()
                raise RuntimeError(
                    f"replica process exited (rc={rc}) before reporting "
                    "its port — see its stderr above")
            line = line.strip()
            if line.startswith("PORT "):
                self.addr = (self._host, int(line.split()[1]))
                return self.addr
        raise TimeoutError(
            f"replica process did not report a port within {timeout}s "
            f"(last line: {line!r})")

    def poll(self) -> Optional[int]:
        return self._proc.poll()

    def wait(self, timeout: Optional[float] = None) -> int:
        return self._proc.wait(timeout)

    def kill(self) -> None:
        """SIGKILL, no cleanup — the real process-death injector."""
        if self._proc.poll() is None:
            self._proc.kill()

    def stop(self) -> None:
        self.kill()
        try:
            self._proc.wait(timeout=5.0)
        except Exception:
            pass
        if self._proc.stdout is not None:
            self._proc.stdout.close()
        shutil.rmtree(self._cfg_dir, ignore_errors=True)

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


# -- the client-side proxy ----------------------------------------------------


class RemotePending:
    """Client half of one in-flight remote request: owns the SUBMIT
    connection and reads the pushed lifecycle (``DISPATCHED`` →
    ``DONE``/``FAIL``). Duck-types :class:`~paddle_tpu_torch.serving.
    PendingResult` for :class:`~paddle_tpu_torch.fleet.FleetPending`. A lost
    connection is classified per the module contract: never-dispatched
    on a provably dead process → ``ServerClosed`` (the router
    reroutes), anything else → ``ReplicaDied`` exactly once."""

    def __init__(self, replica: "RemoteReplica", sock: socket.socket,
                 rid: str, span: str):
        self._replica = replica
        self._sock: Optional[socket.socket] = sock
        self.rid = rid
        self._span = span
        self._lock = threading.Lock()
        # monotonic bool (False -> True once, under _lock): _classify's
        # lock-free read can only be STALE-False, which classifies a
        # lost connection conservatively (ReplicaDied, never resent)
        self.dispatched = False   # lint: allow(thread:unguarded-access)
        self._done = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None
        self._submitted = time.monotonic()
        self._completed: Optional[float] = None
        self._last_activity = time.monotonic()
        # receive buffer: a poll timeout mid-line must PRESERVE the
        # bytes already read — discarding them would desync the framed
        # stream (the next pump would parse a half header)
        self._rbuf = bytearray()

    @property
    def span(self) -> Optional[str]:
        return self._span

    @property
    def latency(self) -> Optional[float]:
        return (None if self._completed is None
                else self._completed - self._submitted)

    def done(self) -> bool:
        if not self._done.is_set():
            self._pump(0.0)
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        bound = None if timeout is None else time.monotonic() + timeout
        while not self._done.is_set():
            if bound is not None:
                remaining = bound - time.monotonic()
                if remaining <= 0:
                    raise DeadlineExceeded(
                        f"no remote result within {timeout:.2f}s (request "
                        f"{self.rid} still queued or executing on "
                        f"{self._replica.addr})")
                self._pump(min(0.25, remaining))
            else:
                self._pump(0.25)
        if self._error is not None:
            raise self._error
        return self._value

    def _recv_line(self) -> str:
        """One header line from the buffered stream; a socket timeout
        propagates with the partial bytes KEPT in the buffer."""
        while True:
            i = self._rbuf.find(b"\n")
            if i >= 0:
                line = self._rbuf[:i].decode()
                del self._rbuf[:i + 1]
                return line
            chunk = self._sock.recv(4096)
            if not chunk:
                raise ConnectionError("replica closed connection")
            self._rbuf += chunk

    def _recv_exact(self, n: int) -> bytes:
        """``n`` framed body bytes, buffer first."""
        while len(self._rbuf) < n:
            chunk = self._sock.recv(max(4096, n - len(self._rbuf)))
            if not chunk:
                raise ConnectionError("replica closed connection")
            self._rbuf += chunk
        out = bytes(self._rbuf[:n])
        del self._rbuf[:n]
        return out

    def _pump(self, timeout: float) -> None:
        """Read lifecycle messages off the submit connection for up to
        ``timeout`` seconds (0 = one non-blocking peek)."""
        with self._lock:
            if self._done.is_set() or self._sock is None:
                return
            try:
                self._sock.settimeout(max(timeout, 1e-3))
                line = self._recv_line()
            except socket.timeout:
                self._check_stall()
                return
            except (OSError, ConnectionError) as e:
                self._classify(e)
                return
            self._last_activity = time.monotonic()
            try:
                parts = line.split()
                if parts[0] == "DISPATCHED":
                    self.dispatched = True
                    return
                # DONE/FAIL carry a framed body: a short pump timeout
                # must not tear mid-body — the body follows the header
                # immediately, so a generous bound is safe
                self._sock.settimeout(30.0)
                if parts[0] == "DONE":
                    meta = self._recv_exact(int(parts[2]))
                    payload = self._recv_exact(int(parts[3]))
                    self._complete(value=unpack_tree(meta, payload))
                elif parts[0] == "FAIL":
                    body = self._recv_exact(int(parts[3]))
                    self._complete(error=build_remote_error(
                        parts[2], json.loads(body or b"{}")))
                else:
                    self._complete(error=ServingError(
                        f"replica protocol error: unexpected {line!r}"))
            except (OSError, ConnectionError) as e:
                self._classify(e)
            except (ValueError, IndexError, KeyError,
                    UnicodeDecodeError) as e:
                # a corrupt/unparseable frame is a typed outcome, not
                # an exception leaking out of result() with the socket
                # stuck mid-frame
                self._complete(error=ServingError(
                    f"replica protocol error parsing {line!r}: "
                    f"{type(e).__name__}: {e}"))

    def _check_stall(self) -> None:
        """The lifecycle socket has been silent past the stall bound
        (``submit_timeout`` since the last byte): a partitioned link
        looks exactly like a slow dispatch from here — no error ever
        arrives, the sends all succeeded into kernel buffers. Resolve
        the ambiguity with a bounded health probe of the replica: a
        probe that answers (and is live) means the request is
        genuinely slow/queued — reset the clock and keep waiting; an
        unreachable or stopped replica means this connection is as
        good as dead — classify at-most-once (the half-open case the
        drill pins: surfaced once, never resent, never left hanging
        until the caller's deadline)."""
        if time.monotonic() - self._last_activity <= \
                self._replica.submit_timeout:
            return
        try:
            h = self._replica.health()
        except Exception as e:
            self._classify(ConnectionError(
                f"no lifecycle bytes for "
                f"{time.monotonic() - self._last_activity:.1f}s and the "
                f"replica is unreachable ({e})"))
            return
        if not h.get("live"):
            self._classify(ConnectionError(
                f"replica no longer live ({h.get('state')}) with this "
                "request outstanding"))
            return
        self._last_activity = time.monotonic()

    def _classify(self, cause: Exception) -> None:
        """Connection lost before the outcome arrived — the wire
        re-proof of the in-process kill() contract (see module
        docstring)."""
        if self._replica._provably_dead() and not self.dispatched:
            err: BaseException = ServerClosed(
                f"replica process at {self._replica.addr} died with this "
                f"request accepted but never dispatched ({cause}); safe "
                "to resubmit")
        else:
            err = ReplicaDied(
                f"connection to replica at {self._replica.addr} lost "
                f"{'after' if self.dispatched else 'with'} this request "
                f"{'dispatched' if self.dispatched else 'in an unknown state'}"
                f" ({cause}); at-most-once — surfaced once, never resent")
        self._complete(error=err)

    def _complete(self, value=None,
                  error: Optional[BaseException] = None) -> None:
        self._value = value
        self._error = error
        self._completed = time.monotonic()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self._done.set()


class RemoteReplica:
    """Client-side proxy over one out-of-process replica, duck-typing
    the ``PredictorServer`` surface :class:`~paddle_tpu_torch.fleet.
    FleetRouter` supervises: ``submit``/``health``/``kill``/``reload``/
    ``close``/``report``/``telemetry_families``/``repin_compiles``/
    ``generation``. Control verbs ride one persistent framed
    connection (bounded timeout + capped exponential-backoff retries);
    each SUBMIT gets its own connection that carries that request's
    pushed lifecycle; RELOAD/KILL/SHUTDOWN use one-shot connections so
    a long reload never blocks a health probe.

    Probe discipline: ``probe_timeout`` bounds one HEALTH round trip,
    a failed probe caches a *down* verdict for ``down_cooldown``
    seconds (routing stays responsive during a partition), a
    successful one is cached for ``health_ttl`` (the per-submit
    routing scan costs at most one round trip per TTL), and a probe
    slower than ``slow_after`` marks the replica ``slow`` for the
    router's probe-latency demotion."""

    # every probe is bounded at the socket (timeout + capped retries +
    # down-verdict cache): the router reads this and probes INLINE
    # instead of paying a bounding thread per health check
    probe_bounded = True

    def __init__(self, addr: Tuple[str, int],
                 proc: Optional[ReplicaProcess] = None,
                 name: Optional[str] = None,
                 num_workers: int = 2,
                 probe_timeout: float = 1.0,
                 probe_retries: int = 2,
                 probe_backoff: float = 0.05,
                 down_cooldown: float = 1.0,
                 health_ttl: float = 0.05,
                 slow_after: Optional[float] = None,
                 submit_timeout: float = 30.0,
                 connect_timeout: float = 1.0,
                 reload_timeout: float = 600.0,
                 agent: Optional["AgentClient"] = None,
                 pid: Optional[int] = None,
                 ship_artifacts: bool = False,
                 feed_wire: Optional[Dict[str, Any]] = None):
        self.addr = tuple(addr)
        self.proc = proc
        self.name = name
        # cross-host adoption: `agent` is the per-host launcher that
        # owns the replica process (the waitpid oracle a proxied link
        # can't be), `pid` its pid THERE, `ship_artifacts` makes
        # reload() stream the dir over FETCH/ARTIFACT first (the
        # replica's filesystem has never seen the router's paths), and
        # `feed_wire` ({field: WireSpec}) narrows SUBMIT payloads
        self.agent = agent
        self.pid = pid if pid is not None else \
            (proc.pid if proc is not None else None)
        self.ship_artifacts = bool(ship_artifacts)
        self.feed_wire = ({k: _wire_spec(s) for k, s in feed_wire.items()}
                          if feed_wire else None)
        self.num_workers = int(num_workers)
        self.probe_timeout = probe_timeout
        self.down_cooldown = down_cooldown
        self.health_ttl = health_ttl
        self.slow_after = slow_after
        self.submit_timeout = submit_timeout
        self.connect_timeout = connect_timeout
        self.reload_timeout = reload_timeout
        self._ctl = _ControlClient(self.addr, timeout=probe_timeout,
                                   retries=max(1, int(probe_retries)),
                                   retry_backoff=probe_backoff,
                                   connect=False)
        self._ctl_lock = threading.Lock()
        self._health_lock = threading.Lock()
        self._health_cache: Optional[Dict[str, Any]] = None
        self._health_time = 0.0
        self._down_until = 0.0
        self._down_error = ""
        self._killed = False

    @property
    def journal(self):
        # resolved per use, not cached at construction: the process
        # journal can be swapped (tests, re-rooted sinks) after a
        # long-lived proxy was built
        from ..telemetry import get_journal
        return get_journal()

    # -- liveness ------------------------------------------------------------

    def _provably_dead(self) -> bool:
        """True only when the replica PROCESS is known dead — an owned
        child that exited, a host agent reporting its pid reaped, or a
        fresh probe refused/EOF'd. A timeout (a partition, a half-open
        link) proves nothing and returns False.

        Across a PROXIED link (testing/faults.LinkProxy, or any real
        LB) "connect succeeded" means nothing — the proxy always
        accepts — and "connect refused" never happens. Two proofs
        replace waitpid there: (a) the replica's host agent IS a
        waitpid oracle for children it spawned; (b) probe-EOF — a
        fresh connection that accepts a probe and then closes cleanly
        before a single reply byte is a proxy whose backend connect
        was refused (LinkProxy and real proxies both do this), i.e.
        nothing is listening where the process was. A partitioned
        link times out instead of EOF'ing, so it still proves
        nothing."""
        if self._killed:
            return True
        if self.proc is not None:
            try:
                self.proc.wait(timeout=0.25)
                return True
            except Exception:
                return False
        if self.agent is not None and self.pid is not None:
            try:
                procs = {int(p.get("pid", -1)): p
                         for p in self.agent.ps().get("procs", [])}
                p = procs.get(int(self.pid))
                # untracked => the agent reaped it; tracked+exited =>
                # dead; tracked+alive => provably NOT dead
                return p is None or not p.get("alive", False)
            except Exception:
                pass   # agent unreachable (whole-host kill): probe below
        try:
            s = socket.create_connection(self.addr,
                                         timeout=self.probe_timeout)
        except ConnectionRefusedError:
            return True
        except OSError:
            return False
        try:
            s.settimeout(self.probe_timeout)
            probe = b"HEALTH\n"
            s.sendall(probe)
            first = s.recv(1)
            return not first   # orderly EOF before any reply byte
        except OSError:
            return False       # timeout/reset: cannot prove death
        finally:
            try:
                s.close()
            except OSError:
                pass

    # -- health --------------------------------------------------------------

    def health(self) -> Dict[str, Any]:
        """One bounded wire probe (cached per the probe discipline).
        Raises ``ConnectionError`` when the replica is unreachable —
        the router maps that to *unavailable* and keeps routing."""
        if self._killed:
            return {"live": False, "ready": False, "state": "stopped",
                    "queue_depth": 0, "workers_busy": 0, "workers": 0}
        now = time.monotonic()
        with self._health_lock:
            if now < self._down_until:
                raise ConnectionError(
                    f"replica at {self.addr} marked down for another "
                    f"{self._down_until - now:.2f}s ({self._down_error})")
            if self._health_cache is not None and \
                    now - self._health_time < self.health_ttl:
                return dict(self._health_cache)
        t0 = time.monotonic()
        try:
            with self._ctl_lock:
                h = self._ctl.call("HEALTH", timeout=self.probe_timeout)
        except (ReplyLost, ConnectionError, OSError) as e:
            with self._health_lock:
                self._down_until = time.monotonic() + self.down_cooldown
                self._down_error = f"{type(e).__name__}: {e}"[:200]
                self._health_cache = None
            raise ConnectionError(
                f"health probe to {self.addr} failed: {e}") from e
        lat = time.monotonic() - t0
        h["probe_latency_s"] = round(lat, 6)
        h["slow"] = bool(self.slow_after is not None and
                         lat > self.slow_after)
        with self._health_lock:
            self._health_cache = dict(h)
            self._health_time = time.monotonic()
            self._down_until = 0.0
        return h

    @property
    def generation(self) -> int:
        return int(self.health().get("generation", 0))

    # -- request path --------------------------------------------------------

    def submit(self, feed: Dict[str, Any],
               deadline: Optional[float] = None) -> RemotePending:
        """Ship one request over the wire. The span is minted HERE (the
        front door) and rides the header's trace token, so the replica
        journals the same trace id. Never resends: a reply lost after
        the header left the socket is classified at-most-once."""
        span = self.journal.new_span()
        meta, payload = pack_tree(feed, wire=self.feed_wire)
        dl = "-" if deadline is None else repr(float(deadline))
        # retry: at-most-once
        header = (f"SUBMIT {len(meta)} {len(payload)} {dl} "
                  f"trace={span}").encode() + b"\n"
        budget = self.connect_timeout
        if deadline is not None:
            budget = max(1e-3, min(budget, deadline))
        try:
            sock = socket.create_connection(self.addr, timeout=budget)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError as e:
            raise ServerClosed(
                f"replica at {self.addr} unreachable at submit "
                f"({e}); nothing was sent") from e
        self.journal.emit("fleet.remote_submit", span=span,
                          replica=self.name or f"{self.addr[0]}:"
                                               f"{self.addr[1]}",
                          deadline_s=deadline)
        sent = False
        try:
            sock.settimeout(self.submit_timeout if deadline is None
                            else min(self.submit_timeout, deadline + 1.0))
            sock.sendall(header + meta + payload)
            sent = True
            resp = read_line(sock)
            parts = resp.split()
            if parts[0] == "ERR":
                body = read_exact(sock, int(parts[2]))
                sock.close()
                raise build_remote_error(parts[1],
                                         json.loads(body or b"{}"))
            return RemotePending(self, sock, parts[1], span)
        except (OSError, ConnectionError) as e:
            try:
                sock.close()
            except OSError:
                pass
            if not sent:
                raise ServerClosed(
                    f"could not send to replica at {self.addr} ({e}); "
                    "nothing was sent") from e
            if self._provably_dead():
                # the process died with the submit un-acked: whatever
                # it did died unobserved with it — safe to reroute
                raise ServerClosed(
                    f"replica process at {self.addr} died before "
                    f"acknowledging the submit ({e}); safe to "
                    "resubmit") from e
            raise ReplicaDied(
                f"submit reply from {self.addr} lost after send ({e}); "
                "at-most-once — the request may be executing, surfaced "
                "once, never resent") from e

    def run(self, feed: Dict[str, Any], timeout: Optional[float] = None):
        return self.submit(feed, deadline=timeout).result(timeout)

    # -- control plane -------------------------------------------------------

    def _one_shot(self, line: str, payload: bytes,
                  timeout: float, idempotent: bool = False):
        """A control call on its OWN connection (RELOAD may run for
        minutes; health probes on the persistent connection must not
        queue behind it)."""
        cli = _ControlClient(self.addr, timeout=timeout, retries=2,
                             retry_backoff=0.05, connect=False)
        try:
            return cli.call(line, payload, idempotent=idempotent,
                            timeout=timeout)
        finally:
            cli.close()

    def reload(self, dirname: str, block: bool = True):
        """Hot reload the replica's served artifact (``dirname`` must
        be reachable from the replica process — same host or shared
        filesystem). Typed failures (``ReloadFailed``,
        ``CheckpointCorrupt``) re-raise exactly; a reply lost after
        send raises :class:`~paddle_tpu_torch.parallel.async_ps.ReplyLost`
        (a ``ConnectionError``) — the replica MAY have swapped, which
        the router's rollback treats as swapped-unknown.

        With ``ship_artifacts`` the dir is streamed over
        FETCH/ARTIFACT first (content-addressed: an artifact the
        replica's host already holds is a zero-byte negotiation) and
        RELOAD points at the replica-side committed copy; a mid-ship
        partition raises connection-shaped errors, which the router's
        canary/rollback machinery converts to a typed ``ReloadFailed``
        — and the receiver's atomic commit means there is never a
        half-written artifact dir to roll back."""
        try:
            if self.ship_artifacts:
                dirname = ship_artifact(self.addr, dirname,
                                        timeout=self.reload_timeout)
            body = json.dumps({"dirname": dirname}).encode()
            return self._one_shot(f"RELOAD {len(body)}", body,
                                  timeout=self.reload_timeout)
        finally:
            # success bumped the generation; a lost reply left it
            # UNKNOWN; a failed artifact ship means the link itself is
            # suspect — in every case the cached health snapshot is
            # stale (and a router rollback's next probe must be real,
            # else a long health_ttl keeps routing to a replica whose
            # wire just proved unreachable)
            with self._health_lock:
                self._health_cache = None

    def kill(self, reason: str = "replica killed") -> None:
        """Terminate the replica process (the remote analog of
        ``PredictorServer.kill``): best-effort KILL verb (the replica
        fails in-flight work with the typed at-most-once outcomes and
        exits), then SIGKILL of the owned child. Idempotent."""
        if self._killed:
            return
        self._killed = True
        body = json.dumps({"reason": reason}).encode()
        try:
            self._one_shot(f"KILL {len(body)}", body, timeout=2.0)
        except Exception:
            pass
        if self.proc is not None:
            self.proc.stop()
        if self.agent is not None and self.pid is not None:
            try:
                self.agent.stop(self.pid)
            except Exception:
                pass

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Graceful shutdown: the replica drains (or fails queued work
        typed) and exits; the owned child is reaped, SIGKILL as the
        backstop."""
        if self._killed:
            return
        body = json.dumps({"drain": bool(drain),
                           "timeout": timeout}).encode()
        try:
            self._one_shot(f"SHUTDOWN {len(body)}", body,
                           timeout=(timeout or 30.0) + 15.0)
        except Exception:
            pass
        self._killed = True
        if self.proc is not None:
            try:
                self.proc.wait(timeout=10.0)
            except Exception:
                self.proc.stop()
        if self.agent is not None and self.pid is not None:
            try:
                self.agent.stop(self.pid)
            except Exception:
                pass
        self._ctl.close()

    # -- observability -------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        with self._ctl_lock:
            return self._ctl.call("REPORT", timeout=self.probe_timeout * 5)

    def telemetry_families(self):
        """The replica's full registry export, shipped as a snapshot
        over the control link and rebuilt as families — what the
        router's ``merge_exports`` aggregation consumes, exactly as it
        would an in-process replica's."""
        from ..telemetry.registry import families_from_snapshot

        with self._ctl_lock:
            snap = self._ctl.call("METRICS", timeout=self.probe_timeout * 5)
        return families_from_snapshot(snap or {})

    def journal_events(self, since_seq: int = 0) -> List[Dict[str, Any]]:
        """The replica's retained journal ring (events with ``seq`` >
        ``since_seq``) — the pull half of off-host span shipping; feed
        it to ``RunJournal.ingest`` (``FleetRouter.ship_journals`` does
        both ends)."""
        with self._ctl_lock:
            out = self._ctl.call(f"JOURNAL {int(since_seq)}",
                                 timeout=self.probe_timeout * 5)
        return list((out or {}).get("events", []))

    def repin_compiles(self) -> None:
        """No-op: the preparation counter is per-process, and a fleet
        sibling's load happens in a DIFFERENT process — nothing to
        re-pin here (the in-process hazard this guards against cannot
        occur across a process boundary)."""

    def __repr__(self) -> str:
        return (f"RemoteReplica({self.addr[0]}:{self.addr[1]}, "
                f"pid={self.pid if self.pid is not None else '?'})")


# -- the per-host agent, client side ------------------------------------------


def encode_server_kw(kw: Dict[str, Any]) -> Dict[str, Any]:
    """JSON-safe ``server_kw`` for the SPAWN body: dataclass policies
    become dicts and the golden feed rides as base64 npz bytes — the
    agent's host has no shared filesystem to read an npz path from."""
    import base64
    import io as _io

    kw = dict(kw)
    for key in ("batch_policy", "breaker"):
        v = kw.get(key)
        if v is not None and dataclasses.is_dataclass(v):
            kw[key] = dataclasses.asdict(v)
    golden = kw.pop("golden_feed", None)
    if golden is not None:
        buf = _io.BytesIO()
        np.savez(buf, **{k: np.asarray(v) for k, v in golden.items()})
        kw["golden_feed_npz"] = base64.b64encode(buf.getvalue()).decode()
    return kw


class AgentClient:
    """Client for one per-host fleet agent (``python -m
    paddle_tpu_torch.fleet.agent``): SPAWN/STOP/PS over the framed wire plus
    the same FETCH/ARTIFACT artifact door every replica has — ship an
    artifact to a host once, spawn any number of replicas over it.
    ``ps()`` doubles as the death oracle :meth:`RemoteReplica.
    _provably_dead` consults for agent-managed replicas."""

    def __init__(self, addr, timeout: float = 30.0):
        self.addr = parse_hostport(addr)
        self._timeout = timeout
        self._cli = _ControlClient(self.addr, timeout=timeout, retries=3,
                                   retry_backoff=0.05, connect=False)
        self._lock = threading.Lock()

    def ship(self, dirname: str, timeout: Optional[float] = None) -> str:
        """Push an artifact into the agent's host cache; returns the
        host-side committed path (a no-op when the token is cached)."""
        return ship_artifact(self.addr, dirname,
                             timeout=timeout or max(self._timeout, 600.0))

    def spawn(self, dirname: str, server_kw: Optional[Dict] = None,
              name: Optional[str] = None,
              timeout: float = 600.0, device=None) -> Dict[str, Any]:
        """Launch one replica process over a HOST-side artifact dir
        (usually a :meth:`ship` result); blocks until its listener is
        up. At-most-once: a spawn is never blindly resent — a lost
        reply surfaces (the orphan, if any, is visible in ``ps()``)."""
        req = {"dirname": dirname, "name": name,
               "server_kw": encode_server_kw(dict(server_kw or {}))}
        if device is not None:
            req["device"] = str(device)
        body = json.dumps(req).encode()
        with self._lock:
            return self._cli.call(f"SPAWN {len(body)}", body,
                                  idempotent=False, timeout=timeout)

    def stop(self, pid: int) -> Dict[str, Any]:
        body = json.dumps({"pid": int(pid)}).encode()
        with self._lock:
            return self._cli.call(f"STOP {len(body)}", body,
                                  timeout=self._timeout)

    def ps(self) -> Dict[str, Any]:
        with self._lock:
            return self._cli.call("PS", timeout=self._timeout)

    def close(self) -> None:
        try:
            self._cli.close()
        except Exception:
            pass

    def __repr__(self) -> str:
        return f"AgentClient({self.addr[0]}:{self.addr[1]})"


def adopt_replica(agent: AgentClient, dirname: str, name: str,
                  remote_kw: Optional[Dict[str, Any]] = None,
                  link=None, device=None, **server_kw) -> RemoteReplica:
    """Ship ``dirname`` into ``agent``'s host cache (content-addressed
    no-op when already there), SPAWN a replica over the host-side
    copy, and wrap it in a :class:`RemoteReplica` that uses the agent
    as its death oracle and ships artifacts on reload. ``link``
    optionally maps the replica's advertised addr (tests route every
    cross-"host" connection through a ``LinkProxy``)."""
    path = agent.ship(dirname)
    info = agent.spawn(path, server_kw=server_kw, name=name, device=device)
    addr = (str(info["addr"][0]), int(info["addr"][1]))
    if link is not None:
        addr = tuple(link(addr))
    kw = dict(remote_kw or {})
    kw.setdefault("name", name)
    return RemoteReplica(addr, proc=None, agent=agent,
                         pid=int(info["pid"]), ship_artifacts=True,
                         num_workers=int(server_kw.get("workers", 2)),
                         **kw)


def spawn_host_fleet(dirname: str, hosts, replicas: int = 2,
                     remote_kw: Optional[Dict[str, Any]] = None,
                     link=None, device=None, **server_kw):
    """Adopt ``replicas`` agent-managed replicas round-robin across
    ``hosts`` (each a ``host:port`` fleet agent). Returns ``(agents,
    {name: RemoteReplica})`` — the router keeps the agents for
    ``replace()`` respawns after a host dies."""
    agents = [a if isinstance(a, AgentClient) else AgentClient(a)
              for a in hosts]
    out: Dict[str, RemoteReplica] = {}
    try:
        for i in range(int(replicas)):
            out[f"r{i}"] = adopt_replica(
                agents[i % len(agents)], dirname, f"r{i}",
                remote_kw=remote_kw, link=link, device=device, **server_kw)
    except BaseException:
        for rep in out.values():
            try:
                rep.kill()
            except Exception:
                pass
        for a in agents:
            a.close()
        raise
    return agents, out


# -- spawning -----------------------------------------------------------------


def spawn_replica(dirname: str, remote_kw: Optional[Dict[str, Any]] = None,
                  device=None, **server_kw) -> RemoteReplica:
    """Launch ONE out-of-process replica over ``dirname`` and return
    its ready proxy. ``server_kw`` is the ``PredictorServer`` config
    (workers, queue_size, batch_policy, golden_feed, ...) shipped to
    the child; ``remote_kw`` tunes the client proxy (probe_timeout,
    slow_after, submit_timeout, ...); ``device`` is where the child loads
    the artifact (the CUDA card by default)."""
    proc = ReplicaProcess(dirname, server_kw=server_kw, device=device)
    proc.wait_ready()
    return RemoteReplica(proc.addr, proc=proc,
                         num_workers=int(server_kw.get("workers", 2)),
                         **(remote_kw or {}))


def spawn_fleet(dirname: str, replicas: int = 2,
                remote_kw: Optional[Dict[str, Any]] = None,
                device=None, **server_kw) -> Dict[str, RemoteReplica]:
    """Launch N replica processes CONCURRENTLY (each pays its own
    artifact load + per-bucket warm-up; starting them all before
    awaiting any overlaps that; on the card each loads the kernels the
    parent built, from ``paddle_tpu_torch/_build``) and return ``{name: RemoteReplica}``
    for ``FleetRouter`` adoption."""
    procs = [ReplicaProcess(dirname, server_kw=server_kw, device=device)
             for _ in range(int(replicas))]
    out: Dict[str, RemoteReplica] = {}
    try:
        for i, proc in enumerate(procs):
            proc.wait_ready()
            out[f"r{i}"] = RemoteReplica(
                proc.addr, proc=proc, name=f"r{i}",
                num_workers=int(server_kw.get("workers", 2)),
                **(remote_kw or {}))
    except BaseException:
        for proc in procs:
            proc.stop()
        raise
    return out


__all__ = [
    "AgentClient", "ArtifactStore", "RemotePending", "RemoteReplica",
    "ReplicaProcess", "adopt_replica", "build_remote_error",
    "encode_server_kw", "error_payload", "pack_tree", "parse_hostport",
    "ship_artifact", "spawn_fleet", "spawn_host_fleet", "spawn_replica",
    "unpack_tree",
]
