"""Asynchronous parameter-server training (counterpart of
``paddle_tpu.parallel.async_ps``): the client and server manager for the
C++ pserver (``native/pserver.cc``, a copy of the JAX package's source).

Trainers compute gradients locally and push them to a parameter server
without barriers; the server applies the optimizer update to each
gradient as it arrives (SGD or Adagrad, optionally with DC-ASGD's delay
compensation ``g + lambda * g*g*(w - w_bak[trainer])``, ``w_bak`` the
value this trainer saw at its last pull); trainers pull fresh params on
their own schedule.

The division of labor is the JAX package's: the trainer's part is ONLY
the gradient, the program's forward and backward on the trainer's device
through ``torch.autograd`` (where the JAX package runs
``jax.value_and_grad`` under ``jax.jit``); the optimizer state lives on
the server. Every request is the JAX client's byte for byte, so either
package's trainers may share one server.

Typical use (one server process, N trainer processes)::

    srv = PServerProcess(lr=0.05, optimizer="sgd")      # once
    t = AsyncPSTrainer(prog, srv.addr, trainer_id=k)    # per trainer, on the card
    t.startup(sample_feed=batch)
    for batch in data:
        out = t.step(batch)                              # push-grad, no barrier

Sharded servers with elastic membership (pass a server LIST: params route
by rendezvous hash through :class:`PSShardGroup`; ``resize`` rides a
split or merge mid-run with the full optimizer state migrated)::

    t = AsyncPSTrainer(prog, [srv1.addr, srv2.addr])
    ...
    t.client.resize([srv1.addr, srv2.addr, srv3.addr])   # shard split

Telemetry as in the JAX package: one journal span a step rides every pull
and push of the step on the wire; the trainer journals ``ps.step`` and
``ps.push_lost``, and publishes ``report()``'s counters through a
scrape-time registry collector (``paddle_tpu_ps_*``).
"""

from __future__ import annotations

import functools
import logging
import socket
import subprocess
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import get_flag
from ..core.errors import EnforceError, enforce
from ..core.place import default_device
from ..framework import Program, RngStream
from ..initializer import mix_seed
from ..native import build_native


def _build_server() -> str:
    return build_native("pserver.cc", "pserver_server")


class PServerProcess:
    """Spawn and own a pserver_server process built from the port's copy of
    ``pserver.cc`` (the listen_and_serv runtime analog; one per param shard
    group in a real deployment)."""

    def __init__(self, port: int = 0, lr: float = 0.01,
                 optimizer: str = "sgd", dc_asgd: bool = False,
                 dc_lambda: float = 1.0, snapshot_path: Optional[str] = None):
        enforce(optimizer in ("sgd", "adagrad"),
                f"pserver optimizer must be sgd|adagrad, got {optimizer}")
        binpath = _build_server()
        self._proc = subprocess.Popen(
            [binpath, str(port), repr(float(lr)), optimizer,
             "1" if dc_asgd else "0", repr(float(dc_lambda)),
             snapshot_path or "-"],
            stdout=subprocess.PIPE, text=True)
        line = self._proc.stdout.readline().strip()
        if not line.startswith("PORT "):
            self.stop()
            raise RuntimeError(f"pserver_server failed to start: {line!r}")
        self.port = int(line.split()[1])
        self.addr = ("127.0.0.1", self.port)

    def stop(self):
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()
        if self._proc.stdout is not None:
            self._proc.stdout.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


class ReplyLost(ConnectionError):
    """A NON-idempotent request was SENT but the connection died before
    the peer's reply arrived: the request may or may not have applied
    remotely. The client reconnects for later requests but never RESENDS
    this one: at-most-once semantics (a resend could double-apply)."""


class PushUndelivered(ReplyLost):
    """A push was SENT but the connection died before the server's reply
    arrived: the update may or may not have applied server-side. The
    client reconnects for later requests but never RESENDS the push (a
    resend could double-apply the gradient; losing one is ordinary
    async-SGD staleness)."""


def child_python_env(pop: Sequence[str] = ()) -> Dict[str, str]:
    """Environment for spawning a python child that must import this
    package: the parent's env with ``sys.path`` folded into
    ``PYTHONPATH`` (the child resolves ``paddle_tpu_torch`` exactly as the
    parent did), minus the ``pop``'d variables (a spawned collector must
    not inherit the address it ships to, nor a replica its parent's
    telemetry origin). Shared by every framed-wire process spawner."""
    import os
    import sys

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [p for p in sys.path if p] +
        [env[k] for k in ("PYTHONPATH",) if env.get(k)])
    for k in pop:
        env.pop(k, None)
    return env


def read_line(sock: socket.socket) -> str:
    """Read one ``\\n``-terminated ASCII header line off a framed-protocol
    socket (the pserver and fleet-replica wire discipline)."""
    buf = bytearray()
    while True:
        c = sock.recv(1)
        if not c:
            raise ConnectionError("peer closed connection")
        if c == b"\n":
            return buf.decode()
        buf += c


def read_exact(sock: socket.socket, n: int) -> bytearray:
    """Read exactly ``n`` bytes (a framed body) into one preallocated buffer
    (``recv_into``: a 100 MB body is received without re-copying what
    came before), or raise ``ConnectionError`` on EOF mid-frame."""
    out = bytearray(n)
    view = memoryview(out)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("peer closed connection")
        got += k
    return out


def _f32_bytes(value) -> memoryview:
    """``value`` as the f32 bytes the wire carries, without a copy when it
    is already a contiguous f32 array."""
    return memoryview(np.ascontiguousarray(value, dtype=np.float32).reshape(-1)).cast("B")


class FramedClient:
    """Transport base for the length-prefixed framed protocols (the
    ``native/pserver.cc`` verbs, the fleet replica wire): one ASCII header
    line, an optional binary body of a length named in the header, and a
    reply of the same shape.

    **Reconnect with backoff:** a dead connection or restarted peer is
    retried transparently with exponential backoff for IDEMPOTENT
    requests. Non-idempotent requests are sent at most once: connection
    establishment still retries, but a reply lost after a completed send
    raises :class:`ReplyLost` (subclasses override :meth:`_make_reply_lost`
    for a typed error; ``PSClient`` raises :class:`PushUndelivered`)
    instead of resending.

    ``bytes_sent`` and ``bytes_received`` count the protocol's bytes each
    way (headers and bodies)."""

    peer_name = "peer"

    def __init__(self, addr: Tuple[str, int],
                 timeout: float = 30.0, retries: int = 30,
                 retry_backoff: float = 0.05, retry_backoff_max: float = 2.0,
                 connect: bool = True):
        self.addr = tuple(addr)
        self.timeout = timeout
        self.retries = max(1, int(retries))
        self.retry_backoff = retry_backoff
        self.retry_backoff_max = retry_backoff_max
        self._sock: Optional[socket.socket] = None
        # resilience counters (surfaced by report()): connects counts every
        # successful TCP establish (reconnects = connects - 1),
        # retry_attempts every request re-issued after a transport
        # failure, replies_lost the at-most-once requests whose reply was
        # lost (never resent)
        self.requests_sent = 0
        self.retry_attempts = 0
        self.connects = 0
        self.replies_lost = 0
        self.bytes_sent = 0
        self.bytes_received = 0
        self.last_reply: Optional[str] = None
        if connect:
            self._connect()  # fail fast on a misconfigured addr

    # -- transport ----------------------------------------------------------
    def _connect(self):
        s = socket.create_connection(self.addr, timeout=self.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s
        self.connects += 1

    def _drop_sock(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _readline(self) -> str:
        return read_line(self._sock)

    def _read_exact(self, n: int) -> bytearray:
        return read_exact(self._sock, n)

    def _on_err_reply(self, resp: str):
        """An ``ERR ...`` header arrived: raise it typed. The base protocol
        carries no body after ERR; a subclass whose protocol frames an
        error detail body reads it here BEFORE raising (the persistent
        connection must stay in sync)."""
        raise RuntimeError(f"{self.peer_name}: {resp}")

    def _make_reply_lost(self, cause: Exception) -> ReplyLost:
        return ReplyLost(
            f"reply lost after send ({cause}); NOT resending — the "
            "request may have applied remotely")

    def _request(self, line: str, payload=b"",
                 idempotent: bool = True, body_len=None,
                 timeout: Optional[float] = None):
        """One protocol round trip with reconnect and backoff. ``body_len``
        (resp → byte count) reads a framed payload INSIDE the retry scope,
        so a connection lost mid-body retries the whole request (idempotent
        case) instead of desyncing. ``timeout`` overrides the socket
        timeout for this round trip only. Returns ``resp`` or ``(resp,
        body)``. The header and the payload go out as two sends of one
        byte stream (a large payload is not copied behind its header)."""
        delay = self.retry_backoff
        last_err: Optional[Exception] = None
        header = line.encode() + b"\n"
        for attempt in range(self.retries):
            if attempt:
                self.retry_attempts += 1
            try:
                if self._sock is None:
                    self._connect()
            except OSError as e:
                last_err = e
                time.sleep(delay)
                delay = min(delay * 2, self.retry_backoff_max)
                continue
            sent = False
            try:
                if timeout is not None:
                    self._sock.settimeout(timeout)
                try:
                    self._sock.sendall(header)
                    if len(payload):
                        self._sock.sendall(payload)
                    sent = True
                    self.requests_sent += 1
                    self.bytes_sent += len(header) + len(payload)
                    resp = self._readline()
                    self.bytes_received += len(resp) + 1
                    self.last_reply = resp
                    if resp.startswith("ERR"):
                        self._on_err_reply(resp)
                    if body_len is None:
                        return resp
                    body = self._read_exact(body_len(resp))
                    self.bytes_received += len(body)
                    return resp, body
                finally:
                    if timeout is not None and self._sock is not None:
                        self._sock.settimeout(self.timeout)
            except (OSError, ConnectionError) as e:
                self._drop_sock()
                last_err = e
                if sent and not idempotent:
                    self.replies_lost += 1
                    raise self._make_reply_lost(e) from e
                time.sleep(delay)
                delay = min(delay * 2, self.retry_backoff_max)
        raise ConnectionError(
            f"{self.peer_name} unreachable at {self.addr} after "
            f"{self.retries} attempts: {last_err}")

    def close(self):
        if self._sock is None:
            return
        try:
            self._sock.sendall(b"QUIT\n")
        except OSError:
            pass
        self._drop_sock()


class PSClient(FramedClient):
    """Socket client for the pserver protocol. Dense params are flat f32
    buffers keyed by name; sparse pushes update [rows, dim] params row-wise
    (the distributed-lookup-table update path).

    Transport semantics come from :class:`FramedClient`: reconnect with
    backoff for IDEMPOTENT requests (``pull``, ``init_param`` (first writer
    wins makes a resend a no-op), ``status``, ``save``, ``export_param``,
    ``import_param``, ``delete_param``). ``push``/``push_quantized``/
    ``push_quantized_blocks``/``push_rows`` are NOT idempotent: sent at
    most once, a reply lost after a completed send raises
    :class:`PushUndelivered` instead of resending (see
    :meth:`AsyncPSTrainer.step`, which drops that step's gradient and keeps
    training)."""

    peer_name = "pserver"

    def __init__(self, addr: Tuple[str, int], trainer_id: int = 0,
                 timeout: float = 30.0, retries: int = 30,
                 retry_backoff: float = 0.05, retry_backoff_max: float = 2.0):
        self.trainer_id = int(trainer_id)
        self.pushes_sent = 0
        self.pulls = 0
        super().__init__(addr, timeout=timeout, retries=retries,
                         retry_backoff=retry_backoff,
                         retry_backoff_max=retry_backoff_max)

    @property
    def pushes_undelivered(self) -> int:
        """At-most-once pushes whose reply was lost (never resent): the
        pserver-flavored name of ``replies_lost``."""
        return self.replies_lost

    def _make_reply_lost(self, cause: Exception) -> ReplyLost:
        return PushUndelivered(
            f"push reply lost after send ({cause}); NOT resending — "
            "the update may have applied server-side")

    # -- param API ----------------------------------------------------------
    @staticmethod
    def _check_name(name: str) -> str:
        # the server parses names with %255s: longer (or whitespace-bearing)
        # names would truncate, desyncing the framed payload that follows,
        # so they are rejected client-side
        enforce(0 < len(name) <= 255 and not any(c.isspace() for c in name),
                f"param name must be 1-255 chars with no whitespace, got "
                f"{name[:64]!r}... ({len(name)} chars)")
        return name

    def init_param(self, name: str, value) -> bool:
        """Register a param (first writer wins). Returns True if this call
        created it."""
        data = _f32_bytes(value)
        resp = self._request(f"INIT {self._check_name(name)} {len(data)}", data)
        return resp == "OK NEW"

    @staticmethod
    def _trace_suffix(span: Optional[str]) -> str:
        """Optional trace field in the framed header: `` trace=<id>``
        appended AFTER the fields a peer parses positionally (an old peer's
        ``sscanf`` ignores trailing tokens); the pserver echoes it in its
        reply (see ``last_reply``)."""
        if span is None:
            return ""
        enforce(not any(c.isspace() for c in span),
                f"trace span must not contain whitespace: {span!r}")
        return f" trace={span}"

    def pull(self, name: str, shape, dtype=np.float32,
             span: Optional[str] = None) -> np.ndarray:
        _, data = self._request(
            f"PULL {self.trainer_id} {self._check_name(name)}"
            f"{self._trace_suffix(span)}",
            body_len=lambda resp: int(resp.split()[1]))
        self.pulls += 1
        arr = np.frombuffer(data, dtype=np.float32)
        return arr.reshape(shape).astype(dtype, copy=False)

    def push(self, name: str, grad, span: Optional[str] = None) -> int:
        data = _f32_bytes(grad)
        resp = self._request(
            f"PUSH {self.trainer_id} {self._check_name(name)} {len(data)}"
            f"{self._trace_suffix(span)}",
            data, idempotent=False)
        self.pushes_sent += 1
        return int(resp.split()[1])

    def push_quantized(self, name: str, grad, span: Optional[str] = None) -> int:
        """Int8-quantized dense push (abs-max symmetric, one f32 scale): 4x
        less wire than :meth:`push`, dequantized server-side before the
        identical update path."""
        g = np.ascontiguousarray(grad, dtype=np.float32).reshape(-1)
        scale = float(max(np.max(np.abs(g)), 1e-30))
        q = np.clip(np.round(g / scale * 127.0), -127, 127).astype(np.int8)
        resp = self._request(
            f"PUSHQ {self.trainer_id} {self._check_name(name)} {q.size} "
            f"{scale!r}{self._trace_suffix(span)}", q.tobytes(),
            idempotent=False)
        self.pushes_sent += 1
        return int(resp.split()[1])

    def push_quantized_blocks(self, name: str, grad,
                              span: Optional[str] = None, bits: int = 8,
                              block: int = 256) -> int:
        """Block-scaled quantized dense push (PUSHQB): one f32 abs-max scale
        per ``block`` elements, int8 or int4 (two codes a byte), through the
        codec the quantized exchange uses
        (:func:`quantized_collectives.encode_wire_blocks`). The body is
        scales then codes; n is the UNPADDED element count (the server
        derives the padded and packed lengths from n, bits and block)."""
        from .quantized_collectives import encode_wire_blocks
        g = np.ascontiguousarray(grad, dtype=np.float32).reshape(-1)
        q, scales = encode_wire_blocks(g, bits=bits, block_size=block)
        resp = self._request(
            f"PUSHQB {self.trainer_id} {self._check_name(name)} {g.size} "
            f"{int(bits)} {int(block)}{self._trace_suffix(span)}",
            scales.tobytes() + q.tobytes(), idempotent=False)
        self.pushes_sent += 1
        return int(resp.split()[1])

    def push_rows(self, name: str, row_ids, row_grads,
                  span: Optional[str] = None) -> int:
        """Sparse push: ``row_grads[k]`` updates row ``row_ids[k]`` of the
        [rows, dim] param (SelectedRows send and the pserver's row-wise
        optimize)."""
        ids = np.ascontiguousarray(row_ids, dtype=np.int32)
        vals = np.ascontiguousarray(row_grads, dtype=np.float32)
        enforce(vals.ndim == 2 and ids.shape == (vals.shape[0],),
                "push_rows wants ids [n] and grads [n, dim]")
        resp = self._request(
            f"PUSHROWS {self.trainer_id} {self._check_name(name)} "
            f"{vals.shape[0]} {vals.shape[1]}{self._trace_suffix(span)}",
            ids.tobytes() + vals.tobytes(), idempotent=False)
        self.pushes_sent += 1
        return int(resp.split()[1])

    def report(self) -> Dict[str, Any]:
        """Client-side resilience and traffic counters: requests, pushes and
        pulls sent, reconnects (successful re-establishes after the first
        connect), retry attempts, and at-most-once pushes whose reply was
        lost."""
        return {
            "addr": f"{self.addr[0]}:{self.addr[1]}",
            "requests": self.requests_sent,
            "pushes": self.pushes_sent,
            "pulls": self.pulls,
            "reconnects": max(0, self.connects - 1),
            "retries": self.retry_attempts,
            "pushes_undelivered": self.pushes_undelivered,
        }

    def save(self) -> None:
        """Trigger an atomic server-side checkpoint of params and optimizer
        accumulators (the server recovers it at startup when launched with
        the same snapshot_path)."""
        self._request("SAVE")

    def status(self) -> Dict[str, int]:
        resp = self._request("STATUS")
        return {k: int(v) for k, v in
                (kv.split("=") for kv in resp[3:].split())}

    # -- shard migration ----------------------------------------------------
    def export_param(self, name: str) -> Tuple[np.ndarray, np.ndarray, int]:
        """A param's FULL server-side state for shard migration: ``(value,
        optimizer accum, version)`` as flat f32 arrays. Idempotent (a read),
        so it retries transparently like :meth:`pull`."""

        def _blen(resp):
            _, vlen, alen, _ = resp.split()
            return (int(vlen) + int(alen)) * 4

        resp, data = self._request(f"EXPORT {self._check_name(name)}",
                                   body_len=_blen)
        _, vlen, alen, version = resp.split()
        vlen, alen = int(vlen), int(alen)
        buf = np.frombuffer(data, dtype=np.float32)
        return buf[:vlen].copy(), buf[vlen:vlen + alen].copy(), int(version)

    def import_param(self, name: str, value, accum, version: int = 0) -> None:
        """Install a param's full state on this server (absolute overwrite
        or create): the receive half of a shard split or merge. Unlike
        :meth:`push` this IS idempotent (it sets absolute state), so a
        reply lost after send retries transparently."""
        v = np.ascontiguousarray(value, dtype=np.float32).reshape(-1)
        a = np.ascontiguousarray(accum, dtype=np.float32).reshape(-1)
        self._request(
            f"IMPORT {self._check_name(name)} {v.size} {a.size} "
            f"{int(version)}", v.tobytes() + a.tobytes())

    def delete_param(self, name: str) -> None:
        """Drop a param from this server (idempotent): the cleanup half of
        shard migration on the OLD owner."""
        self._request(f"DELETE {self._check_name(name)}")


def _rendezvous_score(name: str, addr: Tuple[str, int]) -> Tuple[int, Tuple]:
    """Highest-random-weight (rendezvous) score of ``(name, server)``:
    deterministic across processes (crc32, no PYTHONHASHSEED dependence)
    and minimal-movement by construction (adding or removing a server
    re-homes only the params whose max moved, ~1/N of them). The addr
    tiebreak makes the ordering total."""
    key = f"{name}@{addr[0]}:{addr[1]}".encode()
    return (zlib.crc32(key) & 0xFFFFFFFF, (str(addr[0]), int(addr[1])))


class PSShardGroup:
    """Client-side shard router over N pservers: the membership-change half
    of elastic training for the async-PS path.

    Params are routed to servers by rendezvous hashing of the param name,
    so every trainer process computes the SAME owner table from the same
    address list with no coordination. The per-server transport is a
    plain :class:`PSClient`: pulls and exports retry with backoff, pushes
    stay at-most-once (:class:`PushUndelivered` on a lost reply, counted by
    ``AsyncPSTrainer.step``, never resent).

    **Membership change** (:meth:`resize`): when the server set grows
    (shard split) or shrinks (shard merge), exactly the params whose
    rendezvous owner changed migrate: the full state (value, optimizer
    accumulator, version) moves by ``EXPORT`` from the old owner and
    ``IMPORT`` (absolute overwrite, idempotent) onto the new one, and the
    routing table switches only after EVERY move landed. A crash mid-resize
    (the ``ps_resize:*`` crash points) leaves the OLD routing fully
    authoritative; re-running ``resize`` re-exports and re-imports
    idempotently; after the switch the old owner's copy is DELETEd. One
    coordinator performs the migrating ``resize``; other trainer processes
    adopt the new membership with :meth:`rebind` (route-only). A trainer
    that has NOT rebound and pushes into a migrated shard fails loudly
    (``ERR unknown param``), never silently updates an orphan. Per-trainer
    DC-ASGD baks do not migrate.

    Crash points (``resilience.crash_point``):

    - ``ps_resize:exported``: after one param's state left its old owner,
      before the import (fires per moved param);
    - ``ps_resize:imported``: all moves imported, routing not yet switched.
    """

    def __init__(self, addrs: Sequence[Tuple[str, int]], trainer_id: int = 0,
                 **client_kw):
        enforce(len(addrs) >= 1, "PSShardGroup needs at least one pserver")
        self.trainer_id = int(trainer_id)
        self._client_kw = dict(client_kw)
        self._clients: Dict[Tuple[str, int], PSClient] = {}
        self.addrs: List[Tuple[str, int]] = []
        self._names: set = set()
        # counters of transports CLOSED by resize()/rebind(), folded into
        # report() so the totals stay monotonic across membership changes
        self._retired_counts: Dict[str, int] = {}
        self._set_addrs(addrs)

    def _set_addrs(self, addrs) -> None:
        new = [(str(h), int(p)) for h, p in addrs]
        enforce(len(set(new)) == len(new),
                f"duplicate pserver addrs in {new}")
        self.addrs = new

    def _client(self, addr: Tuple[str, int]) -> PSClient:
        if addr not in self._clients:
            self._clients[addr] = PSClient(addr, trainer_id=self.trainer_id,
                                           **self._client_kw)
        return self._clients[addr]

    def owner(self, name: str) -> Tuple[str, int]:
        """The server currently responsible for ``name``."""
        return max(self.addrs, key=lambda a: _rendezvous_score(name, a))

    # -- PSClient surface, routed by owner ----------------------------------
    def init_param(self, name: str, value) -> bool:
        self._names.add(name)
        return self._client(self.owner(name)).init_param(name, value)

    def pull(self, name: str, shape, dtype=np.float32,
             span: Optional[str] = None) -> np.ndarray:
        return self._client(self.owner(name)).pull(name, shape, dtype=dtype,
                                                   span=span)

    def push(self, name: str, grad, span: Optional[str] = None) -> int:
        return self._client(self.owner(name)).push(name, grad, span=span)

    def push_quantized(self, name: str, grad, span: Optional[str] = None) -> int:
        return self._client(self.owner(name)).push_quantized(name, grad,
                                                             span=span)

    def push_quantized_blocks(self, name: str, grad,
                              span: Optional[str] = None, bits: int = 8,
                              block: int = 256) -> int:
        return self._client(self.owner(name)).push_quantized_blocks(
            name, grad, span=span, bits=bits, block=block)

    def push_rows(self, name: str, row_ids, row_grads,
                  span: Optional[str] = None) -> int:
        return self._client(self.owner(name)).push_rows(name, row_ids,
                                                        row_grads, span=span)

    def save(self) -> None:
        for addr in self.addrs:
            self._client(addr).save()

    def status(self) -> Dict[str, int]:
        """Aggregate counters summed over the live membership."""
        out: Dict[str, int] = {}
        for addr in self.addrs:
            for k, v in self._client(addr).status().items():
                out[k] = out.get(k, 0) + v
        return out

    _AGG_KEYS = ("requests", "pushes", "pulls", "reconnects", "retries",
                 "pushes_undelivered")

    def _retire_client(self, client: PSClient) -> None:
        """Fold a departing transport's counters into the retired aggregate
        BEFORE closing it (the totals stay monotonic across
        resize()/rebind())."""
        rep = client.report()
        for k in self._AGG_KEYS:
            self._retired_counts[k] = self._retired_counts.get(k, 0) + rep[k]
        client.close()

    def report(self) -> Dict[str, Any]:
        """Client-side counters: totals over every transport this group has
        opened (servers that left the membership included, folded in at
        retirement), plus the per-server breakdown of the LIVE transports
        keyed by ``host:port``."""
        servers = {f"{a[0]}:{a[1]}": c.report()
                   for a, c in sorted(self._clients.items())}
        agg: Dict[str, Any] = {k: self._retired_counts.get(k, 0)
                               for k in self._AGG_KEYS}
        for rep in servers.values():
            for k in self._AGG_KEYS:
                agg[k] += rep[k]
        agg["servers"] = servers
        return agg

    def close(self) -> None:
        for c in self._clients.values():
            self._retire_client(c)
        self._clients.clear()

    # -- membership change --------------------------------------------------
    def shard_map(self) -> Dict[Tuple[str, int], List[str]]:
        """{server addr: sorted param names it owns}: the routing table the
        group would use right now."""
        out: Dict[Tuple[str, int], List[str]] = {a: [] for a in self.addrs}
        for name in sorted(self._names):
            out[self.owner(name)].append(name)
        return out

    def resize(self, new_addrs: Sequence[Tuple[str, int]]) -> List[str]:
        """Split or merge the shard set onto a new server membership.
        Returns the (sorted) param names that migrated. Routing switches
        atomically at the end: any failure (an unreachable exporter, an
        injected crash) leaves the old membership fully authoritative and
        the call retryable."""
        from .. import resilience

        new = [(str(h), int(p)) for h, p in new_addrs]
        enforce(len(set(new)) == len(new) and new,
                f"resize: bad membership {new}")
        old_owner = {name: self.owner(name) for name in self._names}
        new_owner = {name: max(new, key=lambda a: _rendezvous_score(name, a))
                     for name in self._names}
        moves = sorted(n for n in self._names
                       if old_owner[n] != new_owner[n])
        for name in moves:
            value, accum, version = \
                self._client(old_owner[name]).export_param(name)
            resilience.crash_point("ps_resize:exported")
            self._client(new_owner[name]).import_param(name, value, accum,
                                                       version)
        resilience.crash_point("ps_resize:imported")
        self._set_addrs(new)
        # ONLY after routing switched: drop the migrated shards from their
        # old owners (idempotent DELETE). Before the switch the old copy is
        # the crash-retry safety net; after it, keeping it would leak a full
        # value and accum per move AND silently absorb pushes from trainers
        # that have not rebound. Best-effort: an old owner that left or died
        # has nothing worth cleaning.
        for name in moves:
            addr = old_owner[name]
            if addr not in self.addrs:
                continue  # the server left the membership with its copy
            try:
                self._client(addr).delete_param(name)
            except (ConnectionError, OSError) as e:
                _ps_log().warning("could not clean up migrated shard %s "
                                  "on %s (%s)", name, addr, e)
        # drop transports to servers that left the membership
        for addr in [a for a in self._clients if a not in self.addrs]:
            self._retire_client(self._clients.pop(addr))
        _ps_log().info("resharded %d param(s) onto %d server(s)",
                       len(moves), len(new))
        return moves

    def rebind(self, new_addrs: Sequence[Tuple[str, int]]) -> None:
        """Adopt a membership some OTHER process's :meth:`resize` already
        migrated: route-only, no data movement."""
        self._set_addrs(new_addrs)
        for addr in [a for a in self._clients if a not in self.addrs]:
            self._retire_client(self._clients.pop(addr))


def _ps_log():
    return logging.getLogger("paddle_tpu_torch.async_ps")


def _named_leaves(params: Dict[str, Any]) -> List[Tuple[str, Any]]:
    """(wire name, leaf) of each param in the JAX package's order: its
    pytree flattening of the flat params dict, keys sorted, each name with
    spaces replaced (``_named_leaves``, paddle_tpu/parallel/async_ps.py:741)."""
    return [(str(k).replace(" ", "_") or "root", params[k]) for k in sorted(params)]


def _make_ps_client(addr, trainer_id: int):
    """``addr`` may be one ``(host, port)`` (a single pserver: a plain
    :class:`PSClient`), a sequence of them (a shard set:
    :class:`PSShardGroup`), or an already-built client or group (shared by
    a membership coordinator)."""
    if isinstance(addr, (PSClient, PSShardGroup)):
        return addr
    seq = list(addr)
    if seq and isinstance(seq[0], (tuple, list)):
        return PSShardGroup(seq, trainer_id=trainer_id)
    return PSClient(tuple(seq), trainer_id=trainer_id)


def _register_ps_telemetry(trainer: "AsyncPSTrainer") -> int:
    """The async-PS trainer's scrape-time collector (async_ps.py:769): the
    client's transport counters and the trainer's ``pushes_lost`` and step,
    read from :meth:`AsyncPSTrainer.report` at scrape time. Weakly bound to
    the trainer."""
    from ..telemetry import get_registry
    from ..telemetry.registry import counter_family, gauge_family

    def collect(tr):
        rep = tr.report()
        cli = rep["client"]
        labels = {"inst": tr.telemetry_inst}
        return [
            gauge_family("paddle_tpu_ps_trainer_step", "Async-PS trainer global step",
                         [(labels, rep["global_step"])]),
            counter_family("paddle_tpu_ps_pushes_lost_total",
                           "At-most-once pushes dropped after a lost reply",
                           [(labels, rep["pushes_lost"])]),
            counter_family("paddle_tpu_ps_pushes_total", "Gradient pushes sent to pservers",
                           [(labels, cli["pushes"])]),
            counter_family("paddle_tpu_ps_pulls_total", "Parameter pulls from pservers",
                           [(labels, cli["pulls"])]),
            counter_family("paddle_tpu_ps_reconnects_total",
                           "Transport re-establishes after the first connect",
                           [(labels, cli["reconnects"])]),
            counter_family("paddle_tpu_ps_retries_total",
                           "Requests re-issued after a transport failure",
                           [(labels, cli["retries"])]),
        ]

    return get_registry().add_collector(collect, owner=trainer)


class AsyncPSTrainer:
    """Barrier-free trainer: local gradients on the trainer's device,
    server-side updates.

    ``program`` is a :class:`framework.Program`. ``place`` or ``device`` is
    where the gradient runs: the CUDA card unless the caller passes the
    CPU. ``pull_interval`` controls staleness: 1 pulls fresh params before
    every step (exactly local SGD when training alone); larger values
    trade staleness for fewer round trips. ``addr`` may be a single
    pserver ``(host, port)`` or a LIST of them, sharding params through
    :class:`PSShardGroup` (``trainer.client.resize([...])`` rides a
    membership change mid-run). Gradients go out by ``PUSH``, by ``PUSHQ``
    (``compress_grads=True``) or, with
    ``strategy=DistStrategy(quantized_allreduce="int8"|"int4")``, by
    ``PUSHQB`` at ``strategy.quant_block_size``."""

    def __init__(self, program, addr, loss_name: str = "loss",
                 trainer_id: int = 0, pull_interval: int = 1,
                 fetch_list: Optional[Sequence[str]] = None,
                 compress_grads: bool = False, strategy=None, place=None,
                 device=None):
        if not isinstance(program, Program):
            raise EnforceError(f"AsyncPSTrainer(program={type(program).__name__}): "
                               "expected a framework.Program, e.g. build(mnist.mlp)")
        if place is not None and device is not None:
            enforce(torch.device(place) == torch.device(device),
                    f"AsyncPSTrainer(place={place}, device={device}): two devices")
        self.device = default_device(device if device is not None else place,
                                     "AsyncPSTrainer")
        self.program = program
        self.loss_name = loss_name
        self.pull_interval = max(1, int(pull_interval))
        self.compress_grads = bool(compress_grads)
        # DistStrategy.quantized_allreduce routes pushes through the SAME
        # block-scaled encoder the quantized exchange uses (PUSHQB);
        # compress_grads=True keeps the per-tensor PUSHQ verb
        qmode = ((getattr(strategy, "quantized_allreduce", "none")
                  if strategy is not None else "none") or "none")
        enforce(qmode in ("none", "int8", "int4"),
                f"DistStrategy.quantized_allreduce={qmode!r} "
                "(none|int8|int4)")
        self.quant_bits = (None if qmode == "none"
                           else (8 if qmode == "int8" else 4))
        self.quant_block = int(getattr(strategy, "quant_block_size", 256)
                               ) if strategy is not None else 256
        self.fetch_list = list(fetch_list) if fetch_list is not None else None
        self.client = _make_ps_client(addr, trainer_id)
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.state = None
        self.global_step = 0
        self.pushes_lost = 0  # at-most-once pushes whose reply was lost
        self._rng = RngStream(self.device)
        self._host_buf: Optional[torch.Tensor] = None  # pinned grads, on the card
        # telemetry: a journal span a step rides the wire's trace field, and
        # the counters publish through one scrape-time collector
        from ..telemetry import get_journal, get_registry
        self.journal = get_journal()
        self.telemetry_inst = get_registry().next_instance("ps_trainer")
        # registered last: a scrape must never see a half-built trainer
        self._telemetry_cid = _register_ps_telemetry(self)

    # ------------------------------------------------------------------
    def startup(self, rng: Optional[int] = None,
                sample_feed: Optional[Dict[str, Any]] = None):
        """Initialise the params on this trainer's device from the seed
        ``rng`` (None: the ``seed`` flag), offer them to the server (the
        first writer wins) and pull the server's values into them.
        Returns the params ({JAX name: tensor})."""
        from ..executor import _put

        seed = get_flag("seed") if rng is None else int(rng)
        example = {k: torch.zeros_like(_put(v, "cpu"), device=self.device)
                   for k, v in (sample_feed or {}).items()}
        params, self.state = self.program.init(seed, place=self.device, **example)
        for name, leaf in _named_leaves(params):
            self.client.init_param(name, leaf.detach().float().cpu().numpy())
        for p in params.values():
            p.requires_grad_(p.is_floating_point())
        self.params = params
        self._pull_into()
        return self.params

    def _pull_into(self, span: Optional[str] = None) -> None:
        """Pull every param and copy it into this trainer's tensor in place,
        cast to the param's dtype."""
        with torch.no_grad():
            for name, p in _named_leaves(self.params):
                p.copy_(torch.from_numpy(self.client.pull(name, tuple(p.shape),
                                                          span=span)))

    def _grad_step(self, feed: Dict[str, Any], seed: int):
        """The program's training run and backward on this trainer's device:
        (fetched outputs, {name: grad}); a param the loss does not reach
        gets zeros, as ``jax.grad`` gives."""
        from ..executor import _put

        feed = {k: _put(v, self.device) for k, v in feed.items()}
        for p in self.params.values():
            p.grad = None
        out, new_state = self.program.apply(self.params, self.state, training=True,
                                            rng=self._rng.reset(seed), place=self.device,
                                            **feed)
        if not isinstance(out, dict):
            out = {self.loss_name: out}
        out[self.loss_name].backward()
        self.state = {k: v.detach() for k, v in new_state.items()}
        keys = list(out) if self.fetch_list is None else \
            list(dict.fromkeys(self.fetch_list + [self.loss_name]))
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in self.params.items()}
        return {k: out[k].detach() for k in keys}, grads

    def _host_grads(self, grads: Dict[str, torch.Tensor]) -> List[Tuple[str, np.ndarray]]:
        """(wire name, f32 grad on the host) in wire order: every grad cast
        to f32 on its device, then one copy to the host (into a pinned
        buffer kept from step to step on the card)."""
        named = _named_leaves(grads)
        with torch.no_grad():
            flat = torch.cat([g.detach().to(torch.float32).reshape(-1) for _, g in named])
        if flat.device.type == "cuda":
            if self._host_buf is None or self._host_buf.numel() != flat.numel():
                self._host_buf = torch.empty(flat.numel(), dtype=torch.float32,
                                             pin_memory=True)
            self._host_buf.copy_(flat)
            flat = self._host_buf
        host = flat.numpy()
        out, at = [], 0
        for name, g in named:
            out.append((name, host[at:at + g.numel()].reshape(tuple(g.shape))))
            at += g.numel()
        return out

    def _push(self, host_grads: List[Tuple[str, np.ndarray]], span: Optional[str]) -> None:
        if self.quant_bits is not None:
            send = functools.partial(self.client.push_quantized_blocks,
                                     bits=self.quant_bits, block=self.quant_block)
        elif self.compress_grads:
            send = self.client.push_quantized
        else:
            send = self.client.push
        for name, g in host_grads:
            try:
                send(name, g, span=span)
            except PushUndelivered as e:
                # at-most-once: the grad is dropped, never resent (a resend
                # could double-apply): one stale step, the trade async SGD
                # already makes for stragglers
                self.pushes_lost += 1
                self.journal.emit("ps.push_lost", span=span, inst=self.telemetry_inst,
                                  param=name, step=self.global_step,
                                  server=self._owner_str(name))
                _ps_log().warning("dropped push of %s at step %d (%s); continuing",
                                  name, self.global_step, e)

    # ------------------------------------------------------------------
    def step(self, feed: Dict[str, Any], rng: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Pull (every ``pull_interval`` steps), the gradient on the device,
        and a push of every grad; returns the fetched outputs. ``rng`` (an
        int seed) replaces the step's derived seed ``mix_seed(seed + 1,
        global_step)``, the port ``Trainer``'s rule. One span a step rides
        every pull and push of the step on the wire (the pserver echoes
        it)."""
        enforce(self.params is not None, "call startup() before step()")
        seed = mix_seed(get_flag("seed") + 1, self.global_step) if rng is None else int(rng)
        span = self.journal.new_span()
        if self.global_step % self.pull_interval == 0:
            self._pull_into(span=span)
        out, grads = self._grad_step(feed, seed)
        self._push(self._host_grads(grads), span)
        self.journal.emit("ps.step", span=span, inst=self.telemetry_inst, step=self.global_step)
        self.global_step += 1
        return out

    def _owner_str(self, name: str) -> Optional[str]:
        """``host:port`` of the pserver that owns ``name``."""
        owner = getattr(self.client, "owner", None)
        if owner is None:
            a = getattr(self.client, "addr", None)
            return f"{a[0]}:{a[1]}" if a else None
        a = owner(name)
        return f"{a[0]}:{a[1]}"

    def report(self) -> Dict[str, Any]:
        """Trainer and transport counters in one dict: ``pushes_lost``
        (at-most-once pushes this trainer dropped), ``global_step``, and the
        :meth:`PSClient.report`/:meth:`PSShardGroup.report` counters under
        ``client``."""
        return {
            "global_step": self.global_step,
            "pushes_lost": self.pushes_lost,
            "client": self.client.report(),
        }


__all__ = ["AsyncPSTrainer", "FramedClient", "PSClient", "PSShardGroup", "PServerProcess",
           "PushUndelivered", "ReplyLost", "child_python_env", "read_exact", "read_line"]
