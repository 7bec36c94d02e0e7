"""Out-of-process fleet replica entrypoint (counterpart of
``paddle_tpu.fleet.replica_main``, on the same wire)::

    python -m paddle_tpu_torch.fleet.replica_main <config.json>

Runs ONE :class:`~paddle_tpu_torch.serving.PredictorServer` over the
artifact named in the config, loaded onto the config's ``device`` (the
CUDA card when it names none; ``"cpu"`` for a CPU replica), and serves
the framed fleet wire (:mod:`paddle_tpu_torch.fleet.remote` documents
the verbs) on a TCP listener — one handler thread per connection, the
same accept discipline as ``native/pserver.cc``. Prints ``PORT <n>`` on stdout
once the server is warmed and the listener is up (the parent's
``ReplicaProcess.wait_ready`` handshake).

Contract-critical ordering: the ``DISPATCHED <id>`` lifecycle line is
written when the local server's worker picks the request up —
observed via a journal subscriber on the ``serving.dispatch`` event,
which the worker emits BEFORE executing. A client that never received
``DISPATCHED`` from a process that then died knows the request never
produced an observable effect (SIGKILL still delivers bytes written
before death), so the router may reroute it; once ``DISPATCHED`` is
on the wire the request is at-most-once.

Trace tokens: a ``trace=<span>`` field on the SUBMIT header is
adopted as the request's span (``PredictorServer.submit(span=...)``),
so this process's journal and the front door's carry one trace id —
and the ``JOURNAL`` verb ships this ring back for
``RunJournal.ingest``.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time
import traceback
from typing import Any, Dict, Optional


def _reply_json(conn: socket.socket, obj: Dict[str, Any]) -> None:
    from ..telemetry.journal import _json_default

    body = json.dumps(obj, default=_json_default).encode()
    conn.sendall(b"OK %d\n" % len(body) + body)


def _reply_err(conn: socket.socket, exc: BaseException) -> None:
    from .remote import error_payload

    name, detail = error_payload(exc)
    body = json.dumps(detail, default=repr).encode()
    conn.sendall(f"ERR {name} {len(body)}\n".encode() + body)


class _ReplicaService:
    """The verb dispatcher around one local ``PredictorServer``."""

    def __init__(self, server, journal, artifact_root: Optional[str] = None):
        from .remote import ArtifactStore

        self.server = server
        self.journal = journal
        # the host-side artifact cache behind FETCH/ARTIFACT: a router
        # on another machine streams save_inference_model dirs here
        # before RELOADing them (agent-spawned replicas share the
        # agent's cache, so one ship covers every replica on the host)
        if artifact_root is None:
            import tempfile
            artifact_root = os.path.join(tempfile.gettempdir(),
                                         f"pdtorch_artifacts_{os.getpid()}")
        self.artifacts = ArtifactStore(artifact_root)
        # SUBMIT feed byte accounting: wire (what crossed the link)
        # vs logical (what a passthrough transfer would have cost)
        self._wire_lock = threading.Lock()
        self._wire_counters = {"wire_bytes": 0, "logical_bytes": 0}
        self._rid_lock = threading.Lock()
        self._next_rid = 0
        # span -> fire callback, armed by SUBMIT handlers, invoked by
        # the journal subscriber when that span's serving.dispatch
        # event lands. The subscriber runs SYNCHRONOUSLY on the worker
        # thread between the dispatch emit and the execution (and
        # fires regardless of journal sampling — subscribe() is not a
        # sink), so the DISPATCHED wire write completes BEFORE the
        # executable runs: "no DISPATCHED received ⇒ never began
        # executing" is exact for a killed process, which is what
        # makes the client's reroute classification safe.
        self._dispatch_waiters: Dict[str, Any] = {}
        self._waiters_lock = threading.Lock()
        self._sub = journal.subscribe(self._on_journal_event)
        self.stopping = threading.Event()

    def _on_journal_event(self, event: Dict[str, Any]) -> None:
        if event.get("kind") != "serving.dispatch":
            return
        span = event.get("span")
        if span is None:
            return
        with self._waiters_lock:
            fire = self._dispatch_waiters.get(span)
        if fire is not None:
            fire()

    def _rid(self) -> str:
        with self._rid_lock:
            self._next_rid += 1
            return str(self._next_rid)

    # -- verbs ---------------------------------------------------------------

    def handle_submit(self, conn: socket.socket, parts) -> None:
        # retry: at-most-once — a replayed SUBMIT runs inference twice
        from ..parallel.async_ps import read_exact
        from .remote import error_payload, pack_tree, unpack_tree

        meta_len, payload_len = int(parts[1]), int(parts[2])
        deadline = None if parts[3] == "-" else float(parts[3])
        span = None
        for tok in parts[4:]:
            if tok.startswith("trace="):
                span = tok[len("trace="):]
        if span is None:
            # a client that sent no trace token still needs the
            # DISPATCHED ordering (the at-most-once classification
            # hangs off it) — mint the span server-side so the
            # dispatch subscriber has something to match
            span = self.journal.new_span()
        counters: Dict[str, int] = {}
        feed = unpack_tree(read_exact(conn, meta_len),
                           read_exact(conn, payload_len), counters=counters)
        with self._wire_lock:
            for k, v in counters.items():
                self._wire_counters[k] = self._wire_counters.get(k, 0) + v
        rid = self._rid()
        wlock = threading.Lock()   # serializes every write on this conn
        state = {"ok_sent": False, "fire_early": False,
                 "dispatched_sent": False}

        def _send_dispatched_locked() -> None:
            if state["dispatched_sent"]:
                return
            state["dispatched_sent"] = True
            try:
                # the worker thread writes this: cap a pathological
                # stalled client so it cannot head-of-line-block the
                # whole replica behind one dead peer
                conn.settimeout(2.0)
                conn.sendall(f"DISPATCHED {rid}\n".encode())
            except OSError:
                # a timed-out/failed send may have written PART of the
                # line: the stream is unrecoverable — close it so the
                # later DONE/FAIL write fails instead of appending to
                # a torn frame (the client classifies the lost
                # connection at-most-once, which is the truthful
                # outcome)
                try:
                    conn.close()
                except OSError:
                    pass
            finally:
                try:
                    conn.settimeout(None)
                except OSError:
                    pass

        def fire() -> None:
            # invoked by the journal subscriber ON the worker thread,
            # after the serving.dispatch emit and BEFORE the
            # executable runs — the wire write completes before
            # execution begins. The one exception: a dispatch so fast
            # it beats the handler's OK write queues behind it
            # (fire_early) and is written by the handler immediately
            # after OK — a microsecond window in which a kill would
            # reroute work whose execution died unobserved with the
            # process (still safe, just not wire-exact).
            with wlock:
                if not state["ok_sent"]:
                    state["fire_early"] = True
                    return
                _send_dispatched_locked()

        with self._waiters_lock:
            self._dispatch_waiters[span] = fire
        try:
            try:
                pending = self.server.submit(feed, deadline=deadline,
                                             span=span)
            except BaseException as e:
                _reply_err(conn, e)
                return
            with wlock:
                conn.sendall(f"OK {rid}\n".encode())
                state["ok_sent"] = True
                if state["fire_early"]:
                    _send_dispatched_locked()
            done_evt = pending._req.done
            while not done_evt.wait(0.5):
                if self.stopping.is_set():
                    done_evt.wait(5.0)   # shutdown grace, then bail
                    break
            try:
                value = pending.result(timeout=0.001)
            except BaseException as e:
                name, detail = error_payload(e)
                body = json.dumps(detail, default=repr).encode()
                with wlock:
                    conn.sendall(f"FAIL {rid} {name} {len(body)}\n".encode()
                                 + body)
            else:
                meta, payload = pack_tree(value)
                with wlock:
                    conn.sendall(f"DONE {rid} {len(meta)} "
                                 f"{len(payload)}\n".encode()
                                 + meta + payload)
        finally:
            with self._waiters_lock:
                self._dispatch_waiters.pop(span, None)

    def handle_health(self, conn: socket.socket) -> None:
        h = self.server.health()
        h["pid"] = os.getpid()
        _reply_json(conn, h)

    def handle_report(self, conn: socket.socket) -> None:
        rep = self.server.report()
        with self._wire_lock:
            rep["feed_wire"] = dict(self._wire_counters)
        _reply_json(conn, rep)

    def handle_metrics(self, conn: socket.socket) -> None:
        from ..telemetry import get_registry

        _reply_json(conn, get_registry().snapshot())

    def handle_journal(self, conn: socket.socket, since: int) -> None:
        events = [e for e in self.journal.recent()
                  if int(e.get("seq", 0)) > since]
        _reply_json(conn, {"run": self.journal.run_id, "events": events})

    def handle_fetch(self, conn: socket.socket, parts) -> None:
        """Artifact negotiate/commit (see ``remote.ArtifactStore``)."""
        from ..parallel.async_ps import read_exact

        token = parts[1]
        body = read_exact(conn, int(parts[2]))
        _reply_json(conn, self.artifacts.handle_fetch(token, body))

    def handle_artifact(self, conn: socket.socket, parts) -> None:
        """One pipelined artifact chunk frame — no reply (the sender
        streams; commit-time CRC validation reports bad files)."""
        from ..parallel.async_ps import read_exact

        token, fname = parts[1], parts[2]
        off, nbytes = int(parts[3]), int(parts[4])
        crc = int(parts[5], 16)
        data = read_exact(conn, nbytes)
        self.artifacts.handle_chunk(token, fname, off, crc, data)

    def handle_reload(self, conn: socket.socket, body: bytes) -> None:
        dirname = json.loads(body)["dirname"]
        try:
            self.server.reload(dirname, block=True)
        except BaseException as e:
            _reply_err(conn, e)
            return
        _reply_json(conn, {"generation": self.server.generation})

    def handle_kill(self, conn: socket.socket, body: bytes) -> None:
        reason = json.loads(body).get("reason", "killed over the wire")
        # kill() fails dispatched work ReplicaDied / queued work
        # ServerClosed — their SUBMIT handlers wake and push the FAIL
        # frames; the grace sleep lets those flushes land before the
        # process dies (a client that misses one classifies the lost
        # connection to the SAME typed outcome, so the race is benign)
        self.server.kill(reason=reason)
        try:
            _reply_json(conn, {})
        except OSError:
            pass
        time.sleep(0.2)
        os._exit(0)

    def handle_shutdown(self, conn: socket.socket, body: bytes) -> None:
        cfg = json.loads(body)
        self.stopping.set()
        self.server.close(drain=bool(cfg.get("drain", True)),
                          timeout=cfg.get("timeout"))
        try:
            _reply_json(conn, {})
        except OSError:
            pass
        time.sleep(0.1)
        os._exit(0)

    # -- connection loop -----------------------------------------------------

    def serve_conn(self, conn: socket.socket) -> None:
        from ..parallel.async_ps import read_exact, read_line

        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while not self.stopping.is_set():
                try:
                    line = read_line(conn)
                except (ConnectionError, OSError):
                    return
                parts = line.split()
                if not parts or parts[0] == "QUIT":
                    return
                verb = parts[0]
                try:
                    if verb == "SUBMIT":
                        self.handle_submit(conn, parts)
                    elif verb == "HEALTH":
                        self.handle_health(conn)
                    elif verb == "REPORT":
                        self.handle_report(conn)
                    elif verb == "METRICS":
                        self.handle_metrics(conn)
                    elif verb == "JOURNAL":
                        self.handle_journal(
                            conn, int(parts[1]) if len(parts) > 1 else 0)
                    elif verb == "FETCH":
                        self.handle_fetch(conn, parts)
                    elif verb == "ARTIFACT":
                        self.handle_artifact(conn, parts)
                    elif verb == "RELOAD":
                        self.handle_reload(conn,
                                           read_exact(conn, int(parts[1])))
                    elif verb == "KILL":
                        self.handle_kill(conn,
                                         read_exact(conn, int(parts[1])))
                    elif verb == "SHUTDOWN":
                        self.handle_shutdown(
                            conn, read_exact(conn, int(parts[1])))
                    else:
                        _reply_err(conn, RuntimeError(
                            f"unknown verb {verb!r}"))
                except (ConnectionError, OSError):
                    return
                except BaseException as e:  # a verb crashed: reply, keep conn
                    try:
                        _reply_err(conn, e)
                    except OSError:
                        return
        finally:
            try:
                conn.close()
            except OSError:
                pass


def _build_server(cfg: Dict[str, Any]):
    import numpy as np

    from ..io import load_inference_model
    from ..serving import BreakerPolicy, PredictorServer
    from .batching import BatchPolicy

    kw = dict(cfg.get("server_kw") or {})
    if cfg.get("batch_policy"):
        kw["batch_policy"] = BatchPolicy(**cfg["batch_policy"])
    if cfg.get("breaker"):
        kw["breaker"] = BreakerPolicy(**cfg["breaker"])
    if cfg.get("golden_feed"):
        with np.load(cfg["golden_feed"]) as z:
            kw["golden_feed"] = {k: z[k] for k in z.files}
    pred = load_inference_model(cfg["dirname"], device=cfg.get("device"))
    return PredictorServer(pred, **kw)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m paddle_tpu_torch.fleet.replica_main "
              "<config.json>", file=sys.stderr)
        return 2
    with open(argv[0], "r", encoding="utf-8") as f:
        cfg = json.load(f)
    from ..telemetry import get_journal

    try:
        server = _build_server(cfg)
    except BaseException:
        traceback.print_exc()
        print(f"REPLICA_FAILED {cfg.get('dirname')!r}", file=sys.stderr)
        return 1
    service = _ReplicaService(server, get_journal(),
                              artifact_root=cfg.get("artifact_root"))
    ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    # the bind knob: off-host reachability is opt-in (config "bind" or
    # PDTPU_BIND_ADDR, e.g. "0.0.0.0"); the default stays loopback
    bind = (cfg.get("bind") or os.environ.get("PDTPU_BIND_ADDR")
            or cfg.get("host", "127.0.0.1"))
    ls.bind((bind, int(cfg.get("port", 0))))
    ls.listen(128)
    # the readiness handshake: the parent blocks on this exact line
    print(f"PORT {ls.getsockname()[1]}", flush=True)
    while not service.stopping.is_set():
        try:
            conn, _ = ls.accept()
        except OSError:
            break
        threading.Thread(target=service.serve_conn, args=(conn,),
                         daemon=True).start()
    return 0


if __name__ == "__main__":
    sys.exit(main())
