"""Per-host fleet agent (counterpart of ``paddle_tpu.fleet.agent``, on
the same wire)::

    python -m paddle_tpu_torch.fleet.agent [--root DIR] [--bind ADDR] [--port N]

One agent runs on each serving host and is the router's hands there:
it spawns, kills, and respawns replica processes on request over the
same framed wire the fleet speaks (:mod:`paddle_tpu_torch.fleet.remote`),
and it fronts the HOST's artifact cache — the router ships a
``save_inference_model`` dir once per host over FETCH/ARTIFACT and
every replica the agent spawns serves (and reloads) from that shared,
CRC-validated cache.

Wire verbs (client → agent)::

    SPAWN <len> + json   {"dirname", "name", "server_kw", "device"} → replica addr/pid
    STOP  <len> + json   {"pid"} → SIGKILL + reap (idempotent)
    PS                   → spawned children (bounded history), liveness
    FETCH / ARTIFACT     the artifact door (same protocol as a replica)
    QUIT

``PS`` is deliberately a *history*, not a process list: a child that
died stays in the table marked dead. That makes the agent a waitpid
oracle for :meth:`~paddle_tpu_torch.fleet.remote.RemoteReplica.
_provably_dead` across proxied links — "tracked and exited" or "no
longer tracked" is proof of death where "connect refused" can no
longer be. The dead-entry history is bounded (``--max-dead``, default
256): the oldest dead children are evicted first and live pids are
never evicted, and since "no longer tracked" already reads as
dead, eviction preserves the oracle's verdicts.

Prints ``PORT <n>`` on stdout once the listener is up (the
``AgentProcess.wait_ready`` handshake, same as a replica's).
"""

from __future__ import annotations

import argparse
import base64
import io as _io
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, Optional, Tuple

from .replica_main import _reply_err, _reply_json


def _log():
    import logging
    return logging.getLogger("paddle_tpu_torch.fleet.agent")


def decode_server_kw(kw: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`~paddle_tpu_torch.fleet.remote.encode_server_kw`:
    rehydrate the base64-npz golden feed into arrays (policy dicts
    pass through — the replica entrypoint rebuilds the dataclasses)."""
    import numpy as np

    kw = dict(kw)
    npz = kw.pop("golden_feed_npz", None)
    if npz is not None:
        with np.load(_io.BytesIO(base64.b64decode(npz))) as z:
            kw["golden_feed"] = {k: z[k] for k in z.files}
    return kw


class AgentService:
    """The verb dispatcher around this host's replica children and
    artifact cache."""

    def __init__(self, root: str, child_bind: Optional[str] = None,
                 advertise: str = "127.0.0.1", max_dead: int = 256):
        from .remote import ArtifactStore

        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.artifacts = ArtifactStore(os.path.join(self.root, "artifacts"))
        self._child_bind = child_bind
        self._advertise = advertise
        self._lock = threading.Lock()
        # pid -> {"name", "proc", "addr"}, insertion-ordered (= spawn
        # order). PS is a death oracle, not a process list: a dead
        # child STAYS in the table, but the dead-entry history is
        # BOUNDED — once more than ``max_dead`` dead children
        # accumulate, the oldest dead ones are evicted (live pids are
        # never evicted). Eviction is oracle-compatible: remote.
        # _provably_dead reads "no longer tracked" as reaped-therefore-
        # dead, which is exactly what an evicted entry was — so an
        # autoscaling host churning replicas for weeks holds a bounded
        # table without weakening the at-most-once death proof.
        self._procs: Dict[int, Dict[str, Any]] = {}
        self.max_dead = int(max_dead)
        self.stopping = threading.Event()

    def _prune_dead_locked(self) -> None:
        """Evict the oldest dead children beyond ``max_dead``. Caller
        holds ``self._lock``."""  # guarded-by: self._lock
        dead = [pid for pid, info in self._procs.items()
                if info["proc"].poll() is not None]
        for pid in dead[:max(0, len(dead) - self.max_dead)]:
            del self._procs[pid]

    # -- verbs ---------------------------------------------------------------

    def handle_spawn(self, conn: socket.socket, parts) -> None:
        # retry: at-most-once — a replayed SPAWN launches a second
        # replica process (the orphan would be visible in PS, but the
        # client surfaces the lost reply instead of resending)
        from ..parallel.async_ps import read_exact
        from .remote import ReplicaProcess

        body = read_exact(conn, int(parts[1]))
        req = json.loads(body)
        dirname = req["dirname"]
        if not os.path.isabs(dirname):
            # relative names resolve against the host artifact cache
            dirname = os.path.join(self.artifacts.root, dirname)
        kw = decode_server_kw(dict(req.get("server_kw") or {}))
        try:
            proc = ReplicaProcess(dirname, server_kw=kw,
                                  artifact_root=self.artifacts.root,
                                  bind=self._child_bind,
                                  device=req.get("device"))
            addr = proc.wait_ready()
        except BaseException as e:
            _reply_err(conn, e)
            return
        info = {"name": req.get("name"), "proc": proc, "addr": addr}
        with self._lock:
            self._procs[proc.pid] = info
            self._prune_dead_locked()
        _reply_json(conn, {"name": req.get("name"), "pid": proc.pid,
                           "addr": [self._advertise, addr[1]]})

    def handle_stop(self, conn: socket.socket, parts) -> None:
        from ..parallel.async_ps import read_exact

        body = read_exact(conn, int(parts[1]))
        pid = int(json.loads(body)["pid"])
        with self._lock:
            info = self._procs.get(pid)
        if info is None:
            _reply_json(conn, {"stopped": False, "known": False})
            return
        info["proc"].stop()
        _reply_json(conn, {"stopped": True, "known": True})

    def handle_ps(self, conn: socket.socket) -> None:
        with self._lock:
            self._prune_dead_locked()
            procs = [{"name": info["name"], "pid": pid,
                      "alive": info["proc"].poll() is None,
                      "addr": [self._advertise, info["addr"][1]]}
                     for pid, info in self._procs.items()]
        _reply_json(conn, {"procs": procs, "pid": os.getpid()})

    def handle_fetch(self, conn: socket.socket, parts) -> None:
        from ..parallel.async_ps import read_exact

        token = parts[1]
        body = read_exact(conn, int(parts[2]))
        _reply_json(conn, self.artifacts.handle_fetch(token, body))

    def handle_artifact(self, conn: socket.socket, parts) -> None:
        from ..parallel.async_ps import read_exact

        token, fname = parts[1], parts[2]
        off, nbytes = int(parts[3]), int(parts[4])
        crc = int(parts[5], 16)
        data = read_exact(conn, nbytes)
        self.artifacts.handle_chunk(token, fname, off, crc, data)

    # -- connection loop -----------------------------------------------------

    def serve_conn(self, conn: socket.socket) -> None:
        from ..parallel.async_ps import read_line

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
                    if verb == "SPAWN":
                        self.handle_spawn(conn, parts)
                    elif verb == "STOP":
                        self.handle_stop(conn, parts)
                    elif verb == "PS":
                        self.handle_ps(conn)
                    elif verb == "FETCH":
                        self.handle_fetch(conn, parts)
                    elif verb == "ARTIFACT":
                        self.handle_artifact(conn, parts)
                    else:
                        _reply_err(conn, RuntimeError(
                            f"unknown verb {verb!r}"))
                except (ConnectionError, OSError):
                    return
                except BaseException as e:
                    try:
                        _reply_err(conn, e)
                    except OSError:
                        return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        self.stopping.set()
        with self._lock:
            procs = list(self._procs.values())
        for info in procs:
            try:
                info["proc"].stop()
            except Exception:
                pass


# -- spawning an agent from tests/drills --------------------------------------


class AgentProcess:
    """Spawn-and-own one agent process (the test/drill injector: a
    whole-"host" kill is SIGKILLing this plus every replica its PS
    lists). Same ``PORT <n>`` readiness handshake as a replica."""

    def __init__(self, root: str, bind: Optional[str] = None,
                 port: int = 0):
        from ..parallel.async_ps import child_python_env

        self.root = root
        argv = [sys.executable, "-m", "paddle_tpu_torch.fleet.agent",
                "--root", root, "--port", str(int(port))]
        if bind:
            argv += ["--bind", bind]
        env = child_python_env(pop=("PDTPU_TELEMETRY_ORIGIN",))
        self._proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                      text=True, env=env)
        self.addr: Optional[Tuple[str, int]] = None
        self._host = bind if bind and bind != "0.0.0.0" else "127.0.0.1"

    @property
    def pid(self) -> int:
        return self._proc.pid

    def wait_ready(self, timeout: float = 60.0) -> Tuple[str, int]:
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
                    f"agent process exited (rc={rc}) before reporting "
                    "its port — see its stderr above")
            line = line.strip()
            if line.startswith("PORT "):
                self.addr = (self._host, int(line.split()[1]))
                return self.addr
        raise TimeoutError(
            f"agent process did not report a port within {timeout}s "
            f"(last line: {line!r})")

    def poll(self) -> Optional[int]:
        return self._proc.poll()

    def kill(self) -> None:
        """SIGKILL the agent itself (NOT its replicas — a real host
        kill delivers those separately; tests kill each pid)."""
        if self._proc.poll() is None:
            self._proc.kill()

    def stop(self) -> None:
        self.kill()
        try:
            self._proc.wait(timeout=5.0)
        except Exception:
            pass

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.fleet.agent",
        description="per-host fleet agent: replica launcher + artifact "
                    "cache over the framed wire")
    p.add_argument("--root", default=None,
                   help="host base dir (artifact cache lives under it; "
                        "default: a fresh temp dir)")
    p.add_argument("--bind", default=None,
                   help="listener bind address (also PDTPU_BIND_ADDR; "
                        "default loopback). Spawned replicas bind it too.")
    p.add_argument("--advertise", default=None,
                   help="host address spawned replicas are advertised at "
                        "(default: the bind address, or loopback)")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--max-dead", type=int, default=256,
                   help="dead-children history cap for PS (oldest dead "
                        "entries evicted beyond this; live pids never "
                        "evicted)")
    args = p.parse_args(argv)
    root = args.root or tempfile.mkdtemp(prefix="pdtorch_agent_")
    bind = args.bind or os.environ.get("PDTPU_BIND_ADDR") or "127.0.0.1"
    advertise = args.advertise or (bind if bind != "0.0.0.0"
                                   else "127.0.0.1")
    service = AgentService(root, child_bind=args.bind, advertise=advertise,
                           max_dead=args.max_dead)
    ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    ls.bind((bind, int(args.port)))
    ls.listen(128)
    print(f"PORT {ls.getsockname()[1]}", flush=True)
    try:
        while not service.stopping.is_set():
            try:
                conn, _ = ls.accept()
            except OSError:
                break
            threading.Thread(target=service.serve_conn, args=(conn,),
                             daemon=True).start()
    finally:
        service.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
