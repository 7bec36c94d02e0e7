"""Fault-tolerant dataset task-queue — client + server manager for the
C++ master (counterpart of ``paddle_tpu.data.master``; the server is the
port's own build of its copy of ``native/master.cc``, whose line protocol
is unchanged, so a client of either package works against a server of
the other).

Capability parity with the reference's Go master generation
(go/master/service.go + python/paddle/v2/master/client.py): trainers are
stateless task consumers — they lease data-shard tasks, process them,
and report finish/fail; the master requeues timed-out or failed tasks
(up to failure_max, then discards), snapshots its state to disk, and
recovers it on restart. The v2 client's reader integration
(master.client.paddle_start_get_records) maps to :func:`task_reader`.

Typical use for multi-host input sharding::

    srv = MasterServer(snapshot_path="/nfs/master.snap")   # one process
    c = MasterClient(srv.addr)                              # every trainer
    c.set_tasks([f"shard-{i}.recordio" for i in range(64)])
    reader = task_reader(c, lambda path: recordio.reader_creator(path))
"""

from __future__ import annotations

import os
import socket
import subprocess
import time
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

from ..native import build_native


def _build_server() -> str:
    return build_native("master.cc", "master_server")


class MasterServer:
    """Spawn-and-own a master_server process (etcd-backed Go master
    analog; snapshot file plays etcd's role)."""

    def __init__(self, port: int = 0, snapshot_path: Optional[str] = None,
                 failure_max: int = 3, lease_timeout_ms: int = 60000):
        binpath = _build_server()
        self._proc = subprocess.Popen(
            [binpath, str(port), snapshot_path or "-", str(failure_max),
             str(lease_timeout_ms)],
            stdout=subprocess.PIPE, text=True)
        line = self._proc.stdout.readline().strip()
        if not line.startswith("PORT "):
            raise RuntimeError(f"master_server failed to start: {line!r}")
        self.port = int(line.split()[1])
        self.addr = ("127.0.0.1", self.port)

    def stop(self):
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


class MasterClient:
    """Socket client with retry/reconnect (trainers survive a master
    restart — the etcd re-registration story)."""

    def __init__(self, addr: Tuple[str, int], timeout: float = 10.0,
                 retries: int = 30, retry_interval: float = 0.5):
        self.addr = tuple(addr)
        self.timeout = timeout
        self.retries = retries
        self.retry_interval = retry_interval
        self._sock: Optional[socket.socket] = None

    # -- transport ----------------------------------------------------------
    def _connect(self):
        s = socket.create_connection(self.addr, timeout=self.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s

    def _readline(self) -> str:
        buf = bytearray()
        while True:
            c = self._sock.recv(1)
            if not c:
                raise ConnectionError("master closed connection")
            if c == b"\n":
                return buf.decode()
            buf += c

    def _read_exact(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            chunk = self._sock.recv(n - len(out))
            if not chunk:
                raise ConnectionError("master closed connection")
            out += chunk
        return bytes(out)

    def _request(self, line: str, payload: bytes = b"") -> str:
        last_err = None
        for _ in range(self.retries):
            try:
                if self._sock is None:
                    self._connect()
                self._sock.sendall(line.encode() + b"\n" + payload)
                return self._readline()
            except (OSError, ConnectionError) as e:
                last_err = e
                self._sock = None
                time.sleep(self.retry_interval)
        raise ConnectionError(f"master unreachable at {self.addr}: {last_err}")

    def close(self):
        if self._sock is not None:
            try:
                self._sock.sendall(b"QUIT\n")
            except OSError:
                pass
            self._sock.close()
            self._sock = None

    # -- task API -----------------------------------------------------------
    def add_task(self, payload) -> int:
        data = payload.encode() if isinstance(payload, str) else bytes(payload)
        resp = self._request(f"ADD {len(data)}", data)
        if not resp.startswith("OK"):
            raise RuntimeError(f"add_task: {resp}")
        return int(resp.split()[1])

    def set_tasks(self, payloads: Sequence) -> List[int]:
        return [self.add_task(p) for p in payloads]

    def get_task(self, wait: bool = True,
                 poll_interval: float = 0.2) -> Optional[Tuple[int, bytes]]:
        """Lease a task → (id, payload); None when the pass is complete.
        With ``wait``, blocks while other trainers hold the remaining
        leases (they may yet fail/time out and requeue)."""
        while True:
            resp = self._request("GET")
            if resp.startswith("TASK"):
                _, tid, ln = resp.split()
                return int(tid), self._read_exact(int(ln))
            if resp == "DONE":
                return None
            if resp == "WAIT":
                if not wait:
                    return None
                time.sleep(poll_interval)
                continue
            raise RuntimeError(f"get_task: {resp}")

    def finish_task(self, task_id: int):
        resp = self._request(f"FIN {task_id}")
        if not resp.startswith("OK"):
            raise RuntimeError(f"finish_task: {resp}")

    def fail_task(self, task_id: int):
        resp = self._request(f"FAIL {task_id}")
        if not resp.startswith("OK"):
            raise RuntimeError(f"fail_task: {resp}")

    def reset_pass(self) -> int:
        resp = self._request("RESET")
        return int(resp.split()[1])

    def status(self) -> dict:
        resp = self._request("STATUS")
        return {k: int(v) for k, v in
                (kv.split("=") for kv in resp[3:].split())}


def task_reader(client: MasterClient, make_reader: Callable[[str], Callable],
                reset_each_pass: bool = False) -> Callable:
    """Reader-combinator over leased tasks (v2 master-client reader
    analog): each task payload names a shard; ``make_reader(payload)``
    returns a reader creator over that shard. Finishes tasks on success,
    fails them on reader exceptions (→ retry on another trainer)."""

    def reader() -> Iterable:
        if reset_each_pass:
            client.reset_pass()
        while True:
            leased = client.get_task()
            if leased is None:
                return
            tid, payload = leased
            try:
                for sample in make_reader(payload.decode())():
                    yield sample
            except GeneratorExit:
                raise
            except Exception:
                client.fail_task(tid)
                continue
            client.finish_task(tid)

    return reader
