"""The asynchronous parameter server of the port
(``paddle_tpu_torch.parallel.async_ps`` and ``native/pserver.cc``) against
``paddle_tpu.parallel.async_ps`` on the CPU.

- The port's ``pserver.cc`` is the JAX package's byte for byte, and the
  port builds and runs its own binary.
- Wire: a recording proxy in front of one pserver sees byte-identical
  requests from the JAX ``PSClient`` and the port's for every verb (INIT,
  PULL, PUSH, PUSHQ, PUSHQB at 8 and 4 bits, PUSHROWS, SAVE, STATUS,
  EXPORT, IMPORT, DELETE, QUIT), spans passed explicitly.
- The server's math through the port's client (tests/test_async_ps.py):
  SGD, Adagrad, DC-ASGD, PUSHROWS, PUSHQ, PUSHQB against the port's codec,
  snapshot recovery, the name guard, a server killed mid-stream.
- Routing (tests/test_elastic_reshard.py:390-560): ``PSShardGroup``'s owner
  tables equal the JAX package's; split and merge with full state, a crash
  between export and import (``resilience.crash_points``), the
  pserver-kill drill, a trainer riding through a membership change.
- Trainers: a JAX ``AsyncPSTrainer`` on one server and the port's on a
  second (INITed first with the JAX init params, so both start there),
  MNIST MLP, 4 steps; the losses and every exported param. SGD and
  DC-ASGD at ``pull_interval=2`` are held at losses rtol 1e-5 and params
  atol 1e-6 (the two packages' f32 grads sum 784- and 200-term products in
  another order: 3e-8 measured). Adagrad's first step moves a weight by
  lr·g/(|g| + 1e-6), so a grad within a few eps of 0 moves it by what the
  f32 rounding of g sets: its params are held by their moves from the
  initial values, relative L2 1e-3 per param (1.1e-4 measured). The
  quantized pushes
  (PUSHQ, PUSHQB int8/int4) round each grad to a code: a grad within f32
  rounding of a code boundary takes the neighbouring code in one package,
  so each element may differ by one code step (lr·scale/qmax) a push on
  top of that; every param is held within the sum of those steps over the
  pushes, and all but 1e-3 of the elements at 1e-5. Mixed JAX and port
  trainers on one server end where two JAX trainers do (1e-6). A lone port
  trainer is the port's local SGD ``Trainer`` (rtol 1e-6: the same f32
  update, on the server and in torch). A 2-layer d 64 GPT at dropout 0
  runs the port's flash path (its plain versions on the CPU) against the
  JAX package's (its kernels interpreted), losses rtol 1e-5 and params
  atol 2e-5.

Trainers run in this process; only the pservers are child processes."""

import os
import socket
import threading
import time

import numpy as np
import pytest

import paddle_tpu as jpt
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.parallel import DistStrategy as JStrategy
from paddle_tpu.parallel import async_ps as jps

import paddle_tpu_torch as tpt
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch.core.errors import EnforceError
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.parallel import DistStrategy as TStrategy
from paddle_tpu_torch.parallel import async_ps as tps
from paddle_tpu_torch.parallel import quantized_collectives as tqc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
LR = 0.05
LOSS_RTOL, PARAM_ATOL, MOVE_RTOL = 1e-5, 1e-6, 1e-3


@pytest.fixture(scope="module")
def sgd_server():
    with tps.PServerProcess(lr=0.1, optimizer="sgd") as srv:
        yield srv


def _group_kw():
    # a tight retry budget, so drills against an unreachable server fail in
    # ms rather than the 30-retry production window
    return dict(retries=3, retry_backoff=0.01, retry_backoff_max=0.05)


# -- build ---------------------------------------------------------------------


def test_pserver_source_is_the_jax_packages_and_builds(sgd_server):
    with open(os.path.join(REPO, "paddle_tpu", "native", "pserver.cc"), "rb") as f:
        want = f.read()
    with open(os.path.join(REPO, "paddle_tpu_torch", "native", "pserver.cc"), "rb") as f:
        assert f.read() == want
    path = tps._build_server()
    assert path.startswith(os.path.join(REPO, "paddle_tpu_torch", "_build") + os.sep)
    assert os.access(path, os.X_OK) and tps._build_server() == path
    c = tps.PSClient(sgd_server.addr)
    assert set(c.status()) == {"params", "pushes", "qpushes"}
    c.close()


# -- the wire ------------------------------------------------------------------


class _RecordingProxy:
    """A TCP proxy on localhost in front of one pserver: forwards every
    connection both ways and keeps the bytes each client sent."""

    def __init__(self, target):
        self.target = target
        self.streams = []
        self._sock = socket.create_server(("127.0.0.1", 0))
        self.addr = self._sock.getsockname()
        self._threads = []
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            up = socket.create_connection(self.target)
            rec = bytearray()
            self.streams.append(rec)
            for src, dst, keep in ((conn, up, rec), (up, conn, None)):
                t = threading.Thread(target=self._pump, args=(src, dst, keep), daemon=True)
                t.start()
                self._threads.append(t)

    @staticmethod
    def _pump(src, dst, keep):
        try:
            while True:
                data = src.recv(1 << 16)
                if not data:
                    break
                if keep is not None:
                    keep += data
                dst.sendall(data)
        except OSError:
            pass
        finally:
            for s in (dst, src):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    def wait(self, n):
        """The first ``n`` connections' streams, once their pumps ended."""
        for t in self._threads[:2 * n]:
            t.join(10)
        return [bytes(s) for s in self.streams[:n]]

    def close(self):
        self._sock.close()


def _every_verb(ps, addr):
    """One client of package ``ps`` sends every verb once (spans passed
    explicitly), then QUIT."""
    c = ps.PSClient(addr, trainer_id=3)
    w = (np.arange(12, dtype=np.float32) / 7).reshape(3, 4)
    g = (np.linspace(-1.5, 1.0, 300) ** 3).astype(np.float32)
    c.init_param("layer/w", w)
    c.pull("layer/w", (3, 4))
    c.pull("layer/w", (3, 4), span="00c0ffee00000001")
    c.push("layer/w", w * 0.5, span="00c0ffee00000002")
    c.init_param("g", np.zeros(300, np.float32))
    c.push_quantized("g", g, span="00c0ffee00000003")
    c.push_quantized_blocks("g", g, span="00c0ffee00000004", bits=8, block=64)
    c.push_quantized_blocks("g", g, span="00c0ffee00000005", bits=4, block=64)
    c.push("g", g)
    c.init_param("emb", np.zeros((8, 4), np.float32))
    c.push_rows("emb", np.array([1, 5], np.int32), np.ones((2, 4), np.float32),
                span="00c0ffee00000006")
    c.save()
    c.status()
    c.export_param("g")
    # absolute state (not the export's, which the earlier run's pushes moved)
    c.import_param("g_copy", g[::-1], np.abs(g), 7)
    c.delete_param("g_copy")
    c.close()


def test_every_verb_is_byte_identical_on_the_wire(tmp_path):
    with tps.PServerProcess(lr=0.1, snapshot_path=str(tmp_path / "ps.snap")) as srv:
        proxy = _RecordingProxy(srv.addr)
        try:
            _every_verb(jps, proxy.addr)
            _every_verb(tps, proxy.addr)
            jax_bytes, port_bytes = proxy.wait(2)
        finally:
            proxy.close()
    assert port_bytes == jax_bytes
    for head in (b"INIT layer/w 48\n", b"PULL 3 layer/w\n",
                 b"PULL 3 layer/w trace=00c0ffee00000001\n",
                 b"PUSH 3 layer/w 48 trace=00c0ffee00000002\n", b"PUSHQ 3 g 300 ",
                 b"PUSHQB 3 g 300 8 64 trace=00c0ffee00000004\n",
                 b"PUSHQB 3 g 300 4 64 trace=00c0ffee00000005\n", b"PUSH 3 g 1200\n",
                 b"PUSHROWS 3 emb 2 4 trace=00c0ffee00000006\n", b"SAVE\nSTATUS\nEXPORT g\n",
                 b"IMPORT g_copy 300 300 7\n", b"DELETE g_copy\nQUIT\n"):
        assert head in jax_bytes, head


# -- the server's math (tests/test_async_ps.py) --------------------------------


def test_init_pull_push_sgd_math(sgd_server):
    c = tps.PSClient(sgd_server.addr)
    w0 = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert c.init_param("w", w0)
    assert not c.init_param("w", w0 * 100)  # first writer wins
    np.testing.assert_array_equal(c.pull("w", (2, 3)), w0)
    g = np.ones((2, 3), np.float32)
    c.push("w", g)
    np.testing.assert_array_equal(c.pull("w", (2, 3)), w0 - np.float32(0.1) * g)
    c.close()


def test_push_unknown_and_mismatch(sgd_server):
    c = tps.PSClient(sgd_server.addr)
    with pytest.raises(RuntimeError, match="unknown param"):
        c.push("nope", np.ones(3, np.float32))
    c.init_param("v", np.zeros(4, np.float32))
    with pytest.raises(RuntimeError, match="size mismatch"):
        c.push("v", np.ones(5, np.float32))
    c.close()


def test_push_rows_sparse(sgd_server):
    c = tps.PSClient(sgd_server.addr)
    table = np.zeros((8, 4), np.float32)
    c.init_param("emb_rows", table)
    ids = np.array([2, 5], np.int32)
    rows = np.ones((2, 4), np.float32)
    c.push_rows("emb_rows", ids, rows)
    want = table.copy()
    want[ids] -= np.float32(0.1) * rows  # row-wise SGD on the touched rows only
    np.testing.assert_array_equal(c.pull("emb_rows", (8, 4)), want)
    with pytest.raises(RuntimeError, match="out of range"):
        c.push_rows("emb_rows", np.array([99], np.int32), np.ones((1, 4), np.float32))
    c.close()


def test_adagrad_server_math():
    with tps.PServerProcess(lr=0.5, optimizer="adagrad") as srv:
        c = tps.PSClient(srv.addr)
        w0 = np.full((3,), 2.0, np.float32)
        c.init_param("w", w0)
        g = np.array([1.0, 2.0, 0.0], np.float32)
        c.push("w", g)
        want = w0 - 0.5 * g / (np.abs(g) + 1e-6)
        np.testing.assert_allclose(c.pull("w", (3,)), want, rtol=1e-5)
        c.close()


def test_dc_asgd_delay_compensation():
    lam, lr = 0.5, 0.1
    with tps.PServerProcess(lr=lr, optimizer="sgd", dc_asgd=True, dc_lambda=lam) as srv:
        stale = tps.PSClient(srv.addr, trainer_id=0)
        fresh = tps.PSClient(srv.addr, trainer_id=1)
        w0 = np.array([1.0, -2.0, 3.0], np.float32)
        stale.init_param("w", w0)
        w_bak = stale.pull("w", (3,))
        g1 = np.array([0.5, 0.5, 0.5], np.float32)
        fresh.pull("w", (3,))
        fresh.push("w", g1)
        w1 = w0 - lr * g1
        g0 = np.array([1.0, 1.0, -1.0], np.float32)
        stale.push("w", g0)
        g_adj = g0 + lam * g0 * g0 * (w1 - w_bak)
        np.testing.assert_allclose(stale.pull("w", (3,)), w1 - lr * g_adj, rtol=1e-5)
        stale.close()
        fresh.close()


def test_push_quantized_math(sgd_server):
    c = tps.PSClient(sgd_server.addr)
    rng = np.random.RandomState(5)
    w0 = rng.randn(64).astype(np.float32)
    g = rng.randn(64).astype(np.float32)
    c.init_param("wq", w0)
    c.push_quantized("wq", g)
    tol = 0.1 * float(np.abs(g).max()) / 127.0 + 1e-7  # half a code step, and rounding
    assert float(np.max(np.abs(c.pull("wq", (64,)) - (w0 - 0.1 * g)))) <= tol
    with pytest.raises(RuntimeError, match="size mismatch"):
        c.push_quantized("wq", np.ones(65, np.float32))
    c.close()


@pytest.mark.parametrize("bits", [8, 4])
def test_push_quantized_blocks_decode_bit_exact(sgd_server, bits):
    """The server dequantizes a PUSHQB body to exactly what the port's host
    codec decodes from it."""
    c = tps.PSClient(sgd_server.addr)
    rng = np.random.RandomState(9 + bits)
    name = f"wb{bits}"
    w0 = rng.randn(300).astype(np.float32)  # not a block multiple
    g = (rng.randn(300) * 2).astype(np.float32)
    c.init_param(name, w0)
    c.push_quantized_blocks(name, g, bits=bits, block=128)
    payload, scales = tqc.encode_wire_blocks(g, bits=bits, block_size=128)
    deq = tqc.decode_wire_blocks(payload, scales, g.size, bits=bits, block_size=128)
    np.testing.assert_array_equal(c.pull(name, (300,)), w0 - np.float32(0.1) * deq)
    with pytest.raises(RuntimeError, match="size mismatch"):
        c.push_quantized_blocks(name, np.ones(301, np.float32), bits=bits)
    c.close()


def test_snapshot_recover_across_restart(tmp_path):
    """SAVE writes params and optimizer accumulators; a restarted server on
    the same snapshot path recovers both (the second Adagrad step is the
    smaller one of an accumulated G)."""
    snap = str(tmp_path / "ps.snap")
    w0 = np.array([2.0, -1.0, 4.0], np.float32)
    g = np.array([1.0, 2.0, 0.5], np.float32)
    with tps.PServerProcess(lr=0.5, optimizer="adagrad", snapshot_path=snap) as srv:
        c = tps.PSClient(srv.addr)
        c.init_param("w", w0)
        c.push("w", g)
        w_after = c.pull("w", (3,))
        c.save()
        c.close()
    with tps.PServerProcess(lr=0.5, optimizer="adagrad", snapshot_path=snap) as srv2:
        c2 = tps.PSClient(srv2.addr)
        assert not c2.init_param("w", w0 * 99)
        np.testing.assert_array_equal(c2.pull("w", (3,)), w_after)
        c2.push("w", g)
        want = w_after - 0.5 * g / (np.sqrt(2 * g * g) + 1e-6)
        np.testing.assert_allclose(c2.pull("w", (3,)), want, rtol=1e-5)
        c2.close()


def test_save_without_snapshot_path_errors(sgd_server):
    c = tps.PSClient(sgd_server.addr)
    with pytest.raises(RuntimeError, match="no snapshot path"):
        c.save()
    c.close()


def test_param_name_guard():
    for bad in ("x" * 256, "a b", ""):
        with pytest.raises(EnforceError, match="1-255 chars"):
            tps.PSClient._check_name(bad)
    assert tps.PSClient._check_name("layers/fc_0/w") == "layers/fc_0/w"
    with pytest.raises(EnforceError, match="whitespace"):
        tps.PSClient._trace_suffix("a b")


def test_client_survives_pserver_kill_mid_stream(tmp_path):
    """Kill the pserver mid-stream: a push is at-most-once (a typed
    ConnectionError or PushUndelivered, never resent); a pull issued while
    the server is down rides out the restart (snapshot-recovered) with
    backoff."""
    snap = str(tmp_path / "ps.snap")
    with tps.PServerProcess(lr=0.1, optimizer="sgd", snapshot_path=snap) as srv:
        c = tps.PSClient(srv.addr, retries=20, retry_backoff=0.05, retry_backoff_max=0.25)
        c.init_param("w", np.zeros(4, np.float32))
        c.push("w", np.ones(4, np.float32))
        c.save()
        port = srv.port
        srv.stop()
        with pytest.raises(ConnectionError):
            c.push("w", np.ones(4, np.float32))
        restarted = {}

        def delayed_restart():
            time.sleep(0.4)
            restarted["srv"] = tps.PServerProcess(port=port, lr=0.1, optimizer="sgd",
                                                  snapshot_path=snap)

        t = threading.Thread(target=delayed_restart)
        t.start()
        try:
            got = c.pull("w", (4,))
            t.join()
            np.testing.assert_allclose(got, -0.1 * np.ones(4), rtol=1e-6)
            c.push("w", np.ones(4, np.float32))
            np.testing.assert_allclose(c.pull("w", (4,)), -0.2 * np.ones(4), rtol=1e-6)
            assert c.report()["reconnects"] >= 1
            c.close()
        finally:
            t.join()
            if "srv" in restarted:
                restarted["srv"].stop()


def test_push_undelivered_is_counted_and_training_goes_on(sgd_server):
    """A trainer whose push reply is lost counts it in ``pushes_lost`` and
    carries on (the at-most-once contract, AsyncPSTrainer.step)."""
    feeds = _mnist_feeds(2, seed=7)
    tr = tps.AsyncPSTrainer(tpt.build(tmnist.mlp), sgd_server.addr, device=CPU,
                            fetch_list=["loss"])
    tr.startup(0, feeds[0])
    real = tr.client._request

    def lose(line, *a, **kw):
        if line.startswith("PUSH ") and " fc_1/w " in line:
            raise tr.client._make_reply_lost(ConnectionError("injected"))
        return real(line, *a, **kw)

    tr.client._request = lose
    assert np.isfinite(float(tr.step(feeds[1])["loss"]))
    assert tr.pushes_lost == 1 and tr.report()["pushes_lost"] == 1
    tr.client.close()
    # journaled with the step's span, and counted in the registry
    lost, step = (tr.journal.recent(kind=k)[-1] for k in ("ps.push_lost", "ps.step"))
    assert lost["span"] == step["span"] and lost["inst"] == tr.telemetry_inst
    assert (lost["param"], lost["step"], step["step"]) == ("fc_1/w", 0, 0)
    assert lost["server"] == f"{sgd_server.addr[0]}:{sgd_server.addr[1]}"
    from paddle_tpu_torch.telemetry import get_registry
    fams = {f.name: f for f in get_registry().collect()}
    assert [v for lab, v in fams["paddle_tpu_ps_pushes_lost_total"].samples
            if lab["inst"] == tr.telemetry_inst] == [1]


# -- routing (tests/test_elastic_reshard.py:390-560) ---------------------------


ADDR_SETS = [
    [("127.0.0.1", 7001), ("127.0.0.1", 7002)],
    [("127.0.0.1", 40123), ("127.0.0.1", 40124), ("10.0.0.7", 9000)],
    [("localhost", 1), ("localhost", 2), ("localhost", 3), ("localhost", 4)],
]


@pytest.mark.parametrize("addrs", ADDR_SETS, ids=["two", "three", "four"])
def test_owner_tables_equal_paddle_tpu(addrs):
    names = ([f"fc_{i}/{p}" for i in range(20) for p in ("w", "b")]
             + ["embedding_0/w", "layer_norm_3/scale", "lm_head_0/w"])
    tg, jg = tps.PSShardGroup(addrs), jps.PSShardGroup(addrs)
    assert {n: tg.owner(n) for n in names} == {n: jg.owner(n) for n in names}
    for n in names:
        for a in addrs:
            assert tps._rendezvous_score(n, a) == jps._rendezvous_score(n, a)
    tg._names, jg._names = set(names), set(names)
    assert tg.shard_map() == jg.shard_map()


def _split_names(old_addrs, new_addrs, n_move=3, n_stay=3):
    """Names chosen against the servers' actual ports so that exactly
    ``n_move`` re-home and ``n_stay`` stay under the resize."""
    movers, stayers = [], []
    for i in range(10_000):
        if len(movers) >= n_move and len(stayers) >= n_stay:
            break
        name = f"p{i}"
        old = max(old_addrs, key=lambda a: tps._rendezvous_score(name, a))
        new = max(new_addrs, key=lambda a: tps._rendezvous_score(name, a))
        (movers if old != new else stayers).append(name)
    return movers[:n_move], stayers[:n_stay]


def test_ps_shard_group_routing_covers_and_aggregates():
    with tps.PServerProcess(lr=0.1) as s1, tps.PServerProcess(lr=0.1) as s2:
        g = tps.PSShardGroup([s1.addr, s2.addr], **_group_kw())
        names = [f"layer{i}/w" for i in range(8)]
        for n in names:
            assert g.init_param(n, np.zeros(4, np.float32))
        assert sorted(sum(g.shard_map().values(), [])) == sorted(names)
        for n in names:
            g.push(n, np.ones(4, np.float32))
        assert g.status()["params"] == len(names) and g.status()["pushes"] == len(names)
        np.testing.assert_allclose(g.pull(names[0], (4,)), -0.1 * np.ones(4), rtol=1e-6)
        assert g.report()["pushes"] == len(names)
        g.close()


def test_ps_shard_split_and_merge_preserve_state():
    lr, g1 = 0.5, np.array([1.0, 2.0, 0.5], np.float32)
    with tps.PServerProcess(lr=lr, optimizer="adagrad") as s1, \
            tps.PServerProcess(lr=lr, optimizer="adagrad") as s2:
        g = tps.PSShardGroup([s1.addr], **_group_kw())
        movers, stayers = _split_names([s1.addr], [s1.addr, s2.addr])
        w = {k: np.arange(3, dtype=np.float32) + i for i, k in enumerate(movers + stayers)}
        for k, v in w.items():
            g.init_param(k, v)
            g.push(k, g1)
        before = {k: g.pull(k, (3,)) for k in w}
        stale = tps.PSShardGroup([s1.addr], **_group_kw())  # never rebound
        moved = g.resize([s1.addr, s2.addr])
        assert sorted(moved) == sorted(movers)
        for k in w:
            np.testing.assert_array_equal(g.pull(k, (3,)), before[k])
        assert g.status()["params"] == len(w)  # the old copies were DELETEd
        with pytest.raises(RuntimeError, match="unknown param"):
            stale.push(moved[0], g1)
        stale.close()
        k = moved[0]
        g.push(k, g1)  # the accumulator moved too
        want = before[k] - lr * g1 / (np.sqrt(2 * g1 * g1) + 1e-6)
        np.testing.assert_allclose(g.pull(k, (3,)), want, rtol=1e-5)
        after_split = {k2: g.pull(k2, (3,)) for k2 in w}
        assert sorted(g.resize([s1.addr])) == sorted(moved)
        for k2 in w:
            np.testing.assert_array_equal(g.pull(k2, (3,)), after_split[k2])
        g.close()


def test_ps_resize_crash_mid_split_is_retryable():
    with tps.PServerProcess(lr=0.1) as s1, tps.PServerProcess(lr=0.1) as s2:
        g = tps.PSShardGroup([s1.addr], **_group_kw())
        movers, stayers = _split_names([s1.addr], [s1.addr, s2.addr])
        w = {k: np.full(3, float(i), np.float32) for i, k in enumerate(movers + stayers)}
        for k, v in w.items():
            g.init_param(k, v)
        tres.crash_points.add("ps_resize:exported")
        try:
            with pytest.raises(tres.InjectedCrash):
                g.resize([s1.addr, s2.addr])
        finally:
            tres.crash_points.discard("ps_resize:exported")
        assert g.addrs == [s1.addr]  # the old membership still serves everything
        for k, v in w.items():
            np.testing.assert_array_equal(g.pull(k, (3,)), v)
        assert g.resize([s1.addr, s2.addr])
        for k, v in w.items():
            np.testing.assert_array_equal(g.pull(k, (3,)), v)
        g.close()


def test_kill_pserver_during_shard_split_drill(tmp_path):
    """The import target dies at ``ps_resize:exported``: the migration fails
    loudly, the old routing stays, and a restarted server (same port,
    snapshot path) lets the same resize succeed with state preserved."""
    snap = str(tmp_path / "s2.snap")
    with tps.PServerProcess(lr=0.1) as s1:
        s2 = tps.PServerProcess(lr=0.1, snapshot_path=snap)
        port2 = s2.port
        try:
            g = tps.PSShardGroup([s1.addr], **_group_kw())
            movers, stayers = _split_names([s1.addr], [s1.addr, s2.addr])
            w = {k: np.full(2, float(i) + 1.0, np.float32)
                 for i, k in enumerate(movers + stayers)}
            for k, v in w.items():
                g.init_param(k, v)
            tres.crash_callbacks["ps_resize:exported"] = s2.stop
            try:
                with pytest.raises(ConnectionError):
                    g.resize([s1.addr, s2.addr])
            finally:
                tres.crash_callbacks.pop("ps_resize:exported")
            assert g.addrs == [s1.addr]
            for k, v in w.items():
                np.testing.assert_array_equal(g.pull(k, (2,)), v)
            s2 = tps.PServerProcess(port=port2, lr=0.1, snapshot_path=snap)
            assert g.resize([s1.addr, s2.addr])
            for k, v in w.items():
                np.testing.assert_array_equal(g.pull(k, (2,)), v)
            g.close()
        finally:
            s2.stop()


def test_async_trainer_rides_through_membership_change():
    feeds = _mnist_feeds(1, seed=3)
    with tps.PServerProcess(lr=0.05) as s1, tps.PServerProcess(lr=0.05) as s2:
        t = tps.AsyncPSTrainer(tpt.build(tmnist.mlp), [s1.addr], fetch_list=["loss"],
                               device=CPU)
        t.startup(0, feeds[0])
        n_leaves = t.client.status()["params"]
        for addrs in ([s1.addr], [s1.addr, s2.addr], [s2.addr]):
            if addrs != [s1.addr]:
                t.client.resize(addrs)
            for _ in range(2):
                assert np.isfinite(float(t.step(feeds[0])["loss"]))
        assert t.pushes_lost == 0
        total = sum(tps.PSClient(a).status()["pushes"] for a in (s1.addr, s2.addr))
        assert total == 6 * n_leaves
        t.client.close()


# -- trainers against the JAX package ------------------------------------------


def _mnist_feeds(n, seed=0, b=32):
    rng = np.random.RandomState(seed)
    return [{"image": rng.randn(b, 784).astype(np.float32),
             "label": rng.randint(0, 10, (b, 1)).astype(np.int64)} for _ in range(n)]


# mode -> (server kwargs, trainer kwargs, strategy kwargs, code levels qmax or
# None; Adagrad is held by its moves)
MODES = {
    "sgd": (dict(optimizer="sgd"), {}, None, None),
    "adagrad": (dict(optimizer="adagrad"), {}, None, None),
    "dc_asgd": (dict(optimizer="sgd", dc_asgd=True, dc_lambda=0.5),
                dict(pull_interval=2), None, None),
    "pushq": (dict(optimizer="sgd"), dict(compress_grads=True), None, 127),
    "pushqb_int8": (dict(optimizer="sgd"), {},
                    dict(quantized_allreduce="int8", quant_block_size=64), 127),
    "pushqb_int4": (dict(optimizer="sgd"), {},
                    dict(quantized_allreduce="int4", quant_block_size=64), 7),
}


def _exported(addr, names):
    c = tps.PSClient(addr)
    out = {n: c.export_param(n)[0] for n in names}
    c.close()
    return out


def jtel_registry():
    from paddle_tpu.telemetry import get_registry
    return get_registry()


def ttel_registry():
    from paddle_tpu_torch.telemetry import get_registry
    return get_registry()


def _start_pair(jprog, tprog, sj, st, feed, trainer_kw, jstrategy=None, tstrategy=None,
                trainer_id=0):
    """A JAX trainer on ``sj`` and a port trainer on ``st``, the port's server
    INITed first with the JAX trainer's initial params."""
    jt = jps.AsyncPSTrainer(jprog, sj.addr, trainer_id=trainer_id, fetch_list=["loss"],
                            strategy=jstrategy, **trainer_kw)
    jparams = jt.startup(sample_feed=feed)
    seed = tps.PSClient(st.addr)
    for name, leaf in jps._named_leaves(jparams):
        assert seed.init_param(name, np.asarray(leaf, np.float32))
    seed.close()
    tt = tps.AsyncPSTrainer(tprog, st.addr, trainer_id=trainer_id, fetch_list=["loss"],
                            strategy=tstrategy, device=CPU, **trainer_kw)
    tt.startup(0, feed)
    return jt, tt


@pytest.mark.parametrize("mode", sorted(MODES))
def test_trainer_matches_paddle_tpu(mode):
    server_kw, trainer_kw, strategy_kw, qmax = MODES[mode]
    feeds = _mnist_feeds(5)
    with tps.PServerProcess(lr=LR, **server_kw) as sj, \
            tps.PServerProcess(lr=LR, **server_kw) as st:
        jt, tt = _start_pair(jpt.build(jmnist.mlp), tpt.build(tmnist.mlp), sj, st, feeds[0],
                             trainer_kw,
                             JStrategy(**strategy_kw) if strategy_kw else None,
                             TStrategy(**strategy_kw) if strategy_kw else None)
        names = [n for n, _ in tps._named_leaves(tt.params)]
        assert names == [n for n, _ in jps._named_leaves(jt.params)]
        init = {n: np.asarray(v, np.float32).reshape(-1) for n, v in jps._named_leaves(jt.params)}
        code_steps = {n: 0.0 for n in names}
        host_grads = tt._host_grads

        def record(grads):  # one code step a push: lr * its largest scale / qmax
            out = host_grads(grads)
            for n, g in out:
                code_steps[n] += LR * float(np.abs(g).max()) / (qmax or 1)
            return out

        tt._host_grads = record
        jl = [float(jt.step(f)["loss"]) for f in feeds[1:]]
        tl = [float(tt.step(f)["loss"]) for f in feeds[1:]]
        # each step's ps.step event and the registry's ps families, as JAX's
        steps = [[(sorted(e), e["step"]) for e in t.journal.recent(kind="ps.")
                  if e["inst"] == t.telemetry_inst] for t in (jt, tt)]
        assert steps[1] == steps[0] == [(["inst", "kind", "run", "seq", "span", "step",
                                          "t"], i) for i in range(4)]
        fams = [sorted(f.name for f in reg.collect() if f.name.startswith("paddle_tpu_ps_")
                       and any(lab.get("inst") == t.telemetry_inst for lab, _ in f.samples))
                for reg, t in ((jtel_registry(), jt), (ttel_registry(), tt))]
        assert fams[1] == fams[0] and len(fams[1]) == 6
        want, got = _exported(sj.addr, names), _exported(st.addr, names)
        assert tt.client.status()["qpushes"] == (4 * len(names) if qmax else 0)
        jt.client.close()
        tt.client.close()
    if mode == "adagrad":
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
        for n in names:
            moved = np.linalg.norm(want[n] - init[n])
            assert np.linalg.norm(got[n] - want[n]) <= MOVE_RTOL * moved, n
    elif qmax is None:
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
        for n in names:
            np.testing.assert_allclose(got[n], want[n], rtol=0, atol=PARAM_ATOL, err_msg=n)
    else:
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        for n in names:
            diff = np.abs(got[n] - want[n])
            assert float(diff.max()) <= code_steps[n] + 1e-5, (n, diff.max())
            assert float(np.mean(diff > 1e-5)) <= 1e-3, (n, np.mean(diff > 1e-5))


def test_mixed_trainers_end_where_two_jax_trainers_do():
    """A JAX trainer (id 0) and a port trainer (id 1) stepping in turn on one
    DC-ASGD server, against two JAX trainers doing the same on another."""
    feeds = _mnist_feeds(7, seed=4)
    kw = dict(optimizer="sgd", dc_asgd=True, dc_lambda=0.5)
    with tps.PServerProcess(lr=LR, **kw) as mixed, tps.PServerProcess(lr=LR, **kw) as ref:
        jprog = jpt.build(jmnist.mlp)
        ja = jps.AsyncPSTrainer(jprog, mixed.addr, trainer_id=0, pull_interval=2,
                                fetch_list=["loss"])
        ja.startup(sample_feed=feeds[0])
        tb = tps.AsyncPSTrainer(tpt.build(tmnist.mlp), mixed.addr, trainer_id=1,
                                pull_interval=2, fetch_list=["loss"], device=CPU)
        tb.startup(0, feeds[0])  # the JAX init is on the server first: pulled
        ra, rb = (jps.AsyncPSTrainer(jprog, ref.addr, trainer_id=i, pull_interval=2,
                                     fetch_list=["loss"]) for i in (0, 1))
        ra.startup(sample_feed=feeds[0])
        rb.startup(sample_feed=feeds[0])
        got, want = [], []
        for s in range(3):
            got += [float(ja.step(feeds[1 + 2 * s])["loss"]),
                    float(tb.step(feeds[2 + 2 * s])["loss"])]
            want += [float(ra.step(feeds[1 + 2 * s])["loss"]),
                     float(rb.step(feeds[2 + 2 * s])["loss"])]
        names = [n for n, _ in tps._named_leaves(tb.params)]
        a, b = _exported(mixed.addr, names), _exported(ref.addr, names)
        for t in (ja, tb, ra, rb):
            t.client.close()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    for n in names:
        np.testing.assert_allclose(a[n], b[n], rtol=0, atol=PARAM_ATOL, err_msg=n)


def test_lone_async_trainer_matches_local_sgd():
    """``pull_interval=1`` with one trainer is local SGD: the server's update
    is the Trainer's ``p - lr·g``, in f32 on both sides."""
    feeds = _mnist_feeds(5, seed=2)
    with tps.PServerProcess(lr=LR, optimizer="sgd", dc_asgd=True) as srv:
        t = tps.AsyncPSTrainer(tpt.build(tmnist.mlp), srv.addr, fetch_list=["loss"],
                               device=CPU)
        init = {k: v.detach().clone() for k, v in t.startup(0, feeds[0]).items()}
        async_losses = [float(t.step(f)["loss"]) for f in feeds]
        got = _exported(srv.addr, sorted(init))
        t.client.close()
    local = tpt.Trainer(tpt.build(tmnist.mlp), topt.SGD(LR), fetch_list=["loss"], place=CPU)
    local.startup(0, feeds[0], params=init)
    local_losses = [float(local.step(f)["loss"]) for f in feeds]
    np.testing.assert_allclose(async_losses, local_losses, rtol=1e-6)
    for k, v in local.scope.params.items():
        np.testing.assert_allclose(got[k], v.detach().numpy().reshape(-1), rtol=0,
                                   atol=1e-7, err_msg=k)


GPT_SMALL = dict(vocab_size=50, max_len=32, d_model=64, d_inner=128, num_heads=2,
                 num_layers=2, use_flash=True, fused_ce=True, ce_chunk=16, dropout=0.0)


def test_gpt_flash_path_through_both_async_trainers(monkeypatch):
    """A 2-layer d 64 GPT at dropout 0: the port's trainer runs the flash
    path (its plain versions on the CPU, forward and backward once a layer
    a step) against the JAX trainer's interpreted kernels."""
    rng = np.random.RandomState(0)
    feeds = []
    for _ in range(3):
        ids = rng.randint(3, 50, (2, 16)).astype(np.int32)
        feeds.append({"ids": ids, "labels": np.concatenate(
            [ids[:, 1:], np.full((2, 1), 2)], 1).astype(np.int32)})
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tfa.flash_attention_reference, tfa.flash_attention_bwd_reference
    monkeypatch.setattr(tfa, "flash_attention_reference",
                        lambda *a, **k: calls.__setitem__("fwd", calls["fwd"] + 1)
                        or fwd(*a, **k))
    monkeypatch.setattr(tfa, "flash_attention_bwd_reference",
                        lambda *a, **k: calls.__setitem__("bwd", calls["bwd"] + 1)
                        or bwd(*a, **k))
    with tps.PServerProcess(lr=LR) as sj, tps.PServerProcess(lr=LR) as st:
        jt, tt = _start_pair(jpt.build(jgpt.make_model(jgpt.base_config(**GPT_SMALL))),
                             tpt.build(tgpt.make_model(tgpt.base_config(**GPT_SMALL))),
                             sj, st, feeds[0], {})
        calls.update(fwd=0, bwd=0)
        jl = [float(jt.step(f)["loss"]) for f in feeds[1:]]
        tl = [float(tt.step(f)["loss"]) for f in feeds[1:]]
        names = [n for n, _ in tps._named_leaves(tt.params)]
        want, got = _exported(sj.addr, names), _exported(st.addr, names)
        jt.client.close()
        tt.client.close()
    assert calls == {"fwd": 2 * 2, "bwd": 2 * 2}
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    for n in names:
        np.testing.assert_allclose(got[n], want[n], rtol=0, atol=2e-5, err_msg=n)


# -- the SPMD Trainer refuses async_mode ---------------------------------------


def test_trainer_refuses_async_mode_as_paddle_tpu_does():
    with pytest.raises(EnforceError, match="AsyncPSTrainer") as got:
        tpt.Trainer(tpt.build(tmnist.mlp), topt.SGD(0.1), place=CPU,
                    strategy=TStrategy(async_mode=True))
    with pytest.raises(Exception) as want:
        jpt.Trainer(jpt.build(jmnist.mlp), None, strategy=JStrategy(async_mode=True))
    assert str(got.value) == str(want.value)
    assert not isinstance(got.value, NotImplementedError)  # not NotYetPorted
