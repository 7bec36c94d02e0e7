"""The port's RecordIO, dataset master and ``layers.io`` against the JAX
package's on the same numpy records from a seed:

- ``Writer``/``write_arrays`` files byte-identical, compressed and raw,
  at two ``chunk_bytes``; each package's ``Scanner``/``read_arrays``
  reads the other's files;
- a port ``MasterClient`` against the JAX master server and a JAX client
  against the port's (the port builds its own copy of ``master.cc``):
  the same lease order, ``FAIL`` requeue, ``failure_max`` discard, lease
  timeout and snapshot recovery as the same drill between the JAX
  package's own client and server;
- ``task_reader`` and ``layers.io.open_files``/``batch``/``shuffle``/
  ``PyReader`` yielding the JAX functions' samples; ``layers.io.load`` on
  ``.npy`` and single-entry ``.npz`` files; ``layers.io.data`` as a
  ``Trainer.startup`` sample;
- ``build_native`` rebuilding when only the flags change."""

import os
import time

import numpy as np
import pytest
import torch

from paddle_tpu import recordio as jrio
from paddle_tpu.data import master as jmaster
from paddle_tpu.layers import io as jlio

import paddle_tpu_torch as tpt
from paddle_tpu_torch import native as tnative
from paddle_tpu_torch import recordio as trio
from paddle_tpu_torch.core.errors import EnforceError
from paddle_tpu_torch.data import master as tmaster
from paddle_tpu_torch.layers import io as tlio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _records(seed, n=40):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, rng.randint(0, 3000)).astype(np.uint8).tobytes()
            for _ in range(n)]


def _samples(seed, n=24):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 256, (8, 8, 3)).astype(np.uint8),
             np.array([rng.randint(0, 10)], dtype=np.int64),
             rng.randn(5).astype(np.float32)) for _ in range(n)]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _assert_samples_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_the_native_sources_are_the_jax_sources():
    for src in ("recordio.cc", "master.cc"):
        assert _read(os.path.join(REPO, "paddle_tpu_torch", "native", src)) == \
            _read(os.path.join(REPO, "paddle_tpu", "native", src)), src


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("chunk_bytes", [4096, 1 << 20])
def test_writer_files_are_byte_identical(tmp_path, compress, chunk_bytes):
    recs = _records(0)
    paths = {}
    for name, rio in (("jax", jrio), ("port", trio)):
        paths[name] = str(tmp_path / f"{name}.rio")
        with rio.Writer(paths[name], compress=compress, chunk_bytes=chunk_bytes) as w:
            for r in recs:
                w.write(r)
    assert _read(paths["port"]) == _read(paths["jax"])
    assert list(trio.Scanner(paths["jax"])) == recs
    assert list(jrio.Scanner(paths["port"])) == recs


@pytest.mark.parametrize("compress", [True, False])
def test_array_files_byte_identical_and_read_across(tmp_path, compress):
    samples = _samples(1)
    jp, tp = str(tmp_path / "j.rio"), str(tmp_path / "t.rio")
    assert jrio.write_arrays(jp, samples, compress=compress) == len(samples)
    assert trio.write_arrays(tp, samples, compress=compress) == len(samples)
    assert _read(tp) == _read(jp)
    _assert_samples_equal(list(trio.read_arrays(jp)), samples)
    _assert_samples_equal(list(jrio.read_arrays(tp)), samples)
    _assert_samples_equal(list(trio.reader_creator(jp)()),
                          list(jrio.reader_creator(tp)()))


def test_port_scanner_detects_corruption(tmp_path):
    p = str(tmp_path / "c.rio")
    with jrio.Writer(p) as w:
        w.write(b"a" * 1000)
    data = bytearray(_read(p))
    data[-10] ^= 0xFF
    with open(p, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(IOError):
        list(trio.Scanner(p))


# -- the master: each package's client against the other's server -----------


def _drain(client, out, finish=True):
    while True:
        t = client.get_task(wait=False)
        if t is None:
            return
        out.append(("lease", t[0], t[1].decode()))
        if finish:
            client.finish_task(t[0])


def _drill(client_mod, server_mod, tmp):
    """The master's contract as one scripted trace: lease order, FAIL
    requeue then discard at failure_max, a lease timeout's requeue, a
    reset pass, and snapshot recovery after a kill."""
    trace = []
    with server_mod.MasterServer(failure_max=2) as srv:
        c = client_mod.MasterClient(srv.addr)
        trace.append(("ids", c.set_tasks([f"shard-{i}" for i in range(4)])))
        tid, payload = c.get_task()
        trace.append(("first", tid, payload.decode()))
        c.fail_task(tid)                      # failure 1: requeued at the back
        trace.append(("status", c.status()))
        order = []
        while True:
            t = c.get_task(wait=False)
            if t is None:
                break
            order.append((t[0], t[1].decode()))
            if t[1] == b"shard-0":
                c.fail_task(t[0])             # failure 2 == failure_max: discarded
            else:
                c.finish_task(t[0])
        trace.append(("order", order))
        trace.append(("status", c.status()))
        trace.append(("reset", c.reset_pass()))
        _drain(c, trace)
        trace.append(("status", c.status()))
        c.close()
    with server_mod.MasterServer(failure_max=5, lease_timeout_ms=300) as srv:
        a, b = client_mod.MasterClient(srv.addr), client_mod.MasterClient(srv.addr)
        a.set_tasks(["t"])
        tid, _ = a.get_task()
        trace.append(("leased-elsewhere", b.get_task(wait=False)))
        deadline, got = time.time() + 5, None
        while got is None and time.time() < deadline:
            got = b.get_task(wait=False)
            time.sleep(0.05)
        trace.append(("timed-out", got[0] == tid, got[1]))
        a.close()
        b.close()
    snap = os.path.join(tmp, f"{client_mod.__name__}-{server_mod.__name__}.snap")
    srv = server_mod.MasterServer(snapshot_path=snap, failure_max=3)
    c = client_mod.MasterClient(srv.addr)
    c.set_tasks(["a", "b", "c"])
    tid, _ = c.get_task()
    c.finish_task(tid)
    c.get_task()                              # leased, never finished
    c.close()
    srv.stop()                                # hard kill
    with server_mod.MasterServer(snapshot_path=snap) as srv2:
        c2 = client_mod.MasterClient(srv2.addr)
        trace.append(("recovered", c2.status()))
        _drain(c2, trace)
        c2.close()
    return trace


@pytest.fixture(scope="module")
def jax_drill(tmp_path_factory):
    return _drill(jmaster, jmaster, str(tmp_path_factory.mktemp("jdrill")))


@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port")])
def test_master_drill_across_packages(tmp_path, jax_drill, client, server):
    mods = {"port": tmaster, "jax": jmaster}
    got = _drill(mods[client], mods[server], str(tmp_path))
    assert got == jax_drill
    # and the trace is the contract master.cc states: the failed task
    # requeued at the back, discarded at its second failure, a reset pass
    # re-leasing the rest, a timed-out lease re-leased, and a recovery
    # that keeps what was done and requeues the lease
    statuses = [e[1] for e in got if e[0] in ("status", "recovered")]
    assert got[3] == ("order", [(1, "shard-1"), (2, "shard-2"), (3, "shard-3"),
                                (0, "shard-0")])
    assert statuses[1]["discarded"] == 1 and statuses[1]["done"] == 3
    assert statuses[2]["pass"] == 1 and statuses[2]["todo"] == 0
    assert ("timed-out", True, b"t") in got
    assert statuses[3] == {"todo": 2, "leased": 0, "done": 1, "discarded": 0,
                           "pass": 0, "total": 3}


def test_the_port_server_is_the_ports_build():
    with tmaster.MasterServer() as srv:
        exe = os.readlink(f"/proc/{srv._proc.pid}/exe")
    assert exe.startswith(tnative.BUILD_DIR) and "master_server-" in exe


def _shards(tmp, seed, n=3, per=5):
    paths = []
    rng = np.random.RandomState(seed)
    for i in range(n):
        p = os.path.join(tmp, f"shard{i}.rio")
        jrio.write_arrays(p, [(rng.randint(0, 256, (4, 4, 3)).astype(np.uint8),
                               np.array([i * 100 + j], dtype=np.int64))
                              for j in range(per)], compress=i % 2 == 0)
        paths.append(p)
    return paths


def test_task_reader_yields_the_jax_samples(tmp_path):
    paths = _shards(str(tmp_path), 2)
    got = {}
    for name, mod, rio in (("jax", jmaster, jrio), ("port", tmaster, trio)):
        with mod.MasterServer(failure_max=1) as srv:
            c = mod.MasterClient(srv.addr)
            # one missing shard: its reader raises, the task is failed and
            # (failure_max=1) discarded
            c.set_tasks(paths + [str(tmp_path / "missing.rio")])
            got[name] = list(mod.task_reader(c, lambda p, rio=rio: rio.reader_creator(p))())
            got[name + "_status"] = c.status()
            c.close()
    _assert_samples_equal(got["port"], got["jax"])
    assert len(got["port"]) == 15
    assert got["port_status"] == got["jax_status"] and got["port_status"]["discarded"] == 1


def test_layers_io_readers_yield_the_jax_samples(tmp_path):
    paths = _shards(str(tmp_path), 3)
    t_files, j_files = tlio.open_files(paths), jlio.open_files(paths)
    _assert_samples_equal(list(t_files()), list(j_files()))
    _assert_samples_equal(list(tlio.open_files(paths, buffer_size=4)()), list(j_files()))
    tb = list(tlio.batch(t_files, 4, drop_last=True)())
    jb = list(jlio.batch(j_files, 4, drop_last=True)())
    assert [len(b) for b in tb] == [len(b) for b in jb] == [4, 4, 4]
    for a, b in zip(tb, jb):
        _assert_samples_equal(a, b)
    assert len(list(tlio.batch(t_files, 4)())) == len(list(jlio.batch(j_files, 4)())) == 4
    # shuffle draws its order from an unseeded generator in both packages:
    # the same samples, in some order
    key = lambda s: int(s[1][0])   # noqa: E731
    assert sorted(map(key, tlio.shuffle(t_files, 6)())) == \
        sorted(map(key, jlio.shuffle(j_files, 6)())) == sorted(map(key, t_files()))
    tr, jr = tlio.py_reader(8, None, None, use_double_buffer=False), \
        jlio.py_reader(8, None, None, use_double_buffer=False)
    tr.decorate_paddle_reader(t_files)
    jr.decorate_paddle_reader(j_files)
    _assert_samples_equal(list(tr.start()), list(jr.start()))
    def pre(sample):
        return sample[0].astype(np.float32) / 255.0, sample[1]
    _assert_samples_equal(list(tlio.Preprocessor(t_files)(pre)()),
                          list(jlio.Preprocessor(j_files)(pre)()))
    _assert_samples_equal([tlio.read_file(t_files)], [jlio.read_file(j_files)])
    g_t = tlio.random_data_generator(-1.0, 1.0, [(2, 3), (4,)])()
    g_j = jlio.random_data_generator(-1.0, 1.0, [(2, 3), (4,)])()
    _assert_samples_equal([next(g_t), next(g_t)], [next(g_j), next(g_j)])


def test_double_buffer_is_the_device_feeder_and_refuses_the_cpu(tmp_path):
    reader = lambda: iter([{"x": np.zeros(2, np.float32)}])   # noqa: E731
    with pytest.raises(EnforceError, match="CUDA stream"):
        tlio.double_buffer(reader, place=tpt.CPUPlace())
    r = tlio.py_reader(4, None, None, place="cpu")
    r.decorate_paddle_reader(reader)
    with pytest.raises(EnforceError, match="CUDA stream"):
        r.start()


@pytest.mark.parametrize("kind", ["npy", "npz"])
def test_load_equals_the_jax_load(tmp_path, kind):
    a = np.random.RandomState(4).randn(3, 5).astype(np.float32)
    p = str(tmp_path / f"a.{kind}")
    if kind == "npy":
        np.save(p, a)
    else:
        np.savez(p, only=a)
    got, want = tlio.load(None, p), np.asarray(jlio.load(None, p))
    assert isinstance(got, torch.Tensor) and np.array_equal(got.numpy(), want)
    assert np.array_equal(tlio.load(None, p, load_as_fp16=True).numpy(),
                          np.asarray(jlio.load(None, p, load_as_fp16=True)))
    # an exemplar's dtype is the result's (the JAX package's array is then
    # narrowed to f32 by jnp.asarray without x64)
    assert tlio.load(np.zeros(1, np.float64), p).dtype == torch.float64


def test_load_refuses_a_multi_entry_npz(tmp_path):
    p = str(tmp_path / "two.npz")
    np.savez(p, a=np.zeros(2), b=np.ones(2))
    with pytest.raises(EnforceError, match="holds 2 arrays"):
        tlio.load(None, p)


def test_data_placeholders_start_a_trainer():
    from paddle_tpu_torch.models import mnist
    image, label = tlio.data("image", [784]), tlio.data("label", [1], "int64")
    j_image, j_label = jlio.data("image", [784]), jlio.data("label", [1], "int64")
    assert image.is_meta and tuple(image.shape) == tuple(j_image.shape) == (1, 784)
    assert label.dtype == torch.int64 and str(j_label.dtype) == "int64"
    tr = tpt.Trainer(tpt.build(mnist.mlp), tpt.optimizer.SGD(0.1), place=tpt.CPUPlace())
    tr.startup(0, sample_feed={"image": image, "label": label})
    rng = np.random.RandomState(0)
    out = tr.step({"image": rng.randn(4, 784).astype(np.float32),
                   "label": rng.randint(0, 10, (4, 1)).astype(np.int64)})
    assert np.isfinite(float(out["loss"]))


def test_build_native_rebuilds_when_only_the_flags_change(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path))
    kw = dict(extra_flags=("-shared", "-fPIC"), libs=("-lz",))
    o3 = tnative.build_native("recordio.cc", "librecordio.so", opt="-O3", **kw)
    again = tnative.build_native("recordio.cc", "librecordio.so", opt="-O3", **kw)
    o2 = tnative.build_native("recordio.cc", "librecordio.so", opt="-O2", **kw)
    assert o3 == again and o2 != o3
    for p in (o2, o3):
        name = os.path.basename(p)
        assert name.startswith("librecordio-") and name.endswith(".so") and os.path.exists(p)
    assert sorted(os.listdir(tmp_path)) == sorted(map(os.path.basename, (o2, o3)))
    # the pserver keeps its flags: -O2 -std=c++17 -pthread, no library
    srv = tnative.build_native("pserver.cc", "pserver_server")
    assert os.path.basename(srv).startswith("pserver_server-") and os.access(srv, os.X_OK)
