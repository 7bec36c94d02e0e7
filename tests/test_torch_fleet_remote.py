"""The cross-process and cross-host serving fleet of the port
(``paddle_tpu_torch.fleet.remote``, ``replica_main``, ``agent``) on the
CPU, and its wire against ``paddle_tpu.fleet.remote``'s.

- ``pack_tree`` meta and payload bytes equal the JAX package's for f32,
  int32, int64 and bf16 leaves (a bf16 tensor travels as its bit
  patterns), with and without ``WireSpec`` narrowing; ``unpack_tree``
  reads the JAX package's bytes; the wire counters agree.
- ``error_payload``/``build_remote_error`` against the JAX classes.
- ``ArtifactStore``: staging, a resumed torn transfer, a corrupt chunk
  dropped and re-shipped, the atomic commit.
- One module-scoped set of three port replica processes on the CPU
  (MNIST MLP at buckets [4, 8], params carried from ``paddle_tpu``):
  replies bit-identical to the in-process ``Predictor`` (the same
  program on the same CPU); one trace id across both processes'
  journals; a ``LinkProxy`` partition bounded by the probe; a remote
  rolling reload; SIGKILL at saturation with no accepted request
  dropped, ``ReplicaDied`` at most once, ``replace`` respawning; the JAX
  package's ``RemoteReplica`` in this process adopting a port replica
  (submit, a bf16-narrowed submit, health, kill).
- One agent process: ``ship`` (and the cached no-op), ``spawn``,
  ``ps`` and ``stop``."""

import json
import os
import shutil
import time
import zlib

import ml_dtypes
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as jpt
from paddle_tpu import io as jio
from paddle_tpu import serving as jserving
from paddle_tpu.data.wire import WireSpec as JWireSpec
from paddle_tpu.fleet import remote as jremote
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.resilience import CheckpointCorrupt as JCheckpointCorrupt

import paddle_tpu_torch as tpt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch import telemetry as ttel
from paddle_tpu_torch.data.wire import WireSpec
from paddle_tpu_torch.fleet import BatchPolicy, FleetRouter
from paddle_tpu_torch.fleet import remote as tremote
from paddle_tpu_torch.framework import params_from_jax
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.testing import faults

CPU = "cpu"
REMOTE_KW = dict(probe_timeout=0.5, down_cooldown=0.4, submit_timeout=3.0,
                 connect_timeout=1.0, reload_timeout=30.0)
SERVER_KW = dict(workers=1, queue_size=16, batch_policy=BatchPolicy(max_wait_ms=2.0))


def _feed(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"image": rng.randn(n, 784).astype(np.float32),
            "label": rng.randint(0, 10, (n, 1)).astype(np.int64)}


def _single(feed, i):
    return {k: np.asarray(v)[i % 8:i % 8 + 1] for k, v in feed.items()}


def _padded(feed, n):
    return {k: np.concatenate([v, np.zeros((n - len(v),) + v.shape[1:], v.dtype)])
            for k, v in feed.items()}


# -- the wire, unit by unit -------------------------------------------------------

def _bf16(x):
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)


LEAVES = {
    "f32": lambda: np.linspace(-3, 3, 24, dtype=np.float32).reshape(2, 3, 4),
    "i32": lambda: np.arange(-6, 6, dtype=np.int32).reshape(3, 4),
    "i64": lambda: np.array([[3], [7]], np.int64),
    "bf16": lambda: _bf16(np.linspace(-2, 2, 10)),
    "scalar": lambda: np.float32(2.5),
}


def _as_port(v):
    """A leaf as the port hands it over: a bf16 array as a bf16 tensor."""
    if getattr(v, "dtype", None) == ml_dtypes.bfloat16:
        return torch.from_numpy(np.asarray(v).view(np.int16)).view(torch.bfloat16)
    return v


@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_pack_tree_bytes_equal_jax(leaf):
    v = LEAVES[leaf]()
    feed = {"x": v, "label": LEAVES["i64"]()}
    assert tremote.pack_tree({k: _as_port(a) for k, a in feed.items()}) == \
        jremote.pack_tree(feed)
    assert tremote.pack_tree(feed) == jremote.pack_tree(feed)   # ml_dtypes arrays too
    assert tremote.pack_tree(_as_port(v)) == jremote.pack_tree(v)
    assert tremote.pack_tree([v, v]) == jremote.pack_tree([v, v])
    assert tremote.pack_tree((v,)) == jremote.pack_tree((v,))


WIRES = {
    "cast_bf16": ("cast", ("bfloat16",)),
    "cast_f16": ("cast", ("float16",)),
    "quantize_u8": ("quantize", ("uint8", 0.02, 128.0)),
    "image_u8": ("image_uint8", ()),
}


@pytest.mark.parametrize("name", sorted(WIRES))
def test_narrowed_pack_tree_bytes_and_unpack_counters_equal_jax(name):
    kind, args = WIRES[name]
    feed = {"image": np.linspace(-1, 1, 784, dtype=np.float32).reshape(1, 784),
            "label": np.array([[3]], np.int64)}
    jspec, tspec = getattr(JWireSpec, kind)(*args), getattr(WireSpec, kind)(*args)
    jm, jp = jremote.pack_tree(feed, wire={"image": jspec})
    assert tremote.pack_tree(feed, wire={"image": tspec}) == (jm, jp)
    # the spec's field dict (what rides a SUBMIT meta item) works as well
    assert tremote.pack_tree(feed, wire={"image": vars(tspec)}) == (jm, jp)
    jc, tc = {}, {}
    want = jremote.unpack_tree(jm, jp, counters=jc)
    got = tremote.unpack_tree(jm, jp, counters=tc)
    assert tc == jc
    for k in feed:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_unpack_tree_reads_jax_bytes_and_keeps_bf16_bits():
    feed = {k: f() for k, f in LEAVES.items()}
    meta, payload = jremote.pack_tree(feed)
    back = tremote.unpack_tree(meta, payload)
    for k, v in feed.items():
        if k == "bf16":
            assert back[k].dtype == torch.bfloat16
            assert back[k].view(torch.int16).numpy().tobytes() == np.asarray(v).tobytes()
        else:
            assert back[k].dtype == np.asarray(v).dtype
            np.testing.assert_array_equal(back[k], v)
    tup = tremote.unpack_tree(*jremote.pack_tree((feed["f32"], feed["i32"])))
    assert isinstance(tup, tuple) and len(tup) == 2


def _errors(io, serving, ckpt):
    return [io.InvalidRequest("image", "shape drift"), serving.ServerOverloaded(9, 8),
            serving.CircuitOpen(1.25), serving.ReloadFailed("/tmp/x", "canary failed"),
            ckpt("/tmp/y", "torn write"), serving.DeadlineExceeded("too late"),
            serving.WorkerHung("wedged"), serving.ServerClosed("closed"),
            serving.ReplicaDied("gone"), serving.ServingError("plain")]


def test_error_payloads_and_rebuilt_classes_equal_jax():
    jerrs = _errors(jio, jserving, JCheckpointCorrupt)
    terrs = _errors(tio, tserving, tres.CheckpointCorrupt)
    for je, te in zip(jerrs, terrs):
        jname, jdetail = jremote.error_payload(je)
        assert tremote.error_payload(te) == (jname, jdetail)
        back = tremote.build_remote_error(jname, jdetail)
        assert type(back).__name__ == type(je).__name__ == type(te).__name__
        assert type(back) is type(te)
        assert tremote.error_payload(back) == (jname, jdetail)
        # and the JAX client rebuilds the port's payloads as its own classes
        assert type(jremote.build_remote_error(*tremote.error_payload(te))) is type(je)
    novel = tremote.build_remote_error("SomethingNovel", {"message": "m"})
    assert type(novel) is tserving.ServingError and "SomethingNovel" in str(novel)


# -- the artifact door --------------------------------------------------------------


def _chunks(path, fname, start=0, chunk=4096):
    with open(path, "rb") as f:
        f.seek(start)
        off = start
        while True:
            data = f.read(chunk)
            if not data:
                return
            yield fname, off, zlib.crc32(data) & 0xFFFFFFFF, data
            off += len(data)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_artifact_store_stages_resumes_drops_corrupt_chunks_and_commits(artifacts, tmp_path):
    src = artifacts["v1"]
    man, token = tio.artifact_fingerprint(src)
    expected = {n: {"crc32": int(s["crc32"]), "size": int(s["size"])}
                for n, s in man["files"].items()}
    crc, size = tres._crc32_file(os.path.join(src, tres.MANIFEST_NAME))
    expected[tres.MANIFEST_NAME] = {"crc32": crc, "size": size}
    store = tremote.ArtifactStore(str(tmp_path / "cache"))
    negotiate = json.dumps({"token": token, "files": expected, "commit": False}).encode()
    commit = json.dumps({"token": token, "commit": True}).encode()
    st = store.handle_fetch(token, negotiate)
    final = os.path.join(store.root, token)
    assert st == {"complete": False, "have": {}, "path": final}
    # a torn transfer: 8 KiB of params.npz, then a resumed negotiation
    for fname, off, c, data in _chunks(os.path.join(src, "params.npz"), "params.npz"):
        if off >= 8192:
            break
        store.handle_chunk(token, fname, off, c, data)
    assert store.handle_fetch(token, negotiate)["have"] == {"params.npz": 8192}
    assert not os.path.isdir(final)
    # ship the rest, one chunk of meta.json corrupted in flight: dropped
    for name in expected:
        start = 8192 if name == "params.npz" else 0
        for fname, off, c, data in _chunks(os.path.join(src, name), name, start=start):
            if name == "meta.json":
                data = b"X" + data[1:]
            store.handle_chunk(token, fname, off, c, data)
    st = store.handle_fetch(token, commit)
    assert st["complete"] is False and st["bad"] == ["meta.json"]
    for fname, off, c, data in _chunks(os.path.join(src, "meta.json"), "meta.json"):
        store.handle_chunk(token, fname, off, c, data)
    assert store.handle_fetch(token, commit) == {"complete": True, "path": final}
    assert sorted(os.listdir(final)) == sorted(os.listdir(src))
    for n in os.listdir(src):
        assert _read(os.path.join(src, n)) == _read(os.path.join(final, n)), n
    assert tres.validate_checkpoint(final)
    with pytest.raises(ValueError):
        store.handle_fetch("../up", b"{}")


# -- replica processes -------------------------------------------------------------


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("rfleet")
    feed8 = _feed(8)
    params, _ = jpt.build(jmnist.mlp).init(jax.random.PRNGKey(0), **feed8)
    out = {"feed8": feed8}
    for name, scale in (("v1", 1.0), ("v2", 0.5)):
        d = str(root / name)
        p = {k: np.asarray(v) * scale for k, v in params.items()}
        tio.save_inference_model(d, tpt.build(tmnist.mlp), params_from_jax(p, device=CPU),
                                 {}, feed8, batch_buckets=[4, 8])
        out[name] = d
    return out


@pytest.fixture(scope="module")
def procs(artifacts):
    """Three port replica processes, started together."""
    ps = [tremote.ReplicaProcess(artifacts["v1"], server_kw=dict(
        SERVER_KW, golden_feed=artifacts["feed8"]), device=CPU) for _ in range(3)]
    try:
        for p in ps:
            p.wait_ready(timeout=120)
        yield ps
    finally:
        for p in ps:
            p.stop()


@pytest.fixture(scope="module")
def fleet(artifacts, procs):
    reps = {f"r{i}": tremote.RemoteReplica(procs[i].addr, proc=procs[i], name=f"r{i}",
                                           num_workers=1, **REMOTE_KW) for i in range(2)}
    router = FleetRouter(reps, dirname=artifacts["v1"], remote=True, device=CPU,
                         server_kw=dict(SERVER_KW, golden_feed=artifacts["feed8"]),
                         probe_timeout=2.0, remote_kw=dict(REMOTE_KW))
    yield router
    router.close(drain=False, timeout=10)


@pytest.fixture()
def journal():
    old = ttel.set_journal(ttel.RunJournal())
    try:
        yield ttel.get_journal()
    finally:
        ttel.set_journal(old).close()


def test_process_fleet_replies_bit_identical_to_the_predictor(artifacts, fleet):
    base = tio.load_inference_model(artifacts["v1"], device=CPU)
    for i in range(4):
        feed = _single(artifacts["feed8"], i)
        out = fleet.run(feed, timeout=60)
        ref = base.run(_padded(feed, 4))
        assert isinstance(out["logits"], np.ndarray)
        assert out["logits"].tobytes() == ref["logits"][:1].numpy().tobytes()
    h = fleet.health()
    assert h["state"] == "ready" and h["replicas_ready"] == 2
    rep = fleet.report()
    assert sorted(rep["replicas"]) == ["r0", "r1"]
    assert all(r["compiles_since_warmup"] == 0 for r in rep["replicas"].values())
    fams = fleet.metrics_families()
    assert ttel.validate_families(fams) == []
    assert {"r0", "r1", "router"} <= {lab.get("replica") for f in fams for lab, _ in f.samples}


def test_one_trace_id_across_both_processes_journals(artifacts, fleet, journal):
    p = fleet.submit(_single(artifacts["feed8"], 0))
    p.result(timeout=60)
    assert "fleet.remote_submit" in {e["kind"] for e in journal.recent(span=p.span)}
    events = fleet.replica(p.replica).journal_events()
    assert {"serving.submit", "serving.dispatch", "serving.complete"} <= \
        {e["kind"] for e in events if e.get("span") == p.span}
    assert fleet.ship_journals() > 0
    shipped = [e for e in journal.recent(span=p.span) if e.get("origin")]
    assert {"serving.submit", "serving.complete"} <= {e["kind"] for e in shipped}
    assert journal.ingested > 0 and fleet.ship_journals() == 0


def test_partitioned_replica_is_bounded_by_the_probe(artifacts, procs):
    proxy = faults.LinkProxy(procs[1].addr)
    try:
        reps = {"good": tremote.RemoteReplica(procs[0].addr, name="good", **REMOTE_KW),
                "cut": tremote.RemoteReplica(proxy.addr, name="cut", **REMOTE_KW)}
        router = FleetRouter(reps, probe_timeout=0.8, remote=True)
        faults.partition(proxy)
        t0 = time.monotonic()
        h = router.health()
        assert time.monotonic() - t0 < 4.0
        assert h["state"] == "degraded" and not h["replicas"]["cut"]["ready"]
        assert h["replicas"]["cut"]["state"].startswith(("unreachable", "probe_timeout"))
        assert "logits" in router.run(_single(artifacts["feed8"], 0), timeout=60)
        assert router.report()["routed"]["good"] >= 1
        faults.heal(proxy)
    finally:
        proxy.close()


def test_remote_rolling_reload_and_back(artifacts, fleet):
    feed = _single(artifacts["feed8"], 3)
    v2 = tio.load_inference_model(artifacts["v2"], device=CPU).run(_padded(feed, 4))
    gens = fleet.reload(artifacts["v2"])
    assert sorted(gens) == ["r0", "r1"] and set(gens.values()) == {2}
    for _ in range(2):
        assert fleet.run(feed, timeout=60)["logits"].tobytes() == \
            v2["logits"][:1].numpy().tobytes()
    assert fleet.reload(artifacts["v1"]) == {"r0": 3, "r1": 3}
    assert fleet.dirname == artifacts["v1"]
    corrupt = os.path.join(os.path.dirname(artifacts["v2"]), "corrupt")
    shutil.copytree(artifacts["v2"], corrupt)
    faults.flip_byte(corrupt, "params.npz")
    with pytest.raises(tres.CheckpointCorrupt):
        fleet.reload(corrupt)
    assert all(fleet.replica(n).generation == 3 for n in fleet.replica_names)
    assert fleet.report()["reload_failures"] == 1


def test_sigkill_at_saturation_drops_nothing_and_replace_respawns(artifacts, fleet):
    for _ in range(2):
        fleet.run(_single(artifacts["feed8"], 0), timeout=60)
    pending = [fleet.submit(_single(artifacts["feed8"], i)) for i in range(24)]
    victim = pending[0].replica
    faults.kill_process(fleet.replica(victim))
    outcomes = {"ok": 0}
    for p in pending:
        try:
            p.result(timeout=60)
            outcomes["ok"] += 1
        except BaseException as e:
            outcomes[type(e).__name__] = outcomes.get(type(e).__name__, 0) + 1
    assert set(outcomes) <= {"ok", "ReplicaDied"}, outcomes
    assert outcomes["ok"] >= 1
    assert fleet.health()["state"] in ("degraded", "unavailable")
    fleet.replace(victim)             # a fresh process, on the CPU
    assert fleet.health()["state"] == "ready"
    assert fleet.replica(victim).proc.poll() is None
    assert "logits" in fleet.run(_single(artifacts["feed8"], 1), timeout=60)


def test_jax_remote_replica_serves_through_a_port_replica(artifacts, procs):
    proc = procs[2]
    base = tio.load_inference_model(artifacts["v1"], device=CPU)
    rep = jremote.RemoteReplica(proc.addr, name="port", **REMOTE_KW)
    feed = _single(artifacts["feed8"], 5)
    out = rep.run(feed, timeout=60)
    assert out["logits"].tobytes() == base.run(_padded(feed, 4))["logits"][:1].numpy().tobytes()
    h = rep.health()
    assert h["state"] == "ready" and h["pid"] == proc.pid and h["generation"] == 1
    # a bf16-narrowed SUBMIT from the JAX client decodes on the port replica
    narrow = jremote.RemoteReplica(proc.addr, name="port-bf16",
                                   feed_wire={"image": JWireSpec.cast("bfloat16")},
                                   **REMOTE_KW)
    out = narrow.run(feed, timeout=60)
    rounded = dict(feed, image=np.asarray(feed["image"]).astype(ml_dtypes.bfloat16)
                   .astype(np.float32))
    assert out["logits"].tobytes() == \
        base.run(_padded(rounded, 4))["logits"][:1].numpy().tobytes()
    wire = tremote.RemoteReplica(proc.addr, **REMOTE_KW).report()["feed_wire"]
    assert wire["wire_bytes"] < wire["logical_bytes"]
    rep.kill(reason="adopted by the JAX package")
    proc.wait(timeout=10)
    assert proc.poll() == 0


def test_one_agent_ships_spawns_and_stops(artifacts, tmp_path):
    from paddle_tpu_torch.fleet.agent import AgentProcess

    agent = AgentProcess(str(tmp_path / "host"))
    cli = None
    try:
        cli = tremote.AgentClient(agent.wait_ready())
        path = cli.ship(artifacts["v1"])
        assert cli.ship(artifacts["v1"]) == path       # cached: a no-op
        assert tres.validate_checkpoint(path)
        rep = tremote.adopt_replica(cli, artifacts["v1"], "h0", remote_kw=dict(REMOTE_KW),
                                    device=CPU, workers=1)
        feed = _single(artifacts["feed8"], 2)
        want = tio.load_inference_model(artifacts["v1"], device=CPU).run(_padded(feed, 4))
        assert rep.run(feed, timeout=60)["logits"].tobytes() == \
            want["logits"][:1].numpy().tobytes()
        ps = {p["pid"]: p for p in cli.ps()["procs"]}
        assert ps[rep.pid]["alive"] and ps[rep.pid]["name"] == "h0"
        cli.stop(rep.pid)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not rep._provably_dead():
            time.sleep(0.1)
        assert rep._provably_dead()
        assert not {p["pid"]: p for p in cli.ps()["procs"]}[rep.pid]["alive"]
    finally:
        if cli is not None:
            cli.close()
        agent.stop()
