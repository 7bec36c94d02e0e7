"""The in-process serving fleet of the port (``paddle_tpu_torch.fleet.
FleetRouter``) on the CPU, and against ``paddle_tpu.fleet.FleetRouter``.

MNIST MLP replicas over one set of params (initialised in ``paddle_tpu``,
carried by ``params_from_jax``), exported at buckets [4, 8]:

- routing around a dead replica; the shared shed and deadline at the
  front door;
- the kill drill at saturation: no accepted request is dropped —
  never-dispatched ones reroute, dispatched ones raise ``ReplicaDied``
  once — and the flight recorder holds the kill;
- the rolling reload fanning out, its canary failure leaving the fleet
  untouched, a mid-rollout failure rolled back;
- a scripted kill drill and a scripted reload drill driven through both
  routers: the same outcomes, routing histories, health states,
  counters and ``fleet.*`` event shapes;
- the merged ``/metrics``: for one drill, the family names, each
  family's label keys and the deterministic counters equal the JAX
  router's;
- ``io.aot_compile_count`` flat under routed traffic;
- the batched GPT decoder (2 layers, d 32, vocab 97, params carried from
  ``paddle_tpu``) behind a router: every reply's ids equal the JAX
  ``decode_server``'s.

Replies are held to the JAX package's at rtol 1e-5 / atol 1e-6 (logits:
the same f32 products summed in another order), token ids exactly."""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

import jax

import paddle_tpu as jpt
from paddle_tpu import fleet as jfleet
from paddle_tpu import io as jio
from paddle_tpu import serving as jserving
from paddle_tpu import telemetry as jtel
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.testing import faults as jfaults

import paddle_tpu_torch as tpt
from paddle_tpu_torch import fleet as tfleet
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch import telemetry as ttel
from paddle_tpu_torch.fleet import BatchPolicy, FleetRouter, NoReplicaAvailable
from paddle_tpu_torch.framework import params_from_jax
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.serving import (CircuitOpen, PredictorServer, ReloadFailed,
                                      ReplicaDied, ServerOverloaded)
from paddle_tpu_torch.testing import faults

RTOL, ATOL = 1e-5, 1e-6
CPU = "cpu"


def _feed(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"image": rng.randn(n, 784).astype(np.float32),
            "label": rng.randint(0, 10, (n, 1)).astype(np.int64)}


def _single(feed, i):
    return {k: np.asarray(v)[i:i + 1] for k, v in feed.items()}


def _np(v):
    return v.numpy() if hasattr(v, "numpy") else np.asarray(v)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet")
    feed8 = _feed(8)
    params, _ = jpt.build(jmnist.mlp).init(jax.random.PRNGKey(0), **feed8)
    params = {k: np.asarray(v) for k, v in params.items()}
    out = {"feed8": feed8, "root": root}
    for name, scale in (("v1", 1.0), ("v2", 0.5), ("nan", np.nan)):
        p = {k: v * scale for k, v in params.items()}
        d = str(root / "port" / name)
        tio.save_inference_model(d, tpt.build(tmnist.mlp), params_from_jax(p, device=CPU),
                                 {}, feed8, batch_buckets=[4, 8])
        out[name] = d
        jd = str(root / "jax" / name)
        jio.save_inference_model(jd, jpt.build(jmnist.mlp), p, {}, feed8,
                                 batch_buckets=[4, 8])
        out["jax_" + name] = jd
    out["jax"] = out["jax_v1"]
    return out


@pytest.fixture(scope="module")
def pred(artifact):
    return tio.load_inference_model(artifact["v1"], device=CPU)


@pytest.fixture()
def fresh(tmp_path):
    saved = []
    for tel in (jtel, ttel):
        rec = tel.get_recorder()
        saved.append((tel, tel.set_journal(tel.RunJournal()), rec.root))
        rec.set_root(str(tmp_path / tel.__name__ / "flight"))
    try:
        yield ttel.get_journal()
    finally:
        for tel, journal, root in saved:
            tel.get_recorder().set_root(root)
            tel.set_journal(journal).close()


def test_fleet_exports_the_jax_names_and_the_autoscaler_is_deferred():
    for name in ("FleetRouter", "FleetPending", "NoReplicaAvailable", "RemoteReplica",
                 "RemotePending", "ReplicaProcess", "spawn_replica", "spawn_fleet",
                 "export_decoder", "decode_server", "BatchPolicy"):
        assert name in tfleet.__all__ and callable(getattr(tfleet, name)), name
    # the autoscaler was deferred until its collector was ported; it is
    # exported now under the JAX package's names
    for name in jfleet._AUTOSCALER_NAMES:
        assert name in tfleet.__all__ and callable(getattr(tfleet, name)), name


def test_spawn_refuses_to_fall_back_to_the_cpu(artifact):
    from paddle_tpu_torch.core.place import NoCudaDevice
    with pytest.raises(NoCudaDevice):
        FleetRouter.spawn(artifact["v1"], replicas=1)


def test_router_routes_around_dead_replica_and_health(pred):
    servers = {"r0": PredictorServer(pred, workers=1, queue_size=8),
               "r1": PredictorServer(pred.clone(), workers=1, queue_size=8)}
    router = FleetRouter(servers)
    try:
        feed8 = _feed(8)
        want = _np(pred.run(feed8)["logits"])
        assert router.health()["state"] == "ready"
        faults.kill_server(router.replica("r0"))
        h = router.health()
        assert h["state"] == "degraded" and h["ready"] and h["replicas_live"] == 1
        for _ in range(3):   # routing skips the dead replica
            np.testing.assert_array_equal(_np(router.run(feed8, timeout=60)["logits"]), want)
        assert router.report()["routed"]["r1"] >= 3
        with pytest.raises(ValueError, match="explicit server"):
            router.replace("r0")     # adopted fleet: no artifact on record
        router.replace("r0", PredictorServer(pred.clone(), workers=1, queue_size=8))
        assert router.health()["state"] == "ready"
    finally:
        router.close(drain=False, timeout=10)


def test_router_front_door_shed_overload_and_deadline(pred):
    release = threading.Event()
    hang = faults.hanging_predictor(pred, release, hang_calls=2)
    servers = [PredictorServer(hang, workers=1, queue_size=1, warmup=False,
                               watchdog_timeout=30.0),
               PredictorServer(hang.clone(), workers=1, queue_size=1, warmup=False,
                               watchdog_timeout=30.0)]
    router = FleetRouter(servers, default_deadline=30.0)
    try:
        feed8 = _feed(8)
        pends, shed_err = [], None
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and shed_err is None:
            try:
                pends.append(router.submit(feed8))   # wedges, then fills
            except ServerOverloaded as err:
                shed_err = err
        assert shed_err is not None, "the fleet never shed under saturation"
        assert shed_err.capacity == 2    # the front doors' capacities summed
        rep = router.report()
        assert rep["shed"] >= 1 and rep["submitted"] == len(pends)
        with pytest.raises(tserving.DeadlineExceeded, match="deadline exhausted"):
            router.submit(feed8, deadline=0.0)
        release.set()
        for p in pends:
            p.result(timeout=60)
    finally:
        release.set()
        router.close(drain=False, timeout=10)


def test_kill_drill_zero_dropped_at_saturation(artifact, fresh):
    """At ~3x saturation one replica is killed mid-load: no accepted
    request is dropped (no ServerClosed surfaces), never-dispatched ones
    reroute, dispatched ones raise ReplicaDied once; health degrades and
    recovers after ``replace``; the flight recorder holds the kill."""
    router = FleetRouter.spawn(artifact["v1"], replicas=3, device=CPU, workers=1,
                               queue_size=16, batch_policy=BatchPolicy(max_wait_ms=2.0))
    try:
        feed8 = artifact["feed8"]
        for _ in range(2):
            router.run(feed8, timeout=60)
        t0 = time.perf_counter()
        for _ in range(6):
            router.run(feed8, timeout=60)
        interval = (time.perf_counter() - t0) / 6 / 3.0 / 3
        pends, shed, states = [], 0, []
        for i in range(60):
            try:
                pends.append(router.submit(_single(feed8, i % 8)))
            except (ServerOverloaded, CircuitOpen, NoReplicaAvailable):
                shed += 1
            if i == 20:
                faults.kill_server(router.replica("r1"))
                states.append(router.health()["state"])
            time.sleep(interval)
        ok, died, dropped = 0, [], []
        for p in pends:
            try:
                p.result(timeout=60)
                ok += 1
            except ReplicaDied:
                died.append(p)
            except BaseException as e:
                dropped.append(e)
        assert not dropped, f"accepted requests dropped: {dropped[:3]}"
        assert ok + len(died) == len(pends) and states == ["degraded"]
        assert all("r1" not in p.tried[1:] for p in pends)
        router.replace("r1")
        assert router.health()["state"] == "ready"
        dumps = [d for d in ttel.get_recorder().dumps if d.endswith("replica_killed")]
        with open(os.path.join(dumps[-1], "flight.json")) as f:
            meta = json.load(f)
        assert meta["trigger"] == "replica_killed"
        if died:
            assert meta["span"] in {p.span for p in died}
        rep = router.report()
        assert rep["replicas_replaced"] == 1
        assert rep["rerouted"] == sum(len(p.tried) - 1 for p in pends)
        assert [e["kind"] for e in fresh.recent(kind="fleet.replace")] == ["fleet.replace"]
    finally:
        router.close(drain=False, timeout=10)


def test_rolling_reload_fans_out_with_zero_drops(artifact, pred):
    router = FleetRouter.spawn(artifact["v1"], replicas=2, device=CPU, workers=1,
                               queue_size=16, golden_feed=artifact["feed8"])
    errors, results = [], []
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            try:
                results.append(router.run(artifact["feed8"], timeout=60))
            except ServerOverloaded:
                pass
            except BaseException as e:
                errors.append(e)
                return

    t = threading.Thread(target=pump)
    t.start()
    try:
        time.sleep(0.05)
        assert router.reload(artifact["v2"]) == {"r0": 2, "r1": 2}
        assert router.dirname == artifact["v2"]
        stop.set()
        t.join(timeout=60)
        assert not errors and results
        assert router.report()["reloads"] == 1
        # a sibling's load off the request path is re-pinned fleet-wide
        for n in router.replica_names:
            assert router.replica(n).report()["compiles_since_warmup"] == 0
        want = _np(tio.load_inference_model(artifact["v2"], device=CPU)
                   .run(artifact["feed8"])["logits"])
        np.testing.assert_array_equal(_np(router.run(artifact["feed8"], timeout=60)["logits"]),
                                      want)
    finally:
        stop.set()
        t.join(timeout=10)
        router.close(drain=True, timeout=30)


def test_rolling_reload_failed_canary_leaves_the_fleet_untouched(artifact):
    router = FleetRouter.spawn(artifact["v1"], replicas=2, device=CPU, workers=1,
                               queue_size=16, golden_feed=artifact["feed8"])
    try:
        inflight = [router.submit(artifact["feed8"]) for _ in range(3)]
        with pytest.raises(ReloadFailed, match="non-finite"):
            router.reload(artifact["nan"])
        assert all(router.replica(n).generation == 1 for n in router.replica_names)
        assert router.dirname == artifact["v1"]
        for p in inflight:
            p.result(timeout=60)
        assert router.report()["reload_failures"] == 1
    finally:
        router.close(drain=True, timeout=30)


def test_rolling_reload_mid_rollout_failure_rolls_back(artifact, pred):
    """The canary passes, a later replica rejects: every replica already
    swapped goes back to the previous artifact."""
    golden_v1 = _np(pred.run(artifact["feed8"])["logits"])
    servers = {
        "r0": PredictorServer(pred.clone(), workers=1, queue_size=8,
                              golden_feed=artifact["feed8"]),
        "r1": PredictorServer(pred.clone(), workers=1, queue_size=8,
                              golden_feed=artifact["feed8"], canary_check=lambda out: False),
    }
    router = FleetRouter(servers, dirname=artifact["v1"], device=CPU)
    try:
        with pytest.raises(ReloadFailed, match="rolled back"):
            router.reload(artifact["v2"])
        assert router.replica("r0").generation == 3     # v2, then back to v1
        got = _np(router.replica("r0").run(artifact["feed8"], timeout=60)["logits"])
        assert got.tobytes() == golden_v1.tobytes()
        assert router.dirname == artifact["v1"]
        rep = router.report()
        assert rep["reload_rollbacks"] == 1 and rep["reload_failures"] == 1
    finally:
        router.close(drain=True, timeout=30)


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.005)


def _fleet_events(journal):
    """(kind, sorted keys) of the journal's ``fleet.*`` events."""
    return [(e["kind"], sorted(e)) for e in journal.recent() if e["kind"].startswith("fleet.")]


def _kill_drill(fleet_mod, serving_mod, faults_mod, journal, pred, feeds):
    """Adopted replicas "a" and "b" whose first dispatch each wedges:
    four requests leave one dispatched and one queued on each, "a" is
    killed, the wedge released, two more requests routed and "a"
    replaced. Returns the outcomes, routing histories, health states,
    counters and ``fleet.*`` event shapes, and the replies."""
    release = threading.Event()
    hang = faults_mod.hanging_predictor(pred, release, hang_calls=2)
    servers = {"a": serving_mod.PredictorServer(hang, workers=1, queue_size=8, warmup=False),
               "b": serving_mod.PredictorServer(hang.clone(), workers=1, queue_size=8,
                                                warmup=False)}
    router = fleet_mod.FleetRouter(servers)

    def load(key):
        return sum(srv.health()[key] for srv in servers.values())

    try:
        pends = []
        for i, f in enumerate(feeds[:4]):
            pends.append(router.submit(f))
            _wait(lambda: (load("workers_busy"), load("queue_depth"))
                  == (min(i + 1, 2), max(i - 1, 0)))
        states = [router.health()["state"]]
        servers["a"].kill(reason="drill")
        states.append(router.health()["state"])
        release.set()
        outcomes, outs = [], []
        for p in pends:
            try:
                outs.append(_np(p.result(timeout=60)["logits"]))
                outcomes.append(("ok", p.tried))
            except serving_mod.ReplicaDied:
                outcomes.append(("ReplicaDied", p.tried))
        for f in feeds[4:6]:
            p = router.submit(f)
            outs.append(_np(p.result(timeout=60)["logits"]))
            outcomes.append(("ok", p.tried))
        router.replace("a", serving_mod.PredictorServer(pred.clone(), workers=1, queue_size=8))
        states.append(router.health()["state"])
        rep = router.report()
        counters = {k: rep[k] for k in ("submitted", "rerouted", "shed", "replicas_replaced")}
        counters["routed"] = rep["routed"]
        return ({"outcomes": outcomes, "states": states, "counters": counters,
                 "events": _fleet_events(journal)}, outs)
    finally:
        release.set()
        router.close(drain=False, timeout=10)


def test_scripted_kill_drill_equals_jax_router(artifact, pred, fresh):
    feeds = [_feed(8, seed=10 + s) for s in range(6)]
    jpred = jio.load_inference_model(artifact["jax"])
    jgot, jouts = _kill_drill(jfleet, jserving, jfaults, jtel.get_journal(), jpred, feeds)
    tgot, touts = _kill_drill(tfleet, tserving, faults, fresh, pred, feeds)
    assert tgot == jgot
    assert [o for o, _ in tgot["outcomes"]].count("ReplicaDied") == 1
    assert tgot["counters"]["rerouted"] == 1
    assert tgot["states"] == ["ready", "degraded", "ready"]
    for a, b in zip(touts, jouts):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def _reload_drill(fleet_mod, serving_mod, io_mod, journal, dirs, feed8, **device):
    """A rolling reload to v2, a reload to the NaN artifact (its canary
    fails), then, with r1's canary_check refusing, a reload back to v1
    that r0 takes and the fleet rolls back. Returns the generations and
    error types after each step, the counters and ``fleet.*`` event
    shapes, and the final replies."""
    pred = io_mod.load_inference_model(dirs["v1"], **device)
    servers = {n: serving_mod.PredictorServer(pred.clone(), workers=1, queue_size=8,
                                              golden_feed=feed8)
               for n in ("r0", "r1")}
    router = fleet_mod.FleetRouter(servers, dirname=dirs["v1"], **device)

    def gens():
        return {n: router.replica(n).generation for n in router.replica_names}

    try:
        steps = [(router.reload(dirs["v2"]), gens())]
        for target in ("nan", "v1"):
            if target == "v1":
                servers["r1"].canary_check = lambda out: False
            with pytest.raises(serving_mod.ReloadFailed) as err:
                router.reload(dirs[target])
            steps.append((type(err.value).__name__, "rolled back" in str(err.value), gens()))
        rep = router.report()
        counters = {k: rep[k] for k in ("reloads", "reload_failures", "reload_rollbacks")}
        out = _np(router.run(feed8, timeout=60)["logits"])
        return ({"steps": steps, "counters": counters,
                 "dirname": os.path.basename(router.dirname),
                 "events": _fleet_events(journal)}, out)
    finally:
        router.close(drain=True, timeout=30)


def test_scripted_reload_drill_equals_jax_router(artifact, fresh):
    feed8 = artifact["feed8"]
    jdirs = {k: artifact["jax_" + k] for k in ("v1", "v2", "nan")}
    tdirs = {k: artifact[k] for k in ("v1", "v2", "nan")}
    jgot, jout = _reload_drill(jfleet, jserving, jio, jtel.get_journal(), jdirs, feed8)
    tgot, tout = _reload_drill(tfleet, tserving, tio, fresh, tdirs, feed8, device=CPU)
    assert tgot == jgot
    assert tgot["steps"][0][0] == {"r0": 2, "r1": 2}
    assert tgot["counters"] == {"reloads": 1, "reload_failures": 2, "reload_rollbacks": 1}
    np.testing.assert_allclose(tout, jout, rtol=RTOL, atol=ATOL)
    want = _np(tio.load_inference_model(artifact["v2"], device=CPU).run(feed8)["logits"])
    assert tout.tobytes() == want.tobytes()


def _drill(fleet_mod, serving_mod, pred, feeds):
    """Adopt two replicas as "a" and "b", route ``feeds``, kill "a",
    route them again: the merged families (name -> (type, sorted label
    keys of each sample, the fleet counters' values)) and the replies."""
    servers = {"a": serving_mod.PredictorServer(pred, workers=1, queue_size=8),
               "b": serving_mod.PredictorServer(pred.clone(), workers=1, queue_size=8)}
    router = fleet_mod.FleetRouter(servers)
    try:
        outs = [_np(router.run(f, timeout=60)["logits"]) for f in feeds]
        servers["a"].kill(reason="drill")
        outs += [_np(router.run(f, timeout=60)["logits"]) for f in feeds]
        for srv in servers.values():
            deadline = time.monotonic() + 10
            while srv.metrics.snapshot()["latency_ms"]["count"] < srv.metrics.completed \
                    and time.monotonic() < deadline:
                time.sleep(0.005)
        fams = router.metrics_families()
        assert (jtel if fleet_mod is jfleet else ttel).validate_families(fams) == []
        shape = {}
        for f in fams:
            keys = sorted({tuple(sorted(k for k in lab if k != "inst")) for lab, _ in f.samples})
            vals = (sorted((lab.get("replica"), lab.get("reason"), lab.get("outcome"), v)
                           for lab, v in f.samples)
                    if f.type == "counter" else None)
            shape[f.name] = (f.type, keys, vals)
        return shape, outs, router.health()
    finally:
        router.close(drain=False, timeout=10)


def test_merged_metrics_families_and_labels_equal_jax(artifact, pred, fresh):
    feeds = [_feed(8, seed=s) for s in range(3)]
    jpred = jio.load_inference_model(artifact["jax"])
    jshape, jouts, jh = _drill(jfleet, jserving, jpred, feeds)
    tshape, touts, th = _drill(tfleet, tserving, pred, feeds)
    assert sorted(tshape) == sorted(jshape)
    assert tshape == jshape
    for a, b in zip(touts, jouts):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert (th["state"], th["replicas_live"]) == (jh["state"], jh["replicas_live"])


def test_fleet_endpoint_serves_the_merged_export(pred):
    router = FleetRouter({"a": PredictorServer(pred, workers=1),
                          "b": PredictorServer(pred.clone(), workers=1)})
    try:
        for _ in range(3):
            router.run(_feed(8), timeout=60)
        ts = router.serve_metrics()
        text = urllib.request.urlopen(ts.url + "/metrics").read().decode()
        assert 'replica="a"' in text and 'replica="b"' in text
        assert "paddle_tpu_fleet_submitted_total" in text
        js = json.loads(urllib.request.urlopen(ts.url + "/metrics?format=json").read())
        assert "paddle_tpu_fleet_routed_total" in js
        health = json.loads(urllib.request.urlopen(ts.url + "/healthz").read())
        assert health["state"] == "ready" and health["replicas_ready"] == 2
    finally:
        router.close(drain=True, timeout=30)


def test_grow_retire_and_compile_count_flat_under_routed_traffic(artifact):
    router = FleetRouter.spawn(artifact["v1"], replicas=2, device=CPU, workers=1)
    try:
        pinned = tio.aot_compile_count()
        for n in (1, 3, 4, 5, 8):
            router.run(_feed(n, seed=n), timeout=60)
        assert tio.aot_compile_count() == pinned
        name = router.grow()
        assert name == "r2" and len(router.replica_names) == 3
        # the newcomer's load moved the process-wide count; siblings re-pinned
        assert tio.aot_compile_count() == pinned + 2
        for _ in range(6):
            router.run(_feed(4), timeout=60)
        for n in router.replica_names:
            assert router.replica(n).report()["compiles_since_warmup"] == 0
        router.retire("r0")
        assert router.replica_names == ["r1", "r2"]
        rep = router.report()
        assert (rep["replicas_grown"], rep["replicas_retired"]) == (1, 1)
    finally:
        router.close(drain=True, timeout=30)


def test_batched_decoder_behind_router_equals_jax_decode_server(tmp_path):
    from paddle_tpu.fleet import decode as jdecode
    from paddle_tpu.models import gpt as jgpt
    from paddle_tpu_torch.fleet import decode as tdecode
    from paddle_tpu_torch.models import gpt as tgpt

    small = dict(vocab_size=97, max_len=32, d_model=32, d_inner=64, num_heads=4,
                 num_layers=2, use_flash=True)
    rng = np.random.RandomState(0)
    prompts = rng.randint(3, 97, (4, 8)).astype(np.int32)
    prog = jpt.build(jgpt.make_generator(jgpt.base_config(**small), max_new_tokens=6))
    params, _ = prog.init(jax.random.PRNGKey(0), prompts)
    params = {k: np.asarray(v) + 0.3 * rng.randn(*v.shape).astype(np.float32)
              for k, v in params.items()}
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jdecode.export_decoder(jd, jgpt.base_config(**small), 6, prompts, params=params,
                           batch_buckets=[1, 4])
    tdecode.export_decoder(td, tgpt.base_config(**small), 6, prompts,
                           params=tgpt.params_from_jax(params, device=CPU),
                           batch_buckets=[1, 4], device=CPU)
    jsrv = jdecode.decode_server(jd, max_wait_ms=200.0, workers=1)
    try:
        jp = [jsrv.submit({"prompt_ids": prompts[i:i + 1]}) for i in range(4)]
        want = [np.asarray(p.result(timeout=120)["ids"]) for p in jp]
    finally:
        jsrv.close(drain=True, timeout=60)
    router = FleetRouter({"r0": tdecode.decode_server(td, max_wait_ms=200.0, device=CPU),
                          "r1": tdecode.decode_server(td, max_wait_ms=200.0, device=CPU)},
                         dirname=td, device=CPU)
    try:
        pends = [router.submit({"prompt_ids": prompts[i:i + 1]}) for i in range(4)]
        got = [_np(p.result(timeout=120)["ids"]) for p in pends]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert sum(router.report()["routed"].values()) == 4
    finally:
        router.close(drain=True, timeout=60)
