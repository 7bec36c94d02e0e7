"""The serving runtime's recovery paths in the port against the JAX
package: the circuit breaker, the dispatch watchdog, ``kill`` and hot
reload, on MNIST MLP servers of both packages over one set of params
(initialised in ``paddle_tpu``, carried by ``params_from_jax``), exported
at buckets [1, 4, 8].

- Each package's ``CircuitBreaker`` is driven by the same acquire/
  record/trip script under one patched ``time.monotonic``: the same
  states, tokens, trips, ``retry_after`` and trip reasons.
- kill, a hang caught by the watchdog, a breaker trip and reloads (good,
  a failed canary, a corrupt artifact, a drifted signature) give the
  same typed errors, ``health()`` states and generations, and the same
  journal event names and fields (span ids aside); the flight dumps of
  both packages validate and load through the port's recorder layout.
- Served outputs: the port's server against the JAX server's at rtol
  1e-5 / atol 1e-6 (the same f32 products summed in another order).

Each test takes a fresh journal in both packages and roots both flight
recorders under its temporary directory."""

import json
import os
import shutil
import threading
import time

import numpy as np
import pytest

import jax

import paddle_tpu as jpt
from paddle_tpu import io as jio
from paddle_tpu import serving as jserving
from paddle_tpu import telemetry as jtel
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.testing import faults as jfaults

import paddle_tpu_torch as tpt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch import telemetry as ttel
from paddle_tpu_torch.framework import params_from_jax
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.testing import faults as tfaults

RTOL, ATOL = 1e-5, 1e-6
BUCKETS = [1, 4, 8]
PKGS = {"jax": (jio, jserving, jtel, jfaults), "port": (tio, tserving, ttel, tfaults)}


def _feed(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"image": rng.randn(n, 784).astype(np.float32),
            "label": rng.randint(0, 10, (n, 1)).astype(np.int64)}


def _np(v):
    return v.numpy() if hasattr(v, "numpy") else np.asarray(v)


def _export(pkg, d, params, buckets=BUCKETS, n=1):
    if pkg == "jax":
        jio.save_inference_model(d, jpt.build(jmnist.mlp), params, {}, _feed(n),
                                 batch_buckets=buckets)
    else:
        tio.save_inference_model(d, tpt.build(tmnist.mlp),
                                 params_from_jax(params, device="cpu"), {}, _feed(n),
                                 batch_buckets=buckets)
    return d


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """For each package: the served artifact, a second one (params x 0.5),
    one whose params are NaN, one with a byte flipped and one that lost
    bucket 8."""
    root = tmp_path_factory.mktemp("resilience")
    params, _ = jpt.build(jmnist.mlp).init(jax.random.PRNGKey(0), **_feed(1))
    params = {k: np.asarray(v) for k, v in params.items()}
    out = {}
    for pkg in PKGS:
        d = {"v1": _export(pkg, str(root / pkg / "v1"), params),
             "v2": _export(pkg, str(root / pkg / "v2"), {k: v * 0.5 for k, v in params.items()}),
             "nan": _export(pkg, str(root / pkg / "nan"),
                            {k: np.full_like(v, np.nan) for k, v in params.items()}),
             "shrunk": _export(pkg, str(root / pkg / "shrunk"), params, buckets=[1, 4])}
        d["corrupt"] = str(root / pkg / "corrupt")
        shutil.copytree(d["v2"], d["corrupt"])
        jfaults.flip_byte(d["corrupt"], "params.npz")
        out[pkg] = d
    return out


def _pred(pkg, d):
    if pkg == "jax":
        return jio.load_inference_model(d)
    return tio.load_inference_model(d, device="cpu")


@pytest.fixture()
def fresh(tmp_path):
    saved = []
    for name, (_, _, tel, _) in PKGS.items():
        rec = tel.get_recorder()
        saved.append((tel, tel.set_journal(tel.RunJournal()), rec.root))
        rec.set_root(str(tmp_path / name / "flight"))
    try:
        yield {"jax": jtel.get_journal(), "port": ttel.get_journal()}
    finally:
        for tel, journal, root in saved:
            tel.get_recorder().set_root(root)
            tel.set_journal(journal).close()


def _shape(events, kinds=None):
    """(kind, sorted keys) of events, optionally only of ``kinds``."""
    return [(e["kind"], sorted(e)) for e in events if kinds is None or e["kind"] in kinds]


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.005)


def _dump(tel, trigger):
    """The newest flight dump of ``trigger``, validated against its
    manifest by the port, as (meta, event kinds)."""
    dumps = [d for d in tel.get_recorder().dumps if d.endswith(trigger)]
    assert dumps, trigger
    assert tres.validate_checkpoint(dumps[-1])
    with open(os.path.join(dumps[-1], "flight.json")) as f:
        meta = json.load(f)
    with open(os.path.join(dumps[-1], "events.jsonl")) as f:
        kinds = [json.loads(ln)["kind"] for ln in f if ln.strip()]
    return meta, kinds


# -- the breaker, state machine alone -------------------------------------------

BREAKER_SCRIPTS = {
    "failures_then_probe_closes": (
        (3, 1.0), ["a", "f", "a", "f", "a", "f", "a", "+0.5", "a", "+0.6", "a", "a",
                   "s", "a"]),
    "probe_failure_reopens": (
        (2, 0.5), ["a", "f", "a", "f", "a", "+0.6", "a", "f", "a", "+0.6", "a", "s", "a"]),
    "hang_trip_and_cancelled_probe": (
        (5, 2.0), ["a", "s", "t", "a", "+2.5", "a", "c", "a", "s", "a"]),
    "success_resets_the_count": (
        (2, 1.0), ["a", "f", "a", "s", "a", "f", "a", "a", "f", "a"]),
}


def _drive_breaker(serving, policy, script, clock):
    trips = []
    br = serving.CircuitBreaker(serving.BreakerPolicy(*policy), on_trip=trips.append)
    token, seen = None, []
    for op in script:
        if op == "a":
            token = br.acquire()
            seen.append(("acquire", token))
        elif op == "f":
            br.record(token, success=False)
        elif op == "s":
            br.record(token, success=True)
        elif op == "t":
            br.trip()
        elif op == "c":
            br.cancel(token)
        else:
            clock[0] += float(op)
        seen.append((op, br.state, br.trips, round(br.retry_after(), 6)))
    return seen, trips


@pytest.mark.parametrize("name", sorted(BREAKER_SCRIPTS))
def test_circuit_breaker_sequences_equal_jax(name, monkeypatch):
    policy, script = BREAKER_SCRIPTS[name]
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    runs = {}
    for pkg, (_, serving, _, _) in PKGS.items():
        clock[0] = 1000.0
        runs[pkg] = _drive_breaker(serving, policy, script, clock)
    assert runs["port"] == runs["jax"]
    assert runs["port"][1], "the script never tripped the breaker"


# -- kill ------------------------------------------------------------------------


def test_kill_fails_dispatched_once_and_queued_retryable_as_jax(artifacts, fresh):
    got = {}
    for pkg, (_, serving, tel, faults) in PKGS.items():
        release = threading.Event()
        pred = faults.hanging_predictor(_pred(pkg, artifacts[pkg]["v1"]), release)
        srv = serving.PredictorServer(pred, workers=1, queue_size=8, warmup=False,
                                      watchdog_timeout=None)
        try:
            dispatched = srv.submit(_feed(1))
            _wait(lambda: srv.health()["workers_busy"] == 1)
            queued = [srv.submit(_feed(2, seed=i)) for i in range(2)]
            before = srv.health()
            faults.kill_server(srv, reason="drill")
            errs = []
            for p in [dispatched] + queued:
                with pytest.raises(serving.ServingError) as ei:
                    p.result(timeout=10)
                errs.append(type(ei.value).__name__)
            h = srv.health()
            with pytest.raises(serving.ServerClosed):
                srv.submit(_feed(1))
            meta, kinds = _dump(tel, "replica_killed")
            killed = fresh[pkg].recent(kind="serving.killed")
            got[pkg] = {"errs": errs, "before": before["state"],
                        "after": (h["state"], h["live"], h["ready"], h["generation"]),
                        "killed": [{k: v for k, v in e.items()
                                    if k in ("reason", "inflight", "queued")} for e in killed],
                        "span_is_dispatched": killed[0]["span"] == dispatched.span,
                        "events": _shape(fresh[pkg].recent(), {"serving.killed"}),
                        "dump": (meta["trigger"], meta["span"] == dispatched.span,
                                 sorted(meta["detail"]), kinds[-1])}
        finally:
            release.set()
    assert got["port"] == got["jax"]
    assert got["port"]["errs"] == ["ReplicaDied", "ServerClosed", "ServerClosed"]
    assert got["port"]["after"] == ("stopped", False, False, 1)
    assert got["port"]["killed"] == [{"reason": "drill", "inflight": 1, "queued": 2}]


# -- the watchdog ----------------------------------------------------------------


def test_watchdog_abandons_a_hung_worker_and_replaces_it_as_jax(artifacts, fresh):
    got = {}
    for pkg, (_, serving, tel, faults) in PKGS.items():
        release = threading.Event()
        pred = faults.hanging_predictor(_pred(pkg, artifacts[pkg]["v1"]), release)
        srv = serving.PredictorServer(pred, workers=1, queue_size=8, warmup=False,
                                      watchdog_timeout=0.2,
                                      breaker=serving.BreakerPolicy(cooldown=0.3))
        try:
            hung = srv.submit(_feed(1))
            with pytest.raises(serving.WorkerHung):
                hung.result(timeout=10)
            _wait(lambda: srv.report()["workers_replaced"] == 1
                  and srv.health()["workers"] == 1)
            srv.watchdog_timeout = 60.0   # the probe below must not read as a hang
            h_open = srv.health()
            with pytest.raises(serving.CircuitOpen):
                srv.submit(_feed(1))
            time.sleep(0.35)
            h_half = srv.health()
            out = srv.run(_feed(4, seed=3), timeout=30)   # the half-open probe
            h_closed = srv.health()
            rep = srv.report()
            meta, kinds = _dump(tel, "worker_hung")
            got[pkg] = {
                "states": [(h["state"], h["live"], h["ready"], h["workers"], h["breaker"])
                           for h in (h_open, h_half, h_closed)],
                "counts": {k: rep[k] for k in ("hangs", "workers_replaced", "errors",
                                               "rejected_breaker", "completed")},
                "trips": rep["breaker"],
                "events": _shape(fresh[pkg].recent(span=hung.span)),
                "breaker_events": [(e["reason"], e["trips"])
                                   for e in fresh[pkg].recent(kind="serving.breaker_open")],
                "dump": (meta["trigger"], meta["span"] == hung.span, sorted(meta["detail"]),
                         "serving.hang" in kinds),
                "logits": _np(out["logits"])}
        finally:
            release.set()
            srv.close(drain=True, timeout=10)
    np.testing.assert_allclose(got["port"].pop("logits"), got["jax"].pop("logits"),
                               rtol=RTOL, atol=ATOL)
    assert got["port"] == got["jax"]
    # the breaker turns half-open at the first admission after its cooldown
    assert [s[0] for s in got["port"]["states"]] == ["breaker_open", "breaker_open", "ready"]
    assert got["port"]["counts"]["hangs"] == 1


# -- the breaker in a server -----------------------------------------------------


def test_failing_predictor_trips_probes_and_closes_as_jax(artifacts, fresh):
    got = {}
    for pkg, (_, serving, tel, faults) in PKGS.items():
        pred = faults.failing_predictor(_pred(pkg, artifacts[pkg]["v1"]), fail_calls=3)
        srv = serving.PredictorServer(pred, workers=1, warmup=False,
                                      breaker=serving.BreakerPolicy(failure_threshold=3,
                                                                    cooldown=0.3))
        try:
            outcomes = []
            for i in range(4):
                try:
                    srv.run(_feed(1, seed=i), timeout=30)
                    outcomes.append("ok")
                except Exception as e:
                    outcomes.append(type(e).__name__)
            states = [srv.health()["state"]]
            time.sleep(0.35)
            probe = srv.submit(_feed(1))      # the admission after the cooldown
            states.append(srv.health()["state"])
            probe.result(timeout=30)
            states.append(srv.health()["state"])
            meta, kinds = _dump(tel, "breaker_trip")
            fams = {f.name: f for f in tel.get_registry().collect()}
            gauges = {n: [v for lab, v in fams[n].samples if lab.get("inst") ==
                          srv.telemetry_inst]
                      for n in ("paddle_tpu_serving_breaker_trips_total",
                                "paddle_tpu_serving_breaker_open",
                                "paddle_tpu_serving_generation")}
            got[pkg] = {"outcomes": outcomes, "states": states, "gauges": gauges,
                        "dump": (meta["trigger"], sorted(meta["detail"]),
                                 meta["detail"]["reason"], "serving.breaker_open" in kinds),
                        "events": _shape(fresh[pkg].recent(),
                                         {"serving.breaker_open", "serving.error",
                                          "serving.reject"})}
        finally:
            srv.close(drain=True, timeout=10)
    assert got["port"] == got["jax"]
    assert got["port"]["outcomes"] == ["RuntimeError"] * 3 + ["CircuitOpen"]
    assert got["port"]["states"] == ["breaker_open", "half_open", "ready"]


def test_a_base_exception_fails_the_call_and_the_worker_serves_on_as_jax(artifacts, fresh):
    """F9: a dispatch that raises a BaseException (the harness's
    InjectedCrash) completes its request with that error; the worker
    lives on and serves the next request, in both packages."""
    from paddle_tpu import resilience as jres

    crash = {"jax": jres.InjectedCrash, "port": tres.InjectedCrash}
    got = {}
    for pkg, (_, serving, _, faults) in PKGS.items():
        exc = crash[pkg]
        pred = faults.failing_predictor(_pred(pkg, artifacts[pkg]["v1"]), fail_calls=1,
                                        exc=lambda exc=exc: exc("boom"))
        srv = serving.PredictorServer(pred, workers=1, warmup=False)
        try:
            try:
                srv.run(_feed(1), timeout=10)
                first = "ok"
            except BaseException as e:  # noqa: B902 - the injected crash is one
                first = (type(e).__name__, str(e))
            health = srv.health()
            nxt = srv.run(_feed(1, seed=5), timeout=10)
            got[pkg] = {"first": first, "workers": health["workers"],
                        "state": health["state"], "live": health["live"],
                        "next": sorted(nxt), "logits": _np(nxt["logits"])}
        finally:
            srv.close(drain=True, timeout=10)
    assert got["port"]["first"] == got["jax"]["first"] == ("InjectedCrash", "boom")
    for key in ("workers", "state", "live", "next"):
        assert got["port"][key] == got["jax"][key], key
    assert got["port"]["workers"] == 1 and got["port"]["state"] == "ready"
    np.testing.assert_allclose(got["port"]["logits"], got["jax"]["logits"], rtol=RTOL,
                               atol=ATOL)


# -- hot reload -------------------------------------------------------------------

RELOADS = {
    # candidate, how the server vets it, expected error (None: swapped)
    "good": ("v2", {}, None),
    "failed_canary": ("v2", {"canary_check": lambda out: False}, "ReloadFailed"),
    "nan_canary": ("nan", {}, "ReloadFailed"),
    "corrupt": ("corrupt", {}, "CheckpointCorrupt"),
    "bucket_shrank": ("shrunk", {}, "ReloadFailed"),
}


@pytest.mark.parametrize("case", sorted(RELOADS))
def test_reload_outcomes_equal_jax(artifacts, fresh, case):
    cand, kw, want_err = RELOADS[case]
    golden = _feed(8, seed=5)
    got = {}
    for pkg, (_, serving, _, _) in PKGS.items():
        srv = serving.PredictorServer(_pred(pkg, artifacts[pkg]["v1"]), workers=2,
                                      golden_feed=golden, **kw)
        try:
            inflight = [srv.submit(_feed(4, seed=i)) for i in range(4)]
            err = None
            try:
                srv.reload(artifacts[pkg][cand])
            except Exception as e:
                err = e
            for p in inflight:        # nothing in flight is dropped
                p.result(timeout=30)
            after = srv.run(golden, timeout=30)
            rep = srv.report()
            events = fresh[pkg].recent(kind="serving.reload")
            got[pkg] = {
                "err": type(err).__name__ if err else None,
                "last_error": type(srv.last_reload_error).__name__
                if srv.last_reload_error else None,
                "generation": srv.generation, "health": srv.health()["state"],
                "counts": (rep["reloads"], rep["reload_failures"],
                           rep["compiles_since_warmup"]),
                "events": [(e["kind"], sorted(e), e["ok"]) for e in events],
                "logits": _np(after["logits"]),
                "preflight": sorted(f.code for f in
                                    srv.reload_preflight(artifacts[pkg][cand]).findings)}
        finally:
            srv.close(drain=True, timeout=10)
    np.testing.assert_allclose(got["port"].pop("logits"), got["jax"].pop("logits"),
                               rtol=RTOL, atol=ATOL)
    assert got["port"] == got["jax"]
    assert got["port"]["err"] == want_err
    assert got["port"]["generation"] == (2 if want_err is None else 1)
    if case == "bucket_shrank":
        assert got["port"]["preflight"] == ["artifact:bucket-shrank"]


def test_async_reload_reports_through_last_reload_error(artifacts, fresh):
    srv = tserving.PredictorServer(_pred("port", artifacts["port"]["v1"]), workers=1)
    try:
        t = srv.reload(artifacts["port"]["corrupt"], block=False)
        t.join(timeout=30)
        assert isinstance(srv.last_reload_error, tres.CheckpointCorrupt)
        srv.reload(artifacts["port"]["v2"], block=False).join(timeout=30)
        assert srv.last_reload_error is None and srv.generation == 2
    finally:
        srv.close()


# -- outputs, report and families -------------------------------------------------


def test_served_outputs_report_and_families_equal_jax(artifacts, fresh):
    feeds = [_feed(n, seed=10 + n) for n in (1, 3, 5, 8)]
    got = {}
    for pkg, (io, serving, tel, _) in PKGS.items():
        srv = serving.PredictorServer(_pred(pkg, artifacts[pkg]["v1"]), workers=2,
                                      default_deadline=30.0)
        try:
            outs = [_np(srv.run(f, timeout=30)["logits"]) for f in feeds]
            _wait(lambda: srv.metrics.snapshot()["latency_ms"]["count"] == len(feeds))
            rep = srv.report()
            fams = sorted(f.name for f in srv.telemetry_families())
            got[pkg] = {"outs": outs, "keys": sorted(rep), "health": sorted(rep["health"]),
                        "breaker": rep["breaker"], "fams": fams,
                        "compiles": rep["compiles_since_warmup"],
                        "completed": rep["completed"]}
        finally:
            srv.close()
    for a, b in zip(got["port"].pop("outs"), got["jax"].pop("outs")):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert got["port"] == got["jax"]
    assert got["port"]["compiles"] == 0


def test_aot_compile_count_moves_at_load_and_stays_flat_under_requests(artifacts):
    before = tio.aot_compile_count()
    pred = _pred("port", artifacts["port"]["v1"])
    assert tio.aot_compile_count() == before + len(BUCKETS)
    srv = tserving.PredictorServer(pred, workers=2)
    try:
        pinned = tio.aot_compile_count()
        for n in (1, 2, 3, 4, 5, 7, 8):
            srv.run(_feed(n, seed=n), timeout=30)
        assert tio.aot_compile_count() == pinned
        assert srv.report()["compiles_since_warmup"] == 0
        srv.reload(artifacts["port"]["v2"])    # the load prepares off the request path
        assert srv.report()["compiles_since_warmup"] == 0
    finally:
        srv.close()


def test_server_takes_every_constructor_option_of_jax():
    import inspect
    want = inspect.signature(jserving.PredictorServer.__init__).parameters
    have = inspect.signature(tserving.PredictorServer.__init__).parameters
    assert list(have) == list(want)
    assert {k: v.default for k, v in have.items()} == {k: v.default for k, v in want.items()}


def test_start_false_defers_readiness(artifacts):
    srv = tserving.PredictorServer(_pred("port", artifacts["port"]["v1"]), start=False)
    try:
        assert srv.health()["state"] == "starting"
        with pytest.raises(tserving.ServerClosed, match="not started"):
            srv.submit(_feed(1))
        srv.start()
        assert srv.health()["state"] == "ready"
        assert srv.run(_feed(2), timeout=30)["logits"].shape == (2, 10)
    finally:
        srv.close()
