"""The port's closed-loop autoscaler (``paddle_tpu_torch.fleet.autoscaler``)
against ``paddle_tpu.fleet.autoscaler`` on the CPU:

- ``AutoscalePolicy.decide`` gives the JAX package's decisions on scripted
  ``ScaleSignals`` sequences that cross every branch (hot, cold, both
  cooldowns, the flap guard, the quorum floor, the band edges and
  fail-static), with an explicit clock and no sleep;
- ``complete_buckets`` equal;
- ``Autoscaler.tick`` over a ``LocalCollectorReader`` of a collector fed
  scripted series, each package over its own collector: the same
  decisions, grows and retires;
- ``HttpCollectorReader`` against a port collector's ``/query`` and
  ``/alerts``;
- the registry families and journal events it publishes, named as JAX's;
- one closed loop: a port ``FleetRouter`` of the MNIST MLP on the CPU
  grown under a burst and retired after it, every accepted request
  answered."""

import threading
import time

import numpy as np
import pytest

import jax

import paddle_tpu as jpt
from paddle_tpu import telemetry as jtel
from paddle_tpu.fleet import autoscaler as jas
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.telemetry import collector as jcollector

import paddle_tpu_torch as tpt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch import telemetry as ttel
from paddle_tpu_torch.fleet import BatchPolicy, FleetRouter
from paddle_tpu_torch.fleet import autoscaler as tas
from paddle_tpu_torch.framework import params_from_jax
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.telemetry import collector as tcollector

AS = {"jax": jas, "port": tas}
COL = {"jax": jcollector, "port": tcollector}


@pytest.fixture()
def fresh():
    saved = [(tel, tel.set_journal(tel.RunJournal())) for tel in (jtel, ttel)]
    try:
        yield
    finally:
        for tel, old in saved:
            j = tel.set_journal(old)
            if j is not None:
                j.close()


# -- the pure policy: scripted sequences, both packages ------------------------

BASE = dict(min_replicas=1, max_replicas=4, up_window_s=2.0, down_window_s=5.0,
            up_cooldown_s=5.0, down_cooldown_s=10.0, flap_guard_s=10.0)

# (policy overrides, steps): a step is (now, replicas, signal overrides) or
# ("retired", t) for note_retired
SCRIPTS = {
    "band": (dict(min_replicas=2, up_cooldown_s=100.0), [
        (0.0, 2, dict(queue_per_replica=0.0, alert_firing=True, alert_transition=True)),
        (1.0, 1, dict(queue_per_replica=0.0)),           # below band: repair in cooldown
        (2.0, 1, dict(data_ok=False)),                   # below band but fail-static
        (3.0, 4, dict(alert_firing=True, alert_transition=True)),   # at max
    ]),
    "hot": (dict(up_queue_per_replica=2.0, up_shed_rate=1.0), [
        (0.0, 2, dict(queue_per_replica=5.0)),
        (1.0, 2, dict(queue_per_replica=5.0)),
        (2.0, 2, dict(queue_per_replica=5.0)),           # sustained: up
        (3.0, 3, dict(queue_per_replica=5.0)),           # hot window reset by the up
        (4.0, 3, dict(queue_per_replica=0.0)),           # a cold tick erases the sustain
        (5.0, 3, dict(queue_per_replica=5.0)),
        (7.0, 3, dict(queue_per_replica=5.0)),           # in the up cooldown
        (8.0, 3, dict(shed_rate=3.0)),                   # shed as the signal
        (10.0, 3, dict(shed_rate=3.0)),
        (11.0, 4, dict(queue_per_replica=9.0)),          # at max
    ]),
    "alert": (dict(up_window_s=60.0, max_replicas=3), [
        (0.0, 2, dict(queue_per_replica=0.0, alert_firing=True, alert_transition=True)),
        (1.0, 3, dict(queue_per_replica=0.0, alert_firing=True)),
        (2.0, 2, dict(alert_firing=True, alert_transition=True)),   # in the up cooldown
    ]),
    "cold": (dict(down_window_s=5.0, down_cooldown_s=10.0, flap_guard_s=0.0,
                  up_queue_per_replica=2.0, down_queue_per_replica=0.5), [
        (0.0, 3, dict(queue_per_replica=0.0)),
        (4.9, 3, dict(queue_per_replica=0.0)),
        (5.0, 3, dict(queue_per_replica=0.0)),           # sustained cold: down
        (6.0, 2, dict(queue_per_replica=1.0)),           # the hysteresis gap
        (7.0, 2, {}),                                    # silence is not coldness
        (8.0, 2, dict(queue_per_replica=0.0)),
        (13.0, 2, dict(queue_per_replica=0.0)),          # cold again, in the cooldown
        (15.0, 2, dict(queue_per_replica=0.0)),
        (21.0, 1, dict(queue_per_replica=0.0)),
        (27.0, 1, dict(queue_per_replica=0.0)),          # at min
    ]),
    "flap": (dict(down_window_s=0.0, down_cooldown_s=0.0, flap_guard_s=10.0), [
        (0.0, 3, dict(queue_per_replica=0.0)),
        ("retired", 4.0),
        (12.0, 2, dict(queue_per_replica=0.0)),          # guard runs from the completion
        (14.0, 2, dict(queue_per_replica=0.0)),
    ]),
    "quorum": (dict(quorum=2, down_window_s=0.0, down_cooldown_s=0.0, flap_guard_s=0.0), [
        (0.0, 2, dict(queue_per_replica=0.0, alert_firing=True)),
        (1.0, 2, dict(queue_per_replica=0.0)),
        (2.0, 4, dict(queue_per_replica=0.0, alert_firing=True)),   # above the floor
    ]),
    "fail_static": (dict(down_window_s=5.0), [
        (0.0, 2, dict(queue_per_replica=9.0)),
        (1.0, 2, dict(data_ok=False)),
        (2.0, 2, dict(queue_per_replica=9.0)),
        (4.0, 2, dict(queue_per_replica=9.0)),
        (5.0, 3, dict(queue_per_replica=0.0)),
        (6.0, 3, dict(data_ok=False)),
        (10.0, 3, dict(queue_per_replica=0.0)),
        (15.0, 3, dict(queue_per_replica=0.0)),
    ]),
}


def _run_script(mod, name):
    over, steps = SCRIPTS[name]
    p = mod.AutoscalePolicy(**{**BASE, **over})
    out = []
    for st in steps:
        if st[0] == "retired":
            p.note_retired(st[1])
            continue
        now, replicas, kw = st
        d = p.decide(mod.ScaleSignals(now=now, replicas=replicas, **kw))
        out.append((d.action, d.target, d.reason, d.detail))
    return out


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_policy_decisions_equal(name):
    got, want = _run_script(tas, name), _run_script(jas, name)
    assert got == want
    # every script scales at least once
    assert any(a != "hold" for a, *_ in got)


def test_the_scripts_cross_every_branch():
    reasons = {r for name in SCRIPTS for _, _, r, _ in _run_script(tas, name)}
    assert reasons == {"below-band", "fail-static", "at-max", "trend-sustained", "steady",
                       "up-cooldown", "alert-transition", "trend-cold", "down-cooldown",
                       "at-min", "anti-flap", "quorum-floor"}
    with pytest.raises(ValueError):
        tas.AutoscalePolicy(min_replicas=0, max_replicas=2)
    with pytest.raises(ValueError):
        tas.AutoscalePolicy(min_replicas=3, max_replicas=2)


def test_complete_buckets_equal():
    cases = [([(0.0, 1.0), (0.5, 2.0), (1.0, 3.0)], 0.5, 1.2),
             ([(0.0, 1.0), (0.5, 2.0), (1.0, 3.0)], 0.5, 1.5),
             ([(0.0, 1.0), (1.1, 2.0), (2.0, 3.0)], 0.0, 1.5),
             ([], 0.5, 1.0)]
    for pts, step, to in cases:
        assert tas.complete_buckets(pts, step, to) == jas.complete_buckets(pts, step, to)


# -- the control loop over a collector of each package -------------------------


class _Router:
    """The two primitives the loop calls, recorded."""

    def __init__(self, names):
        self.names, self.actions = list(names), []

    @property
    def replica_names(self):
        return list(self.names)

    def grow(self, name=None):
        name = name or f"r{len(self.names)}"
        self.names.append(name)
        self.actions.append(("grow", name))
        return name

    def retire(self, name, drain=True, timeout=None):
        self.names.remove(name)
        self.actions.append(("retire", name, drain))


def _snap(depth, shed):
    return {"paddle_tpu_serving_queue_depth": {
                "type": "gauge", "help": "h",
                "samples": [{"labels": {}, "value": float(depth)}]},
            "paddle_tpu_fleet_shed_total": {
                "type": "counter", "help": "h",
                "samples": [{"labels": {}, "value": float(shed)}]}}


def _loop_run(pkg, reader_of=None):
    """A burst, then quiet, fed as the fleet's series into a collector of
    ``pkg``; one tick every 0.5 s of the script's clock."""
    col = COL[pkg].TelemetryCollector(eval_interval=3600, rules=[])
    try:
        router = _Router(["r0"])
        policy = AS[pkg].AutoscalePolicy(min_replicas=1, max_replicas=3, up_window_s=1.0,
                                         down_window_s=2.0, up_cooldown_s=1.0,
                                         down_cooldown_s=1.0, flap_guard_s=0.5)
        reader = (reader_of or AS[pkg].LocalCollectorReader)(col)
        sc = AS[pkg].Autoscaler(router, reader, policy, trend_window_s=2.0,
                                trend_step_s=0.5, stale_after_s=1.0)
        out, t0, shed = [], 5000.0, 0
        depth = [0] * 4 + [12] * 12 + [0] * 16
        try:
            for i, d in enumerate(depth):
                now = t0 + 0.5 * i
                shed += 2 if d else 0
                for r in router.names:
                    col.store.ingest(r, _snap(d / len(router.names), shed), t=now - 0.01)
                dec = sc.tick(now=now)
                out.append((dec.action, dec.target, dec.reason, len(router.names)))
            out.append(("counters", sc.counters()))
            fams = {f.name: f.type for f in sc._families()}
        finally:
            sc.close()
        return out, router.actions, fams
    finally:
        col.close()


def test_tick_over_a_collector_gives_the_jax_decisions(fresh):
    got, got_actions, got_fams = _loop_run("port")
    want, want_actions, want_fams = _loop_run("jax")
    assert got == want and got_actions == want_actions and got_fams == want_fams
    assert ("grow", "r1") in got_actions and ("grow", "r2") in got_actions
    assert ("retire", "r2", True) in got_actions and ("retire", "r1", True) in got_actions
    assert got[-1][1]["scale_ups"] == 2 and got[-1][1]["scale_downs"] == 2
    events = [e["kind"] for e in ttel.get_journal().recent(kind="autoscale.")]
    assert events == [e["kind"] for e in jtel.get_journal().recent(kind="autoscale.")]
    assert {"autoscale.up", "autoscale.down", "autoscale.hold"} <= set(events)


def test_published_families_are_jax_names(fresh):
    got, _, fams = _loop_run("port")
    assert fams == {"paddle_tpu_autoscaler_ticks_total": "counter",
                    "paddle_tpu_autoscaler_scale_ups_total": "counter",
                    "paddle_tpu_autoscaler_scale_downs_total": "counter",
                    "paddle_tpu_autoscaler_holds_total": "counter",
                    "paddle_tpu_autoscaler_replicas": "gauge"}
    from paddle_tpu.telemetry.alerts import METRIC_TABLE
    assert all(METRIC_TABLE[n][0] == t for n, t in fams.items())


def test_http_reader_against_a_port_collector(fresh):
    col = tcollector.TelemetryCollector(eval_interval=3600, rules=[
        tcollector._alerts.parse_rule("deep", "paddle_tpu_serving_queue_depth > 5 for 0s")])
    try:
        http = col.serve_http()
        now = time.time()
        for k in range(4):
            col.store.ingest("r0", _snap(9, k), t=now - 2 + 0.5 * k)
        col.evaluate_once()
        reader = tas.HttpCollectorReader(f"http://127.0.0.1:1/, {http.url}", timeout=2.0)
        local = tas.LocalCollectorReader(col)
        q = dict(start=now - 3, end=now, step=0.5)
        assert reader.query("paddle_tpu_serving_queue_depth", **q) == \
            local.query("paddle_tpu_serving_queue_depth", **q)
        assert reader.urls[reader._i] == http.url   # failed over past the dead URL
        assert [a["rule"] for a in reader.alerts()["firing"]] == ["deep"]
        router = _Router(["r0"])
        with tas.Autoscaler(router, reader, tas.AutoscalePolicy(
                up_window_s=0.0, up_cooldown_s=0.0, max_replicas=2),
                trend_window_s=3.0, trend_step_s=0.5, stale_after_s=2.0) as sc:
            sig = sc.signals(now=now)
            assert sig.data_ok and sig.queue_per_replica == 9.0 and sig.alert_transition
            assert sc.tick(now=now).action == "up" and router.actions == [("grow", "r1")]
        with pytest.raises(ValueError):
            tas.HttpCollectorReader("")
    finally:
        col.close()


# -- one closed loop on the CPU -------------------------------------------------


def _feed(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"image": rng.randn(n, 784).astype(np.float32),
            "label": rng.randint(0, 10, (n, 1)).astype(np.int64)}


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    feed8 = _feed(8)
    params, _ = jpt.build(jmnist.mlp).init(jax.random.PRNGKey(0), **feed8)
    d = str(tmp_path_factory.mktemp("autoscale") / "model")
    tio.save_inference_model(d, tpt.build(tmnist.mlp),
                             params_from_jax({k: np.asarray(v) for k, v in params.items()},
                                             device="cpu"),
                             {}, feed8, batch_buckets=[1, 8])
    return d


def test_closed_loop_grows_under_a_burst_and_retires_after(fresh, artifact):
    feed1 = {k: v[:1] for k, v in _feed(8, 3).items()}
    router = FleetRouter.spawn(artifact, replicas=1, workers=1, queue_size=256,
                               device="cpu", batch_policy=BatchPolicy(max_wait_ms=2.0))
    col = tcollector.TelemetryCollector(eval_interval=3600, rules=[])
    stop = threading.Event()

    def pump():
        while not stop.wait(0.05):
            col.store.ingest("bench", ttel.get_registry().snapshot(), t=time.time())

    pumper = threading.Thread(target=pump, daemon=True)
    pumper.start()
    scaler = tas.Autoscaler(
        router, tas.LocalCollectorReader(col),
        tas.AutoscalePolicy(min_replicas=1, max_replicas=3, up_queue_per_replica=2.0,
                            down_queue_per_replica=0.5, up_window_s=0.2, down_window_s=0.6,
                            up_cooldown_s=0.3, down_cooldown_s=0.3, flap_guard_s=0.2),
        interval=0.05, trend_window_s=1.0, trend_step_s=0.1, stale_after_s=1.0).start()
    pending, rejected, peak = [], 0, 1
    try:
        # the burst: submits far faster than one worker drains them, until
        # the loop has grown the fleet (or 20 s pass)
        deadline = time.time() + 20
        while scaler.counters()["scale_ups"] == 0 and time.time() < deadline:
            for _ in range(32):
                try:
                    pending.append(router.submit(feed1))
                except tserving.ServingError:
                    rejected += 1
            time.sleep(0.002)
        peak = max(peak, len(router.replica_names))
        # quiet: every accepted request answered, then the fleet shrinks back
        answered = [p.result(timeout=60) for p in pending]
        deadline = time.time() + 30
        while len(router.replica_names) > 1 and time.time() < deadline:
            time.sleep(0.05)
        counters = scaler.counters()
        left = router.replica_names
    finally:
        scaler.close()
        stop.set()
        pumper.join(timeout=5)
        col.close()
        router.close(drain=True, timeout=60)
    assert counters["scale_ups"] >= 1 and peak >= 2, counters
    assert counters["scale_downs"] >= 1 and left == ["r0"], counters
    # no replica is left serving after close
    assert all(not r.server.health()["live"] and r.server.health()["state"] == "stopped"
               for r in router._replicas.values())
    assert len(answered) == len(pending) > 0
    assert all(np.asarray(a["logits"]).shape == (1, 10) for a in answered)
    kinds = [e["kind"] for e in ttel.get_journal().recent(kind="fleet.")]
    assert "fleet.grow" in kinds and "fleet.retire" in kinds
