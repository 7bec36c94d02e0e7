"""The port's process telemetry (``paddle_tpu_torch.telemetry``, the
segment log of ``paddle_tpu_torch.resilience`` and ``profiling.StepTimer``)
against the JAX package's, on the CPU.

- The CRC-framed segment log: frames byte for byte the JAX package's, and
  each package's ``iter_records``/``check_segment`` reads the other's
  segments, a torn tail and a flipped bit included.
- The journal: the same sequence of events gives the same JSONL lines (the
  run id fixed, times and spans masked), the same deterministic sampling,
  and a ``StepTimer`` dispatch gives the same event.
- The registry: the same metrics and collectors render the same
  Prometheus text, JSON snapshot and naming findings.
- A port flight dump is read and validated by the JAX package's
  ``tools/flight_dump.py``.
- ``/metrics`` and ``/healthz`` scraped over HTTP from a port endpoint.
- The port's ``Shipper`` pushes to the JAX package's in-process
  ``TelemetryCollector`` beside a JAX shipper: the two origins' events and
  families are equal.

Everything is exact (the same text)."""

import json
import os
import re
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu import resilience as jres
from paddle_tpu import telemetry as jtel
from paddle_tpu.profiling.steptime import StepTimer as JStepTimer
from paddle_tpu.telemetry import shipper as jship

from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch import telemetry as ttel
from paddle_tpu_torch.profiling import StepTimer as TStepTimer
from paddle_tpu_torch.telemetry import shipper as tship

PKGS = {"jax": (jres, jtel), "port": (tres, ttel)}
PAYLOADS = [b"{}", json.dumps({"a": 1, "b": [1.5, "x"]}).encode(), b"x" * 300,
            "été".encode()]


def test_segment_frames_are_the_jax_frames():
    for payload in PAYLOADS:
        assert tres.frame_record(payload) == jres.frame_record(payload)
    for mod in (tres, jres):
        with pytest.raises(ValueError, match="newline-free"):
            mod.frame_record(b"a\nb")
    assert tres.SEGMENT_META_SUFFIX == jres.SEGMENT_META_SUFFIX


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_segments(tmp_path, writer):
    wres = PKGS[writer][0]
    path = str(tmp_path / "seg-000001.log")
    with open(path, "wb") as f:
        for p in PAYLOADS:
            f.write(wres.frame_record(p))
    doc = wres.seal_segment(path, meta={"records": len(PAYLOADS)})
    assert doc["records"] == len(PAYLOADS)
    for res in (jres, tres):
        assert list(res.iter_records(path)) == [(True, p) for p in PAYLOADS]
        assert res.check_segment(path) == (True, "")
    # a flipped bit in the second record, and a torn tail
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    raw[raw.index(b"\n") + 15] ^= 0x01
    with open(path, "wb") as f:
        f.write(bytes(raw) + wres.frame_record(b"torn")[:-3])
    got = {name: list(res.iter_records(path)) for name, res in (("jax", jres), ("port", tres))}
    assert got["jax"] == got["port"]
    assert [ok for ok, _ in got["port"]] == [True, False, True, True, False]
    assert got["port"][-1] == (False, "torn tail (no trailing newline)")
    checks = {name: res.check_segment(path) for name, res in (("jax", jres), ("port", tres))}
    assert checks["jax"] == checks["port"] and checks["port"][0] is False
    os.remove(path + jres.SEGMENT_META_SUFFIX)
    assert jres.check_segment(path)[0] is False and tres.check_segment(path)[0] is False


def _journal_lines(tel, timer_cls, path, sample=None):
    j = tel.RunJournal(run_id="20260101T000000-0123abcd", sample=sample).open(path)
    span = j.new_span()
    j.emit("trainer.dispatch", span=span, dispatch="run_steps", num_steps=4, base_step=8,
           dur_s=0.25)
    j.emit("ckpt.save", tag="step_12", path="/ck/step_12", global_step=12, seconds=0.5)
    j.emit("guard.incident", step=3, outputs=["grads", "loss"], feed_digest=None)
    j.emit("serving.submit", span=j.new_span(), inst="0", n=np.int64(3), bucket=4,
           deadline_s=None, queue_depth=0)
    j.emit("feeder.fill", span=span, num_steps=4, nbytes=np.int32(1024),
           extra=np.arange(3, dtype=np.float32))
    for i in range(12):
        j.emit("ps.step", inst="0", step=i)
    timer = timer_cls(journal=j, inst="0")
    timer.record_dispatch(10.0, 10.125, 16, "run_steps", span=span, base_step=16)
    j.close()
    with open(path) as f:
        lines = f.read().splitlines()
    return lines, j.dropped_sampled, timer.report()


def _mask(line):
    line = re.sub(r'"t": [0-9.e+-]+', '"t": T', line)
    return re.sub(r'"span": "[0-9a-f]{16}"', lambda m: '"span": S', line)


@pytest.mark.parametrize("sample", [None, {"ps": 0.5, "serving": 0.0}])
def test_journal_lines_equal_the_jax_lines(tmp_path, sample):
    jl, jdrop, jrep = _journal_lines(jtel, JStepTimer, str(tmp_path / "jax.jsonl"), sample)
    tl, tdrop, trep = _journal_lines(ttel, TStepTimer, str(tmp_path / "port.jsonl"), sample)
    assert [_mask(x) for x in tl] == [_mask(x) for x in jl]
    assert tdrop == jdrop and (tdrop > 0) == (sample is not None)
    assert trep == jrep
    # the spans a journal mints: 16 hex characters, a per-process prefix
    spans = [json.loads(x).get("span") for x in tl if "span" in json.loads(x)]
    assert all(re.fullmatch(r"[0-9a-f]{16}", s) for s in spans)
    assert len({s[:8] for s in spans}) == 1
    assert ttel.parse_sample("serving=0.01, ps=2,bad,x=y") == \
        jtel.parse_sample("serving=0.01, ps=2,bad,x=y")


def _fill_registry(tel):
    reg = tel.MetricsRegistry()
    c = reg.counter("paddle_tpu_trainer_checkpoints_total", "Checkpoints committed by fit",
                    ("kind",))
    c.inc(kind="step")
    c.inc(kind="step")
    c.inc(kind="epoch")
    reg.gauge("paddle_tpu_serving_queue_depth", "Requests queued", ("inst",)).set(3, inst="1")
    h = reg.histogram("paddle_tpu_ckpt_save_seconds", "Save seconds", ("kind",))
    for v in (0.001, 0.02, 0.3, 4.0, 90.0):
        h.observe(v, kind="step")
    inst = reg.next_instance("trainer")
    reg.add_collector(lambda: [
        tel.counter_family("paddle_tpu_trainer_steps_total", "Optimizer steps",
                           [({"inst": inst}, 32)]),
        tel.histogram_family("paddle_tpu_serving_latency_seconds", "Latency",
                             {"inst": inst}, [0.001, 0.01, 0.1], [1, 2, 0, 4], 1.25, 7)])
    reg.add_collector(lambda: [tel.gauge_family("paddle_tpu_bad-name", "", [({}, 1)])])
    return reg


def test_registry_renders_the_jax_text():
    jreg, treg = _fill_registry(jtel), _fill_registry(ttel)
    assert treg.render_prometheus() == jreg.render_prometheus()
    assert treg.render_json() == jreg.render_json()
    assert treg.validate() == jreg.validate() and treg.validate()
    assert treg.counter_values() == jreg.counter_values()
    fams = [f for f in treg.collect() if f.name != "paddle_tpu_bad-name"]
    assert ttel.validate_families(fams) == []
    assert ttel.families_snapshot(fams) == jtel.families_snapshot(
        [f for f in jreg.collect() if f.name != "paddle_tpu_bad-name"])
    assert ttel.render_families_prometheus(fams) == jtel.render_families_prometheus(
        [f for f in jreg.collect() if f.name != "paddle_tpu_bad-name"])


def test_port_flight_dump_reads_with_the_jax_tool(tmp_path):
    import importlib

    tool = importlib.import_module("tools.flight_dump")
    j = ttel.RunJournal()
    span = j.new_span()
    j.emit("guard.incident", step=4, outputs=["loss"], feed_digest="ab12")
    j.emit("guard.escalation", span=span, step=5, error="2 non-finite steps")
    rec = ttel.FlightRecorder(journal=j, root=str(tmp_path), max_dumps=2)
    paths = [rec.dump("guard_escalation", detail={"step": 5}, span=span) for _ in range(3)]
    assert all(paths) and len(set(paths)) == 1   # the same seq: replaced, not added
    j.emit("fit.preempted", epoch=0, global_step=6, signum=15)
    last = rec.dump("preempted", detail={"global_step": 6})
    meta, events = tool.load_dump(last)   # validated against its CRC manifest
    assert meta["trigger"] == "preempted" and meta["run"] == j.run_id
    assert meta["num_events"] == 3 and meta["last_seq"] == 3
    assert [e["kind"] for e in events] == ["guard.incident", "guard.escalation",
                                           "fit.preempted"]
    assert tool.filter_events(events, span=span)[0]["error"] == "2 non-finite steps"
    assert "metrics" in meta
    dumps = sorted(p for p in os.listdir(tmp_path) if p.startswith("flight_"))
    assert len(dumps) == 2
    # a flipped byte fails the JAX tool's validation
    with open(os.path.join(last, "events.jsonl"), "r+b") as f:
        f.seek(5)
        b = f.read(1)
        f.seek(5)
        f.write(bytes([b[0] ^ 1]))
    with pytest.raises(jres.CheckpointCorrupt):
        tool.load_dump(last)


def test_metrics_and_healthz_over_http():
    reg = _fill_registry(ttel)
    live = {"live": True, "role": "trainer"}
    srv = ttel.serve_metrics(registry=reg, health_fn=lambda: dict(live))
    try:
        text = urllib.request.urlopen(srv.url + "/metrics", timeout=10).read().decode()
        assert text == reg.render_prometheus()
        assert 'paddle_tpu_trainer_checkpoints_total{kind="step"} 2' in text
        snap = json.loads(urllib.request.urlopen(srv.url + "/metrics?format=json",
                                                 timeout=10).read())
        assert snap == json.loads(reg.render_json())
        assert json.loads(urllib.request.urlopen(srv.url + "/healthz",
                                                 timeout=10).read()) == live
        live["live"] = False
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.url + "/healthz", timeout=10)
        assert ei.value.code == 503
    finally:
        srv.close()


def _ship_same(tel, ship, addr, origin):
    j = tel.RunJournal(run_id=f"run-{origin}")
    reg = _fill_registry(tel)
    sh = ship.Shipper(addr, origin=origin, journal=j, registry=reg, flush_interval=3600.0)
    try:
        span = j.new_span()
        j.emit("trainer.dispatch", span=span, dispatch="step", num_steps=1, base_step=0,
               dur_s=0.01)
        j.emit("ckpt.save", tag="step_1", path="/ck", global_step=1, seconds=0.1)
        j.emit("serving.complete", span=j.new_span(), inst="0", worker=0,
               latency_s=np.float64(0.002))
        sh.flush()
        return sh.report()
    finally:
        sh.close()


def test_port_shipper_is_taken_by_the_jax_collector():
    from paddle_tpu.telemetry.collector import TelemetryCollector

    with TelemetryCollector(eval_interval=3600) as col:
        reports = {"jax": _ship_same(jtel, jship, col.addr, "jaxside"),
                   "port": _ship_same(ttel, tship, col.addr, "portside")}
        assert reports["port"]["events_shipped"] == reports["jax"]["events_shipped"] == 3
        assert reports["port"]["flush_failures"] == 0
        events = {o: [{k: v for k, v in e.items() if k not in ("t", "span", "run", "origin")}
                      for e in col.journal.recent() if e.get("origin") == o]
                  for o in ("jaxside", "portside")}
        assert events["portside"] == events["jaxside"] and len(events["portside"]) == 3

        def by_origin(origin):
            out = {}
            for fam in col.families():
                samples = sorted((json.dumps({k: v for k, v in lab.items() if k != "origin"},
                                             sort_keys=True), json.dumps(val, sort_keys=True))
                                 for lab, val in fam.samples if lab.get("origin") == origin)
                if samples:
                    out[fam.name] = (fam.type, samples)
            return out

        port, jax_ = by_origin("portside"), by_origin("jaxside")
        shipper_fams = {n for n in port if n.startswith("paddle_tpu_shipper_")}
        assert shipper_fams   # each shipper ships its own counters too
        assert {n: v for n, v in port.items() if n not in shipper_fams} == \
            {n: v for n, v in jax_.items() if n not in shipper_fams}
        assert sorted(port) == sorted(jax_)
