"""The daemon half of the port's telemetry (``paddle_tpu_torch.telemetry``
``store``, ``alerts``, ``collector`` and the shipper's ``STATS`` and
``SEGMENTS`` clients) against ``paddle_tpu.telemetry`` on the CPU:

- ``counter_deltas`` equal; ``SegmentStore`` directories written by each
  package read back equal in the other; ``downsample`` equal;
- ``parse_rule``/``lint_rules`` messages and ``PRESET_PACK`` equal; the
  ``AlertEngine``'s firing and resolved sequence equal on the same series
  under a stepped clock;
- a shipper of each package pushing to a collector of the other: its
  ``/query``, ``/alerts`` and ``stats()`` equal to the same pushes into a
  collector of the shipper's own package;
- a standby of each package replicating a primary of the other over
  ``SEGMENTS``, then promoting with every tick;
- ``assemble_timeline`` equal; ``extra_routes``/``post_routes`` served;
- one ``CollectorProcess`` (``python -m paddle_tpu_torch.telemetry.
  collector``) started, pushed to, read and stopped."""

import json
import os
import shutil
import time
import urllib.error
import urllib.request

import pytest

from paddle_tpu import telemetry as jtel
from paddle_tpu.telemetry import alerts as jalerts
from paddle_tpu.telemetry import collector as jcollector
from paddle_tpu.telemetry import registry as jregistry
from paddle_tpu.telemetry import shipper as jshipper
from paddle_tpu.telemetry import store as jstore

from paddle_tpu_torch import telemetry as ttel
from paddle_tpu_torch.telemetry import alerts as talerts
from paddle_tpu_torch.telemetry import collector as tcollector
from paddle_tpu_torch.telemetry import http as thttp
from paddle_tpu_torch.telemetry import registry as tregistry
from paddle_tpu_torch.telemetry import shipper as tshipper
from paddle_tpu_torch.telemetry import store as tstore

PKG = {
    "jax": dict(tel=jtel, alerts=jalerts, collector=jcollector, registry=jregistry,
                shipper=jshipper, store=jstore),
    "port": dict(tel=ttel, alerts=talerts, collector=tcollector, registry=tregistry,
                 shipper=tshipper, store=tstore),
}
OTHER = {"jax": "port", "port": "jax"}


@pytest.fixture()
def fresh():
    saved = [(tel, tel.set_journal(tel.RunJournal())) for tel in (jtel, ttel)]
    try:
        yield
    finally:
        for tel, old in saved:
            tel.stop_shipping()
            j = tel.set_journal(old)
            if j is not None:
                j.close()


def _snap(name, value, labels=None, type_="gauge"):
    return {name: {"type": type_, "help": "h",
                   "samples": [{"labels": dict(labels or {}), "value": value}]}}


def test_counter_deltas_equal():
    before = {"a": 1.0, "b": 5.0, "c": 2.0}
    after = {"a": 4.0, "b": 5.0, "c": 9.5, "d": 3.0}
    for per in (1.0, 3.0, 0):
        assert tregistry.counter_deltas(before, after, per) == \
            jregistry.counter_deltas(before, after, per)
    assert ttel.counter_deltas is tregistry.counter_deltas


def test_downsample_equal():
    pts = [(0.0, 1.0), (0.2, 2.0), (0.7, 3.0), (1.1, 4.0), (3.0, 5.0)]
    for start, step in ((0.0, 0.0), (0.0, 0.5), (0.1, 1.0), (-1.0, 2.0)):
        assert tstore.downsample(pts, start, step) == jstore.downsample(pts, start, step)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_segment_store_directories_read_across(tmp_path, writer):
    src = str(tmp_path / "src")
    st = PKG[writer]["store"].SegmentStore(src, segment_max_bytes=700).open()
    for i in range(30):
        st.append({"k": "snap", "o": f"o{i % 2}", "t": 1000.0 + i,
                   "f": {**_snap("paddle_tpu_serving_queue_depth", float(i % 7),
                                 {"inst": "0"}),
                         **_snap("paddle_tpu_trainer_steps_total", float(i), {},
                                 "counter")}})
        if i % 10 == 9:
            st.append({"k": "ev", "o": "o0", "t": 1000.0 + i,
                       "events": [{"kind": "x.y", "i": i}]})
    st.close()
    reads = {}
    for name in ("jax", "port"):
        d = str(tmp_path / name)
        shutil.copytree(src, d)
        s = PKG[name]["store"].SegmentStore(d, segment_max_bytes=700)
        got = []
        s.recover(lambda kind, doc, got=got: got.append(doc))
        reads[name] = dict(
            segments=[os.path.basename(p) for p in s.segment_paths()],
            records=got, series=s.list_series(), validate=s.validate(),
            query=s.query("paddle_tpu_serving_queue_depth", {"origin": "o1"},
                          start=1000.0, end=1030.0, step=4.0),
            counter=s.query("paddle_tpu_trainer_steps_total", start=1000.0,
                            end=1030.0))
    assert reads["port"] == reads["jax"]
    assert len(reads["port"]["segments"]) >= 3 and reads["port"]["validate"] == []
    assert len(reads["port"]["records"]) == 33


RULES = [
    'paddle_tpu_serving_queue_depth{origin="r0"} >= 8 for 5s',
    "rate(paddle_tpu_serving_rejected_total[30s]) > 1.5 for 1m",
    "p99(paddle_tpu_serving_latency_seconds[60s]) > 0.5",
    "absent(paddle_tpu_serving_submitted_total[15s]) for 10s",
    "absent(origin[10s]) for 10s",
]
BAD = ["paddle_tpu_x", "rate(foo) > 1", "absent(foo) for 5s", "foo > bar",
       "p99(x[5s]) > 1 for 5q", ""]


def test_rule_grammar_lint_messages_and_preset_pack_equal():
    for expr in RULES:
        t, j = talerts.parse_rule("r", expr, severity="page"), \
            jalerts.parse_rule("r", expr, severity="page")
        assert t.describe() == j.describe()
    for bad in BAD:
        with pytest.raises(talerts.AlertRuleError) as te:
            talerts.parse_rule("bad", bad)
        with pytest.raises(jalerts.AlertRuleError) as je:
            jalerts.parse_rule("bad", bad)
        assert str(te.value) == str(je.value)
    specs = [
        {"name": "ok", "expr": "rate(paddle_tpu_serving_rejected_total[30s]) > 1 for 30s"},
        {"name": "typo", "expr": "paddle_tpu_srving_queue_depth > 1 for 5s"},
        {"name": "badlabel", "expr": "paddle_tpu_serving_queue_depth{flavor=blue} > 1 for 5s"},
        {"name": "broken", "expr": "rate(nope"},
        {"name": "ratetype", "expr": "rate(paddle_tpu_serving_queue_depth[30s]) > 1 for 30s"},
        {"name": "qtype", "expr": "p99(paddle_tpu_serving_queue_depth[30s]) > 1 for 30s"},
        {"name": "histthresh", "expr": "paddle_tpu_serving_latency_seconds > 1 for 5s"},
        {"name": "ok", "expr": "absent(origin[10s]) for 10s"},
        "oops", None,
    ]
    findings = talerts.lint_rules(specs)
    assert findings == jalerts.lint_rules(specs) and len(findings) >= 7
    assert talerts.PRESET_PACK == jalerts.PRESET_PACK
    assert talerts.lint_rules(talerts.PRESET_PACK) == []
    assert talerts.METRIC_TABLE == jalerts.METRIC_TABLE
    assert [r.describe() for r in talerts.preset_rules(for_s=0.5, window_s=1.0)] == \
        [r.describe() for r in jalerts.preset_rules(for_s=0.5, window_s=1.0)]


def test_load_rules_reads_the_same_file(tmp_path):
    p = tmp_path / "rules.json"
    p.write_text(json.dumps({"rules": jalerts.PRESET_PACK}))
    assert [r.describe() for r in talerts.load_rules(str(p))] == \
        [r.describe() for r in jalerts.load_rules(str(p))]


def _engine_run(pkg):
    """One scripted series under a stepped clock through each rule form:
    the transitions as the engine reports them and its final snapshot."""
    m = PKG[pkg]
    store = m["collector"].SeriesStore()
    rules = [m["alerts"].parse_rule("depth", "paddle_tpu_serving_queue_depth > 5 for 3s",
                                    severity="page"),
             m["alerts"].parse_rule("rej", "rate(paddle_tpu_serving_rejected_total[4s]) > 1"),
             m["alerts"].parse_rule("gone", "absent(paddle_tpu_serving_submitted_total[3s])"),
             m["alerts"].parse_rule("p99", "p99(paddle_tpu_serving_latency_seconds[4s]) > 0.5")]
    seen = []
    eng = m["alerts"].AlertEngine(rules, on_transition=seen.append)
    t0, out = 100.0, []
    depth = [9, 9, 9, 9, 1, 9, 9, 9, 9, 9, 0, 0]
    for i, d in enumerate(depth):
        t = t0 + i
        snap = {**_snap("paddle_tpu_serving_queue_depth", d),
                **_snap("paddle_tpu_serving_rejected_total", 3.0 * i * (i < 6), {}, "counter"),
                "paddle_tpu_serving_latency_seconds": {
                    "type": "histogram", "help": "h", "samples": [{"labels": {}, "value": {
                        "bounds": [0.1, 1.0], "counts": [i, 3 * i * (i > 4), 0],
                        "sum": 0.0, "count": i + 3 * i * (i > 4)}}]}}
        if i < 4:
            snap.update(_snap("paddle_tpu_serving_submitted_total", float(i), {}, "counter"))
        store.ingest("r0", snap, t=t)
        out.append([{k: v for k, v in tr.items() if k != "value"}
                    for tr in eng.evaluate(store, now=t)])
    snap = eng.snapshot(now=t0 + len(depth))
    return out, seen, {k: snap[k] for k in ("firing", "pending", "resolved")}


def test_alert_engine_sequence_equal():
    t_out, t_seen, t_snap = _engine_run("port")
    j_out, j_seen, j_snap = _engine_run("jax")
    assert t_out == j_out and t_snap == j_snap
    assert [s["state"] for s in t_seen] == [s["state"] for s in j_seen]
    states = [(tr["rule"], tr["state"]) for step in t_out for tr in step]
    # the depth rule's for_s clock restarts after the dip at step 4
    assert states.count(("depth", "firing")) == 2 and ("depth", "resolved") in states
    assert ("rej", "firing") in states and ("gone", "firing") in states
    assert ("p99", "firing") in states


# -- the wire: a shipper of one package, collectors of both ------------------


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


def _push(pkg, addr, origin):
    """The same pushes from a shipper of ``pkg``: events, then two
    snapshots of a registry of its own."""
    m = PKG[pkg]
    j = m["tel"].RunJournal()
    reg = m["registry"].MetricsRegistry()
    g = reg.gauge("paddle_tpu_serving_queue_depth", "queue")
    c = reg.counter("paddle_tpu_trainer_steps_total", "steps")
    sh = m["shipper"].Shipper(f"{addr[0]}:{addr[1]}", origin=origin, journal=j,
                              registry=reg, flush_interval=3600, client_timeout=5.0)
    try:
        span = j.new_span()
        for k in ("feeder.fill", "trainer.dispatch", "trainer.step"):
            j.emit(k, span=span, step=1)
        g.set(9)
        c.inc(3)
        sh.flush()
        c.inc(2)
        sh.flush()
        return span, sh.report(), sh.collector_stats()
    finally:
        sh.close(timeout=5)


def _view(col, url, span):
    """What a reader sees of one origin's pushes, the times left out."""
    def values(metric):
        doc = _get(f"{url}/query?metric={metric}&labels=origin=o1&from=0")
        return [(s["key"], [v for _, v in s["points"]]) for s in doc["series"]]
    alerts = _get(url + "/alerts")
    stats = col.stats()
    tl = col.timeline(span)
    return dict(depth=values("paddle_tpu_serving_queue_depth"),
                steps=values("paddle_tpu_trainer_steps_total"),
                firing=sorted((a["rule"], a["key"]) for a in alerts["firing"]),
                rules=sorted(r["name"] for r in alerts["rules"]),
                timeline=[e["kind"] for e in tl["events"]], origins=tl["origins"],
                stats={k: stats[k] for k in ("events", "snapshots", "dup_events",
                                             "event_batches", "bad_requests", "origins")},
                store={k: stats["store"][k] for k in ("appends", "segments_sealed",
                                                      "append_failures")})


@pytest.mark.parametrize("shipper_pkg", ["jax", "port"])
def test_shipper_pushes_to_the_other_packages_collector(fresh, tmp_path, shipper_pkg):
    rule = [{"name": "deep", "expr": "paddle_tpu_serving_queue_depth > 5 for 0s"}]
    views, reports = {}, {}
    for col_pkg in (shipper_pkg, OTHER[shipper_pkg]):
        m = PKG[col_pkg]
        rules = [m["alerts"].parse_rule(r["name"], r["expr"]) for r in rule]
        with m["collector"].TelemetryCollector(eval_interval=3600, rules=rules,
                                               store_dir=str(tmp_path / col_pkg)) as col:
            span, report, cstats = _push(shipper_pkg, col.addr, "o1")
            col.evaluate_once()
            http = col.serve_http()
            views[col_pkg] = _view(col, http.url, span)
            reports[col_pkg] = (report["events_shipped"], report["flush_failures"],
                                cstats["snapshots"], cstats["events"])
    assert views[OTHER[shipper_pkg]] == views[shipper_pkg]
    assert reports[OTHER[shipper_pkg]] == reports[shipper_pkg] == (3, 0, 2, 3)
    v = views["port"]
    # a snapshot a flush, and one more as the shipper closes
    assert v["depth"] and v["depth"][0][1] == [9.0, 9.0, 9.0]
    assert v["steps"][0][1] == [3.0, 5.0, 5.0]
    assert v["firing"] == [("deep", v["firing"][0][1])] and "o1" in v["firing"][0][1]
    assert v["timeline"] == ["feeder.fill", "trainer.dispatch", "trainer.step"]


def _crash(col):
    """Stop a collector without its clean close (a host's death)."""
    col._stop.set()
    try:
        col._ls.close()
    except OSError:
        pass
    col._eval_thread.join(timeout=5)
    col._seg.close()


@pytest.mark.parametrize("primary_pkg", ["jax", "port"])
def test_standby_of_one_package_replicates_a_primary_of_the_other(fresh, tmp_path,
                                                                  primary_pkg):
    sp = OTHER[primary_pkg]
    P, S = PKG[primary_pkg], PKG[sp]
    primary = P["collector"].TelemetryCollector(
        eval_interval=3600, rules=[], store_dir=str(tmp_path / "primary"),
        segment_max_bytes=1200)
    standby = S["collector"].TelemetryCollector(
        eval_interval=3600, rules=[], store_dir=str(tmp_path / "standby"), standby=True,
        takeover_s=30.0, replicate_from=f"{primary.host}:{primary.port}",
        replicate_interval=3600)
    j = P["tel"].RunJournal()
    reg = P["registry"].MetricsRegistry()
    reg.gauge("paddle_tpu_serving_queue_depth", "h").set(4)
    sh = P["shipper"].Shipper(f"{primary.host}:{primary.port}", origin="o1", journal=j,
                              registry=reg, flush_interval=3600, client_timeout=2.0)
    try:
        for i in range(24):
            j.emit("rep.tick", i=i)
            if i % 6 == 5:
                sh.flush()
        sh.flush()
        listing = S["shipper"].ReplicationClient(primary.addr).listing()
        assert len(listing["segments"]) >= 1
        adopted = standby._replicate_once()
        st = standby.stats()["store"]
        assert adopted >= 1 and st["repl_segments"] == adopted and st["repl_corrupt"] == 0
        with pytest.raises(RuntimeError, match="still answers"):
            standby.promote()
        want = primary.query("paddle_tpu_serving_queue_depth", start=0.0, end=time.time())
        _crash(primary)
        assert standby.promote() is True
        ticks = [e["i"] for e in standby.journal.recent(kind="rep.")
                 if e.get("origin") == "o1"]
        assert ticks == list(range(24))
        got = standby.query("paddle_tpu_serving_queue_depth", start=0.0, end=want["to"])
        assert got["series"] == want["series"] and got["series"]
    finally:
        sh.close(timeout=5)
        standby.close()
        primary.close()


def test_assemble_timeline_and_text_equal():
    events = [
        {"t": 10.0, "seq": 2, "kind": "b", "span": "s", "origin": "o2", "extra": 7},
        {"t": 9.5, "seq": 1, "kind": "a", "span": "s", "origin": "o1"},
        {"t": 11.0, "seq": 3, "kind": "c", "span": "OTHER"},
        {"t": 10.25, "seq": 4, "kind": "d", "span": "s"},
    ]
    t, j = tcollector.assemble_timeline(events, "s"), jcollector.assemble_timeline(events, "s")
    assert t == j and sorted(e["kind"] for e in t["events"]) == ["a", "b", "d"]
    assert tcollector.render_timeline_text(t) == jcollector.render_timeline_text(j)
    assert tcollector.assemble_timeline(events, "missing") == \
        jcollector.assemble_timeline(events, "missing")


def test_extra_and_post_routes_served():
    posted = []
    srv = thttp.serve_metrics(
        registry=tregistry.MetricsRegistry(), port=0,
        extra_routes={"/hello": lambda q: (200, "text/plain", f"hi {q}".encode()),
                      "/boom": lambda q: 1 / 0},
        post_routes={"/echo": lambda q, body: (posted.append(body) or 201, "text/plain",
                                               body[::-1])})
    try:
        with urllib.request.urlopen(srv.url + "/hello?x=1", timeout=10) as r:
            assert r.read() == b"hi x=1"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(srv.url + "/boom", timeout=10)
        assert e.value.code == 500
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(srv.url + "/nope", timeout=10)
        assert e.value.code == 404 and b"/hello" in e.value.read()
        req = urllib.request.Request(srv.url + "/echo", data=b"abc", method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 201 and r.read() == b"cba"
        assert posted == [b"abc"]
        req = urllib.request.Request(srv.url + "/missing", data=b"x", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 404
        big = urllib.request.Request(srv.url + "/echo", data=b"x" * (thttp.MAX_POST_BODY + 1),
                                     method="POST")
        with pytest.raises((urllib.error.HTTPError, urllib.error.URLError, OSError)):
            urllib.request.urlopen(big, timeout=10)
    finally:
        srv.close()


def test_collector_process_starts_serves_and_stops(fresh, tmp_path):
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps(talerts.PRESET_PACK + [
        {"name": "steps", "expr": "paddle_tpu_trainer_steps_total > 2 for 0s"}]))
    cp = tcollector.CollectorProcess(rules_path=str(rules), store_dir=str(tmp_path / "st"),
                                     args=("--eval-interval", "0.1"))
    try:
        span, report, cstats = _push("port", cp.addr, "o1")
        assert report["flush_failures"] == 0 and cstats["snapshots"] == 2
        doc = _get(cp.http_url + "/query?metric=paddle_tpu_trainer_steps_total"
                   "&labels=origin=o1")
        assert [v for _, v in doc["series"][0]["points"]] == [3.0, 5.0, 5.0]
        deadline = time.time() + 10
        while time.time() < deadline:
            firing = _get(cp.http_url + "/alerts")["firing"]
            if firing:
                break
            time.sleep(0.1)
        assert [a["rule"] for a in firing] == ["steps"]
        tl = _get(cp.http_url + f"/timeline?trace={span}")
        assert [e["kind"] for e in tl["events"]] == \
            ["feeder.fill", "trainer.dispatch", "trainer.step"]
        stats = tshipper.ShipperClient(cp.addr).stats()
        assert stats["persistence"] is True and stats["store"]["appends"] >= 3
    finally:
        cp.stop()
    assert cp._proc.poll() is not None
