"""The port's telemetry wired through ``fit``, the ``DeviceFeeder`` and the
``PredictorServer``, held against the JAX package on the same run, on the
CPU.

- An MNIST ``fit`` with a checkpoint config, a NaN planted in one batch
  under the guard, and either a SIGTERM (the run preempts at a step
  boundary) or a guard that escalates at the first incident: the sequence
  of journal event kinds, each event's keys, the flight dumps' triggers
  and the trainer's registry family names equal the JAX package's.
- A ``DeviceFeeder`` with a journal: one ``feeder.fill`` event a chunk,
  with the JAX event's keys, and ``fit`` hands each chunk's span to its
  dispatch.
- A ``PredictorServer`` with a served request, a rejected one and one
  that expires in the queue: the same span-correlated events with the
  same keys, and the JAX server's family names, the breaker's, the
  watchdog's and hot reload's included.

Each test takes a fresh journal in both packages and roots both flight
recorders under its temporary directory."""

import contextlib
import os
import signal

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import io as jio
from paddle_tpu import optimizer as jopt
from paddle_tpu import resilience as jres
from paddle_tpu import serving as jserving
from paddle_tpu import telemetry as jtel
from paddle_tpu.data import feeder as jfeeder
from paddle_tpu.models import mnist as jmnist

import paddle_tpu_torch as tpt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch import telemetry as ttel
from paddle_tpu_torch.data import feeder as tfeeder
from paddle_tpu_torch.framework import params_from_jax
from paddle_tpu_torch.models import mnist as tmnist

CPU = "cpu"
BATCHES, BATCH = 5, 16
NAN_BATCH = 1
@contextlib.contextmanager
def _fresh_journals(tmp_path):
    """A fresh process journal in each package, both flight recorders
    rooted under ``tmp_path / <package>``."""
    saved = []
    for name, tel in (("jax", jtel), ("port", ttel)):
        rec = tel.get_recorder()
        saved.append((tel, tel.set_journal(tel.RunJournal()), rec.root))
        rec.set_root(str(tmp_path / name / "flight"))
    try:
        yield {"jax": jtel.get_journal(), "port": ttel.get_journal()}
    finally:
        for tel, journal, root in saved:
            tel.get_recorder().set_root(root)
            tel.set_journal(journal).close()


@pytest.fixture()
def fresh(tmp_path):
    with _fresh_journals(tmp_path) as journals:
        yield journals


def _reader():
    rng = np.random.RandomState(0)
    batches = []
    for b in range(BATCHES):
        image = rng.rand(BATCH, 784).astype(np.float32)
        if b == NAN_BATCH:
            image[0, 0] = np.nan
        label = rng.randint(0, 10, (BATCH, 1)).astype(np.int64)
        batches.append([(image[i], label[i]) for i in range(BATCH)])
    return lambda: iter(batches)


def _sample():
    return {"image": np.zeros((BATCH, 784), np.float32),
            "label": np.zeros((BATCH, 1), np.int64)}


def _shape(journal):
    """(kind, sorted keys) of every retained event, oldest first."""
    return [(e["kind"], sorted(e)) for e in journal.recent()]


def _families_now(tel):
    """{family name: its samples} of the package's process-global registry."""
    return {f.name: repr(f.samples) for f in tel.get_registry().collect()}


def _trainer_families(tel, trainer, before):
    """The trainer and feeder families that this run registered or moved
    since ``before`` (a :func:`_families_now` snapshot), and every family
    labelled with this trainer's ``inst``. The registry outlives a test: a
    family that an earlier test of the process registered and this run left
    alone (an elastic test's ``paddle_tpu_trainer_resizes_total``) is not
    this run's."""
    return sorted({f.name for f in tel.get_registry().collect()
                   if ((f.name.startswith("paddle_tpu_trainer_")
                        or f.name.startswith("paddle_tpu_feeder_"))
                       and before.get(f.name) != repr(f.samples))
                   or any(lab.get("inst") == trainer.telemetry_inst
                          for lab, _ in f.samples)})


def _run_fit(pkg, tmp_path, case):
    """One MNIST fit in ``pkg``; returns (trainer, the error it raised)."""
    guard = {"preempt": dict(max_incidents=5),
             "escalate": dict(max_incidents=0, defer_readback=False)}[case]
    ckpt = str(tmp_path / pkg / "ckpt")

    def handler(ev):
        if case == "preempt" and ev.kind == "end_step" and ev.step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    if pkg == "jax":
        tr = jpt.Trainer(jpt.build(jmnist.mlp), jopt.SGD(0.05),
                         guard=jres.GuardPolicy(**guard))
        tr.startup(jax.random.PRNGKey(0), sample_feed=_sample())
        run = lambda: jpt.fit(tr, _reader(), 1, ["image", "label"], event_handler=handler,  # noqa: E731
                              checkpoint_config=jpt.CheckpointConfig(ckpt, step_interval=2),
                              prefetch=False)
    else:
        tr = tpt.Trainer(tpt.build(tmnist.mlp), topt.SGD(0.05), place=CPU,
                         guard=tres.GuardPolicy(**guard))
        tr.startup(0, sample_feed=_sample())
        run = lambda: tpt.fit(tr, _reader(), 1, ["image", "label"], event_handler=handler,  # noqa: E731
                              checkpoint_config=tpt.CheckpointConfig(ckpt, step_interval=2),
                              prefetch=False)
    try:
        run()
    except FloatingPointError as e:
        return tr, e
    return tr, None


@pytest.mark.parametrize("case", ["preempt", "escalate"])
def test_fit_journal_dumps_and_families_equal_jax(fresh, tmp_path, case):
    _fit_against_jax(fresh, tmp_path, case)


def test_families_equal_jax_after_a_port_resize_in_the_process(tmp_path):
    """The comparison above holds after a port ``fit`` that handled a
    scheduled resize in the same process, whose
    ``paddle_tpu_trainer_resizes_total`` the port's registry keeps and the
    JAX package's does not have."""
    tr = tpt.Trainer(tpt.build(tmnist.mlp), topt.SGD(0.05), place=CPU)
    tr.startup(0, sample_feed=_sample())
    rz = tres.ResizeRequest(str(tmp_path / "resize.json"))

    def handler(ev):
        if ev.kind == "end_step" and ev.step == 1:
            rz.request({"dp": 2})

    tpt.fit(tr, _reader(), 1, ["image", "label"], event_handler=handler, resize=rz,
            checkpoint_config=tpt.CheckpointConfig(str(tmp_path / "resized"),
                                                   step_interval=100),
            prefetch=False)
    assert tr.global_step == 1
    assert "paddle_tpu_trainer_resizes_total" in _families_now(ttel)
    with _fresh_journals(tmp_path / "after") as journals:
        _fit_against_jax(journals, tmp_path / "after", "preempt")


def _fit_against_jax(fresh, tmp_path, case):
    import importlib

    tool = importlib.import_module("tools.flight_dump")
    before = {"jax": _families_now(jtel), "port": _families_now(ttel)}
    runs = {pkg: _run_fit(pkg, tmp_path, case) for pkg in ("jax", "port")}
    shapes = {pkg: _shape(fresh[pkg]) for pkg in runs}
    assert shapes["port"] == shapes["jax"]
    kinds = [k for k, _ in shapes["port"]]
    assert kinds.count("trainer.dispatch") == (3 if case == "preempt" else NAN_BATCH + 1)
    assert "guard.incident" in kinds
    want_last = "fit.preempted" if case == "preempt" else "guard.escalation"
    assert kinds[-1] == want_last
    assert (runs["port"][1] is None) == (case == "preempt")
    dumps = {}
    for pkg in runs:
        root = tmp_path / pkg / "ckpt" / "flight"   # fit re-roots the recorder
        names = sorted(os.listdir(root))
        dumps[pkg] = [n.split("_", 3)[-1] for n in names]   # flight_<run>_<seq>_<trigger>
        meta, events = tool.load_dump(str(root / names[-1]))   # validated
        assert [e["kind"] for e in events][-1] == want_last
        assert meta["trigger"] == dumps[pkg][-1]
    assert dumps["port"] == dumps["jax"]
    fams = {pkg: _trainer_families(tel, runs[pkg][0], before[pkg])
            for pkg, tel in (("jax", jtel), ("port", ttel))}
    assert fams["port"] == fams["jax"]
    assert "paddle_tpu_trainer_dispatches_total" in fams["port"]
    tr = runs["port"][0]
    assert tr.step_timer.report()["dispatches"] == kinds.count("trainer.dispatch")
    assert tr.guard_incident_total == 1


def test_device_feeder_spans_reach_the_dispatches(fresh, monkeypatch):
    batches = [{"image": np.full((4, 784), i, np.float32),
                "label": np.zeros((4, 1), np.int64)} for i in range(5)]
    events = {}
    for pkg, mod in (("jax", jfeeder), ("port", tfeeder)):
        feeder = mod.DeviceFeeder(lambda: iter(batches), put_fn=lambda b: b, stack_k=2,
                                  put_stacked_fn=lambda b: b, journal=fresh[pkg])
        spans = [feeder.last_span for _ in feeder]
        events[pkg] = fresh[pkg].recent(kind="feeder.fill")
        assert [e["span"] for e in events[pkg]] == spans
    assert [(e["num_steps"], e["nbytes"], sorted(e)) for e in events["port"]] == \
        [(e["num_steps"], e["nbytes"], sorted(e)) for e in events["jax"]]
    # fit's prefetch: each dispatch's event carries its chunk's fill span
    orig = tfeeder.DeviceFeeder

    class OnCPU(orig):
        def __init__(self, batches, device=None, **kw):
            super().__init__(batches, put_fn=lambda b: {k: torch.from_numpy(np.asarray(v))
                                                        for k, v in b.items()}, **kw)

    monkeypatch.setattr(tfeeder, "DeviceFeeder", OnCPU)
    tr = tpt.Trainer(tpt.build(tmnist.mlp), topt.SGD(0.05), place=CPU)
    tr.startup(0, sample_feed=_sample())
    j = fresh["port"]
    start = j.seq
    tpt.fit(tr, _reader(), 1, ["image", "label"], prefetch=True, steps_per_dispatch=2)
    fills = [e["span"] for e in j.recent(kind="feeder.fill") if e["seq"] > start]
    dispatches = j.recent(kind="trainer.dispatch")
    assert [e["span"] for e in dispatches] == fills and len(fills) == 3
    assert [e["num_steps"] for e in dispatches] == [2, 2, 1]
    rep = {f.name: f for f in ttel.get_registry().collect()}
    by_kind = {lab["kind"]: v for lab, v in rep["paddle_tpu_trainer_dispatches_total"].samples
               if lab["inst"] == tr.telemetry_inst}
    assert by_kind == {"run_steps": 2, "step": 1}
    assert [v for lab, v in rep["paddle_tpu_trainer_steps_total"].samples
            if lab["inst"] == tr.telemetry_inst] == [5]


def _servers(tmp_path):
    jprog = jpt.build(jmnist.mlp)
    feed = {"image": np.random.RandomState(1).rand(8, 784).astype(np.float32),
            "label": np.zeros((8, 1), np.int64)}
    params, state = jprog.init(jax.random.PRNGKey(0), **feed)
    jd, td = str(tmp_path / "jax_model"), str(tmp_path / "port_model")
    jio.save_inference_model(jd, jprog, params, state, feed, batch_buckets=[4, 8])
    tio.save_inference_model(td, tpt.build(tmnist.mlp),
                             params_from_jax({k: np.asarray(v) for k, v in params.items()},
                                             device=CPU), {}, feed, batch_buckets=[4, 8])
    return ({"jax": jserving.PredictorServer(jio.load_inference_model(jd), workers=1,
                                              queue_size=4),
             "port": tserving.PredictorServer(tio.load_inference_model(td, device=CPU),
                                              workers=1, queue_size=4)}, feed)


def test_server_spans_and_families_equal_jax(fresh, tmp_path):
    servers, feed = _servers(tmp_path)
    bad = {k: v.copy() for k, v in feed.items()}
    bad["image"][0, 0] = np.nan
    spans = {}
    try:
        for pkg, srv in servers.items():
            ok = srv.submit(feed)
            ok.result(timeout=60)
            with pytest.raises(Exception, match="non-finite"):
                srv.submit(bad)
            late = srv.submit(feed, deadline=0.0)
            with pytest.raises(Exception):
                late.result(timeout=60)
            spans[pkg] = (ok.span, late.span)
            fams = {f.name for f in (jtel if pkg == "jax" else ttel).get_registry().collect()
                    if f.name.startswith("paddle_tpu_serving_")
                    and any(lab.get("inst") == srv.telemetry_inst for lab, _ in f.samples)}
            spans[pkg] += (fams,)
    finally:
        for srv in servers.values():
            srv.close(drain=True)
    # per request: its span's events (a worker emits serving.complete after
    # the caller may already have submitted the next request)
    lives = {}
    for pkg, j in fresh.items():
        ok_span, late_span, _ = spans[pkg]
        rejects = j.recent(kind="serving.reject")
        assert len(rejects) == 1 and rejects[0]["span"] not in (ok_span, late_span)
        lives[pkg] = [[(e["kind"], sorted(e)) for e in j.recent(span=sp)]
                      for sp in (ok_span, rejects[0]["span"], late_span)]
    assert lives["port"] == lives["jax"]
    assert [[k for k, _ in life] for life in lives["port"]] == [
        ["serving.submit", "serving.dispatch", "serving.complete"], ["serving.reject"],
        ["serving.submit", "serving.expired"]]
    assert len(fresh["port"].recent()) == 6
    port_fams = spans["port"][2]
    assert port_fams == spans["jax"][2]
    assert "paddle_tpu_serving_latency_seconds" in port_fams
    # a closed server stops exporting its series
    assert not any(lab.get("inst") == servers["port"].telemetry_inst
                   for f in ttel.get_registry().collect() for lab, _ in f.samples)
