"""The port's ``metrics`` and ``evaluator`` against the JAX package's on the
CPU: every accumulator over the same update sequence (the port's updates
given torch tensors, the JAX package's numpy arrays, made from one seed),
the in-graph ``auc_stat``, ``auc`` layer (ROC and PR, its histograms
carried across steps in the program's state) and ``chunk_eval_counts``
(every tagging scheme), ``DetectionMAP`` in both modes, and the
``Evaluator`` over a reader.

Tolerances: the accumulators' results exactly (host numpy and Python in
both; the AUC integral within 1e-12); the in-graph AUC within 1e-6 (f32
sums in another order); the counts exactly."""

import functools

import numpy as np
import pytest

import jax
import torch

import paddle_tpu as jpt
from paddle_tpu import evaluator as jev
from paddle_tpu import metrics as jm

import paddle_tpu_torch as tpt
from paddle_tpu_torch import evaluator as tev
from paddle_tpu_torch import metrics as tm
from paddle_tpu_torch.models import mnist as tmnist

CPU = tpt.CPUPlace()


def _t(x):
    return torch.from_numpy(np.array(x))


def _updates(name, rng):
    """Three update argument lists for metric ``name``."""
    out = []
    for _ in range(3):
        if name == "Accuracy":
            out.append((float(rng.rand()), float(rng.randint(1, 5))))
        elif name in ("Precision", "Recall"):
            out.append((rng.rand(16).astype(np.float32), rng.randint(0, 2, 16)))
        elif name == "Auc":
            p = rng.rand(40).astype(np.float32)
            out.append((np.stack([1 - p, p], 1), rng.randint(0, 2, 40)))
        elif name == "EditDistance":
            out.append((rng.randint(0, 4, (5, 6)), rng.randint(0, 4, (5, 4))))
        else:  # ChunkEvaluator
            out.append(tuple(int(v) for v in rng.randint(0, 9, 3)))
    return out


@pytest.mark.parametrize("name", ["Accuracy", "Precision", "Recall", "Auc", "EditDistance",
                                  "ChunkEvaluator"])
def test_accumulators_equal_jax_over_the_same_updates(name):
    updates = _updates(name, np.random.RandomState(0))
    jmetric, tmetric = getattr(jm, name)(), getattr(tm, name)()
    for args in updates:
        jmetric.update(*args)
        tmetric.update(*(_t(a) if isinstance(a, np.ndarray) else a for a in args))
    want, got = jmetric.eval(), tmetric.eval()
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=1e-12, atol=1e-12)
    tmetric.reset()
    jmetric.reset()
    if name in ("Accuracy", "EditDistance"):
        with pytest.raises(ValueError):
            tmetric.eval()
    else:
        assert tmetric.eval() == jmetric.eval()


def test_composite_metric_auc_stats_and_chunk_eval_equal_jax():
    rng = np.random.RandomState(1)
    comp = {pkg: m.CompositeMetric() for pkg, m in (("jax", jm), ("port", tm))}
    for pkg, m in (("jax", jm), ("port", tm)):
        comp[pkg].add_metric(m.Precision())
        comp[pkg].add_metric(m.Recall())
    for _ in range(2):
        preds, labels = rng.randint(0, 2, 12), rng.randint(0, 2, 12)
        comp["jax"].update(preds=preds, labels=labels)
        comp["port"].update(preds=_t(preds), labels=_t(labels))
    assert comp["port"].eval() == comp["jax"].eval()
    p, lab = rng.rand(64).astype(np.float32), rng.randint(0, 2, 64)
    jtp, jfp = jm.auc_stat(p, lab, num_thresholds=50)
    ttp, tfp = tm.auc_stat(_t(p), _t(lab), num_thresholds=50)
    np.testing.assert_array_equal(ttp.numpy(), np.asarray(jtp))
    np.testing.assert_array_equal(tfp.numpy(), np.asarray(jfp))
    ja, ta = jm.Auc(num_thresholds=50), tm.Auc(num_thresholds=50)
    ja.update_stats(jtp, jfp)
    ta.update_stats(ttp, tfp)
    assert ta.eval() == ja.eval()
    chunks = ([[(0, 2, "PER")], [(1, 1, "LOC")]], [[(0, 2, "PER"), (3, 5, "LOC")], []])
    assert tm.chunk_eval(*chunks) == jm.chunk_eval(*chunks)
    assert tm.DetectionMAP is tev.DetectionMAP
    with pytest.raises(AttributeError):
        tm.NoSuchMetric  # noqa: B018


def _auc_fn(m, p, lab, curve):
    val, batch_val = m.auc(p, lab, curve=curve, num_thresholds=64)
    return {"v": val, "b": batch_val}


@pytest.mark.parametrize("curve", ["ROC", "PR"])
def test_auc_layer_streams_across_steps_as_jax(curve):
    rng = np.random.RandomState(2)
    batches = []
    for _ in range(3):
        p = rng.rand(32).astype(np.float32)
        batches.append((np.stack([1 - p, p], 1), (rng.rand(32) < 0.3 + 0.4 * p).astype(np.int64)))
    jprog = jpt.build(functools.partial(_auc_fn, jm, curve=curve))
    tprog = tpt.build(functools.partial(_auc_fn, tm, curve=curve))
    _, jstate = jprog.init(jax.random.PRNGKey(0), *batches[0])
    _, tstate = tprog.init(0, *batches[0], place=CPU)
    assert sorted(tstate) == sorted(jstate)
    for p, lab in batches:
        jout, jstate = jprog.apply({}, jstate, p, lab)
        tout, tstate = tprog.apply({}, tstate, p, lab, place=CPU)
        for k in ("v", "b"):
            np.testing.assert_allclose(float(tout[k]), float(jout[k]), rtol=1e-6, atol=1e-6)
    for k in jstate:
        np.testing.assert_array_equal(tstate[k].numpy(), np.asarray(jstate[k]))


@pytest.mark.parametrize("scheme, types", [("IOB", 3), ("IOE", 2), ("IOBES", 2), ("plain", 4)])
def test_chunk_eval_counts_equal_jax(scheme, types):
    rng = np.random.RandomState(3)
    tag_num = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[scheme]
    b, t = 6, 14
    label = rng.randint(0, types * tag_num + 1, (b, t))
    inference = np.where(rng.rand(b, t) < 0.7, label, rng.randint(0, types * tag_num + 1, (b, t)))
    lengths = np.array([14, 9, 1, 0, 12, 7])
    want = jm.chunk_eval_counts(inference, label, lengths, types, scheme)
    got = tm.chunk_eval_counts(_t(inference), _t(label), _t(lengths), types, scheme)
    assert [int(g) for g in got] == [int(w) for w in want]
    assert int(got[2]) > 0


@pytest.mark.parametrize("ap_version", ["integral", "11point"])
def test_detection_map_equal_jax(ap_version):
    rng = np.random.RandomState(4)
    jmap = jev.DetectionMAP(overlap_threshold=0.5, ap_version=ap_version)
    tmap = tev.DetectionMAP(overlap_threshold=0.5, ap_version=ap_version)
    for _ in range(2):                                   # two updates of three images
        dets, gts = [], []
        for _ in range(3):
            xy = rng.rand(4, 2) * 0.6
            g = np.concatenate([xy, xy + 0.1 + rng.rand(4, 2) * 0.3], 1)
            labs = rng.randint(1, 4, 4)
            d = np.concatenate([g[:3] + rng.randn(3, 4) * 0.03, g[3:] + 0.3])
            dets.append(np.concatenate([labs[:, None], rng.rand(4, 1), d], 1).astype(np.float32))
            gts.append(np.concatenate([labs[:, None], g], 1).astype(np.float32))
        jmap.update([d.tolist() for d in dets], [g.tolist() for g in gts])
        tmap.update([_t(d) for d in dets], [_t(g) for g in gts])
    want = jmap.eval()
    assert 0.0 < want < 1.0
    assert tmap.eval() == want


class _Outputs:
    """A trainer whose ``eval`` returns fixed functions of the feed."""

    def eval(self, feed):
        x = np.asarray(feed["x"], np.float64)
        return {"acc": np.float32(x.mean() > 0.5), "loss": np.float32(x.sum())}


def test_evaluator_equal_jax_and_over_a_port_trainer():
    rng = np.random.RandomState(5)
    batches = [[(rng.rand(3).astype(np.float32), np.int64(i % 2)) for i in range(4)]
               for _ in range(5)]
    reader = lambda: iter(batches)  # noqa: E731
    kw = dict(feed_names=["x", "label"], metric_keys=("acc", "loss"))
    want = jev.Evaluator(_Outputs(), **kw).evaluate(reader)
    assert tev.Evaluator(_Outputs(), **kw).evaluate(reader) == want
    # over a port Trainer: the mean of its eval's accuracy over the reader
    mrng = np.random.RandomState(6)
    mnist = [[(mrng.rand(784).astype(np.float32), np.array([mrng.randint(10)], np.int64))
              for _ in range(8)] for _ in range(3)]
    tr = tpt.Trainer(tpt.build(tmnist.mlp), tpt.optimizer.SGD(0.1), place=CPU)
    ev = tev.Evaluator(tr, ["image", "label"], metric_keys=("acc", "loss"))
    tr.startup(0, sample_feed=ev.feeder.feed(mnist[0]))
    got = ev.evaluate(lambda: iter(mnist))
    outs = [tr.eval(ev.feeder.feed(b)) for b in mnist]
    assert got["acc"] == pytest.approx(np.mean([float(o["acc"]) for o in outs]), abs=1e-12)
    assert got["loss"] == pytest.approx(np.mean([float(o["loss"]) for o in outs]), rel=1e-12)
