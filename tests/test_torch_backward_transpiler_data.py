"""The port's ``backward``, ``transpiler``, the datasets of the detection
and ranking slice and the training half of ``testing.faults`` against the
JAX package on the CPU.

- ``append_backward`` (every param, a ``parameter_list``, a
  ``no_grad_set``) and ``calc_gradient`` on a two-layer program, from
  weights drawn with numpy from a seed: the loss within rtol 1e-6 and each
  grad within 1e-5 of its largest entry (f32 matmuls in another order); a
  param the loss does not reach gets zeros in both.
- The transpiler's dispatchers place the same names on the same endpoints,
  and each transpile step returns the JAX package's strategy fields.
- ``cifar10``, ``cifar100``, ``flowers``, ``voc2012`` and ``mq2007`` (each
  format) yield the JAX package's synthetic samples byte for byte.
- The fault helpers: ``nan_batch_reader`` and ``nan_feed`` equal the JAX
  package's; ``crash_at_step``, ``crashing``, ``acting`` and a NaN batch
  drive a port ``fit`` as the JAX package's tests drive its own;
  ``visible_devices`` and ``membership_meshes`` in a gloo world of one."""

import dataclasses
import os
import socket

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as jpt
from paddle_tpu import backward as jbw
from paddle_tpu import layers as jL
from paddle_tpu import transpiler as jtr
from paddle_tpu.data import datasets as jds
from paddle_tpu.testing import faults as jfaults

import paddle_tpu_torch as tpt
from paddle_tpu_torch import backward as tbw
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import layers as tL
from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch import transpiler as ttr
from paddle_tpu_torch.data import datasets as tds
from paddle_tpu_torch.framework import params_from_jax
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.testing import faults as tfaults

CPU = tpt.CPUPlace()


def _net(L, x, label):
    h = L.fc(x, 8, act="tanh", name="h")
    logits = L.fc(h, 3, name="out")
    L.fc(x, 2, name="unused")                            # reaches no output
    return {"loss": L.mean(L.softmax_with_cross_entropy(logits, label)), "logits": logits}


def _programs(feed):
    jprog = jpt.build(lambda x, label: _net(jL, x, label))
    tprog = tpt.build(lambda x, label: _net(tL, x, label))
    tprog.init(0, place=CPU, **feed)
    rng = np.random.RandomState(1)
    params = {k: (0.5 * rng.randn(*i.shape)).astype(np.float32)
              for k, i in sorted(tprog.param_info.items())}
    return jprog, tprog, params


def _feed():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(5, 4).astype(np.float32),
            "label": rng.randint(0, 3, (5, 1)).astype(np.int64)}


def _close_grads(got, want):
    for name, w in want:
        g = dict(got)[name]
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * scale, name


@pytest.mark.parametrize("restrict", ["all", "parameter_list", "no_grad_set"])
def test_append_backward_equal_jax(restrict):
    feed = _feed()
    jprog, tprog, params = _programs(feed)
    kw = {"all": {}, "parameter_list": dict(parameter_list=["out/w", "h/b", "unused/w"]),
          "no_grad_set": dict(no_grad_set={"h/w", "out/b"})}[restrict]
    jloss, jgrads = jbw.append_backward(jprog, "loss", **kw)(
        {k: jnp.asarray(v) for k, v in params.items()}, {}, **feed)
    tparams = params_from_jax(params, device="cpu")
    tloss, tgrads = tbw.append_backward(tprog, "loss", **kw)(tparams, {}, place=CPU, **feed)
    assert [n for n, _ in tgrads] == [n for n, _ in jgrads]
    assert not any(p.requires_grad for p in tparams.values())   # the caller's params untouched
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    _close_grads(tgrads, jgrads)
    for name, g in tgrads:
        if name.startswith("unused"):
            assert not g.any()


def test_calc_gradient_equal_jax():
    feed = _feed()
    jprog, tprog, params = _programs(feed)
    want = jbw.calc_gradient(jprog, "logits", ["x"])(
        {k: jnp.asarray(v) for k, v in params.items()}, {}, feed)
    got = tbw.calc_gradient(tprog, "logits", ["x"])(params_from_jax(params, device="cpu"), {},
                                                   feed)
    assert list(got) == ["x"]
    _close_grads(got.items(), want.items())


def test_transpiler_equal_jax():
    names = [f"fc_{i}/w" for i in range(7)]
    eps = ["a:1", "b:2", "c:3"]
    for cls in ("RoundRobin", "HashName"):
        j, t = getattr(jtr, cls)(eps), getattr(ttr, cls)(eps)
        assert t.dispatch(names) == j.dispatch(names)
        assert t.dispatch(names[:2]) == j.dispatch(names[:2])
    fields = [f.name for f in dataclasses.fields(tpt.DistStrategy)]
    for slice_var_up in (True, False):
        for sync in (True, False):
            jt = jtr.DistributeTranspiler(jtr.DistributeTranspilerConfig(slice_var_up=slice_var_up))
            tt = ttr.DistributeTranspiler(ttr.DistributeTranspilerConfig(slice_var_up=slice_var_up))
            prog = object()
            jt.transpile(1, program=prog, pservers="a:1,b:2", trainers=2, sync_mode=sync)
            tt.transpile(1, program=prog, pservers="a:1,b:2", trainers=2, sync_mode=sync)
            assert tt.pserver_endpoints == jt.pserver_endpoints == ["a:1", "b:2"]
            for getter in ("get_trainer_program", "get_pserver_program", "get_startup_program"):
                (jp, js), (tp, ts) = getattr(jt, getter)(), getattr(tt, getter)()
                assert tp is jp is prog
                assert {f: getattr(ts, f) for f in fields} == {f: getattr(js, f) for f in fields}
    assert ttr.memory_optimize().remat is jtr.memory_optimize().remat is True
    assert ttr.release_memory("p") == jtr.release_memory("p") == "p"
    assert tpt.append_backward is tbw.append_backward and tpt.RoundRobin is ttr.RoundRobin


@pytest.mark.parametrize("name, kw", [
    ("cifar10", dict(synthetic_size=6)), ("cifar100", dict(split="test", synthetic_size=6)),
    ("flowers", dict(synthetic_size=4, image_hw=(16, 12))),
    ("voc2012", dict(synthetic_size=4, image_hw=(24, 18))),
    ("mq2007", dict(format="pairwise", n_queries=3)),
    ("mq2007", dict(split="test", format="pointwise", n_queries=3)),
    ("mq2007", dict(format="listwise", n_queries=3))])
def test_synthetic_datasets_byte_equal_jax(name, kw):
    jr, tr = getattr(jds, name)(**kw), getattr(tds, name)(**kw)
    assert tr.synthetic is jr.synthetic is True
    want, got = list(jr()), list(tr())
    assert len(got) == len(want) > 0
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()


# -- the training half of testing.faults ------------------------------------------------


def _reader(n=6, batch=4):
    rng = np.random.RandomState(2)
    batches = [[(rng.rand(784).astype(np.float32), np.array([rng.randint(10)], np.int64))
                for _ in range(batch)] for _ in range(n)]
    return lambda: iter(batches)


def test_nan_reader_and_feed_equal_jax():
    for column in (0, 1):
        want = list(jfaults.nan_batch_reader(_reader(3), at_batch=1, column=column)())
        got = list(tfaults.nan_batch_reader(_reader(3), at_batch=1, column=column)())
        for gb, wb in zip(got, want):
            for gs, ws in zip(gb, wb):
                for g, w in zip(gs, ws):
                    assert np.asarray(g).dtype == np.asarray(w).dtype
                    np.testing.assert_array_equal(g, w)
    feed = {"x": np.ones((2, 3), np.int32), "y": np.zeros(2)}
    want, got = jfaults.nan_feed(feed, "x", np.inf), tfaults.nan_feed(feed, "x", np.inf)
    assert got.keys() == want.keys() and got["x"].dtype == want["x"].dtype
    np.testing.assert_array_equal(got["x"], want["x"])
    assert got["y"] is feed["y"]


def _feeds():
    from paddle_tpu_torch.data.feeder import DataFeeder
    feeder = DataFeeder(["image", "label"])
    return (feeder.feed(b) for b in _reader()())


def _trainer(guard=None):
    tr = tpt.Trainer(tpt.build(tmnist.mlp), tpt.optimizer.SGD(0.05), place=CPU, guard=guard)
    return tr.startup(0, sample_feed={"image": np.zeros((4, 784), np.float32),
                                      "label": np.zeros((4, 1), np.int64)})


def _fit(tr, root, reader=None, **kw):
    return tpt.fit(tr, reader or _reader(), 1, ["image", "label"], prefetch=False,
                   checkpoint_config=tpt.CheckpointConfig(root, step_interval=2), **kw)


def test_faults_drive_a_port_fit(tmp_path):
    # crash_at_step: fit dies after step 3; the step-2 checkpoint is committed
    root = str(tmp_path / "crash")
    with pytest.raises(tfaults.InjectedCrash, match="step 3"):
        _fit(_trainer(), root, event_handler=tfaults.crash_at_step(3))
    assert [c.global_step for c in tres.list_checkpoints(root)] == [2]
    # crashing: a save killed after its files, before its manifest, leaves nothing
    tr = _trainer()
    tr.step(tfaults.nan_feed({"image": np.zeros((4, 784), np.float32),
                              "label": np.zeros((4, 1), np.int64)}, "image", 0.5))
    with tfaults.crashing("save_trainer:files-written"):
        with pytest.raises(tfaults.InjectedCrash):
            tio.save_trainer(str(tmp_path / "torn" / "step_1"), tr)
    assert not tfaults.resilience.crash_points
    assert tres.list_checkpoints(str(tmp_path / "torn")) == []
    # acting: the callback runs once at the crash point and the save commits
    calls = []
    with tfaults.acting("save_trainer:manifest-written", lambda: calls.append(1)) as fired:
        tio.save_trainer(str(tmp_path / "acted" / "step_1"), tr)
        tio.save_trainer(str(tmp_path / "acted" / "step_2"), tr)
    assert calls == [1] and fired == [1] and not tfaults.resilience.crash_callbacks
    assert [c.tag for c in tres.list_checkpoints(str(tmp_path / "acted"))] == ["step_1",
                                                                               "step_2"]
    # a NaN batch under the guard: one incident at its step, no step lost
    tr = _trainer(guard=tres.GuardPolicy(max_incidents=5, defer_readback=False))
    _fit(tr, str(tmp_path / "nan"), reader=tfaults.nan_batch_reader(_reader(), at_batch=2))
    assert tr.global_step == 6 and [i.step for i in tr.guard_incidents] == [2]
    assert np.isfinite(float(tr.eval(next(iter(_feeds())))["loss"]))


def test_visible_devices_and_membership_meshes_in_a_world_of_one():
    import torch.distributed as dist
    from paddle_tpu_torch import parallel as tpar

    if torch.cuda.is_available():
        pytest.skip("this host has a card: the CPU world is what is held here")
    assert tfaults.visible_devices(1) == [torch.device("cpu")]
    with pytest.raises(ValueError, match="visible_devices"):
        tfaults.visible_devices(2)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tpar.initialize(place=CPU, init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        a, b = tfaults.membership_meshes([1]), tfaults.membership_meshes([1])
        assert [m.shape for m in a] == [m.shape for m in b] == [{"dp": 1}]
        assert a[0].devices.tolist() == b[0].devices.tolist() == [0]
        with pytest.raises(ValueError, match="visible_devices"):
            tfaults.membership_meshes([1, 2])
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized() and os.environ.get("RANK") is None
