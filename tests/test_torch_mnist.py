"""MNIST MLP, the slice's main path, on the CPU: ``build(mnist.mlp)`` →
``Trainer`` → ``step``/``eval``, ``Executor.run`` and ``fit``.

(a) From the JAX package's init carried across, on bench.py
    ``bench_mnist_mlp``'s four random feeds (batch 128), 20 steps of
    SGD(0.01) and of Adam(1e-3) give the JAX package's f32 losses
    (relative 1e-5 per step) and final params (max abs 1e-5). Adam's first
    step moves each weight by about lr·g/(|g| + eps), so a weight whose
    grad is within a few eps of 0 moves by an amount that f32 rounding of
    g sets: those few weights carry the whole difference (below 1e-5 at
    every torch thread count from 1 to 8 on an 8-core x86 CPU, 9.8e-6 at
    8; the test pins 4 threads, 6.3e-6).
(b) The port alone trains synthetic MNIST as tests/test_e2e_mnist.py:27
    does up to its line 48: 3 epochs with Adam, the last loss below half
    the first, test accuracy above 0.9.
(c) ``Executor.run`` fetches the loss and accuracy (test_e2e_mnist:74).
(d) ``fit`` gives the JAX package's event sequence, global steps and
    losses (relative 1e-5) over 2 epochs of a small reader.
(e) Every fit/Trainer argument of a later slice raises NotYetPorted, and
    fit will not prefetch for a trainer on the CPU."""

import numpy as np
import pytest

import torch

import paddle_tpu as jpt
from paddle_tpu import data as jdata
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import mnist as jmnist

import paddle_tpu_torch as tpt
from paddle_tpu_torch import data as tdata
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core.errors import EnforceError, NotYetPorted
from paddle_tpu_torch.framework import params_from_jax
from paddle_tpu_torch.models import mnist as tmnist

CPU = tpt.CPUPlace()
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5


def _bench_feeds(batch_size=128):
    """bench.py bench_mnist_mlp's feeds (bench.py:1763-1766)."""
    rng = np.random.RandomState(0)
    return [{"image": rng.randn(batch_size, 784).astype(np.float32),
             "label": rng.randint(0, 10, (batch_size, 1)).astype(np.int64)}
            for _ in range(4)]


@pytest.fixture
def four_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_steps_match_jax_from_carried_params(opt, four_threads):
    make = {"sgd": lambda m: m.SGD(0.01), "adam": lambda m: m.Adam(1e-3)}[opt]
    feeds = _bench_feeds()
    jt = jpt.Trainer(jpt.build(jmnist.mlp), make(jopt), loss_name="loss")
    jt.startup(sample_feed=feeds[0])
    p0 = {k: np.asarray(v) for k, v in jt.scope.params.items()}
    prog = tpt.build(tmnist.mlp)
    tr = tpt.Trainer(prog, make(topt), loss_name="loss", place=CPU)
    tr.startup(sample_feed=feeds[0], params=params_from_jax(p0, device="cpu"))
    assert sorted(tr.scope.params) == sorted(p0)
    jl, tl = [], []
    for i in range(20):
        jl.append(float(jt.step(feeds[i % 4])["loss"]))
        tl.append(float(tr.step(feeds[i % 4])["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=0)
    assert tl[-1] < tl[0]
    for k, v in jt.scope.params.items():
        np.testing.assert_allclose(tr.scope.params[k].detach().numpy(), np.asarray(v),
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)
    assert tr.global_step == jt.global_step == 20
    assert int(tr.scope.opt_state["step"]) == 20


def _feed_iter(batch_size=64, epochs=1):
    reader = tdata.batch(tdata.shuffle(tdata.datasets.mnist("train"), 512, seed=0),
                         batch_size)
    feeder = tdata.DataFeeder(["image", "label"], dtypes=["float32", "int64"])
    for _ in range(epochs):
        for samples in reader():
            feed = feeder.feed(samples)
            feed["label"] = feed["label"][:, None]
            yield feed


def test_mnist_mlp_trains_to_high_accuracy():
    prog = tpt.build(tmnist.mlp)
    trainer = tpt.Trainer(prog, topt.Adam(1e-3), loss_name="loss", place=CPU)
    trainer.startup(sample_feed=next(_feed_iter()))
    losses = [float(trainer.step(feed)["loss"]) for feed in _feed_iter(epochs=3)]
    assert losses[-1] < losses[0] * 0.5, f"loss did not drop: {losses[0]} -> {losses[-1]}"
    reader = tdata.batch(tdata.datasets.mnist("test"), 256)
    feeder = tdata.DataFeeder(["image", "label"], dtypes=["float32", "int64"])
    accs = []
    for samples in reader():
        feed = feeder.feed(samples)
        feed["label"] = feed["label"][:, None]
        out = trainer.eval(feed)
        assert out["logits"].shape == (256, 10)
        accs.append(float(out["acc"]))
    assert np.mean(accs) > 0.9, f"test acc too low: {np.mean(accs)}"


def test_executor_forward_fetch():
    prog = tpt.build(tmnist.mlp)
    exe = tpt.Executor(CPU)
    sample = next(_feed_iter(batch_size=8))
    exe.startup(prog, None, **sample)
    loss, acc = exe.run(prog, feed=sample, fetch_list=["loss", "acc"])
    assert np.isfinite(loss) and isinstance(loss, np.ndarray)
    assert 0.0 <= float(acc) <= 1.0
    whole = exe.run(prog, feed=sample)
    assert sorted(whole) == ["acc", "logits", "loss"] and whole["logits"].shape == (8, 10)
    assert float(whole["loss"]) == float(loss)


def _small_reader(D):
    base = D.firstn(D.datasets.mnist("train", synthetic_size=96), 96)
    return D.batch(D.map_readers(lambda s: (s[0], np.int64(s[1]).reshape(1)), base), 32)


def test_fit_gives_the_jax_events_steps_and_losses():
    jt = jpt.Trainer(jpt.build(jmnist.mlp), jopt.SGD(0.05), loss_name="loss")
    sample = jdata.DataFeeder(["image", "label"]).feed(next(iter(_small_reader(jdata)())))
    jt.startup(sample_feed=sample)
    tt = tpt.Trainer(tpt.build(tmnist.mlp), topt.SGD(0.05), loss_name="loss", place=CPU)
    tt.startup(sample_feed=sample,
               params=params_from_jax({k: np.asarray(v) for k, v in jt.scope.params.items()},
                                      device="cpu"))
    events = {"jax": [], "port": []}

    def record(log):
        return lambda e: log.append((e.kind, e.epoch, e.step, e.num_steps,
                                     float(e.metrics["loss"]) if e.kind == "end_step" else None))

    jpt.fit(jt, _small_reader(jdata), 2, ["image", "label"], event_handler=record(events["jax"]))
    tpt.fit(tt, _small_reader(tdata), 2, ["image", "label"], prefetch=False,
            event_handler=record(events["port"]))
    assert [e[:4] for e in events["port"]] == [e[:4] for e in events["jax"]]
    assert len(events["port"]) == 2 * (2 + 2 * 3)
    assert tt.global_step == jt.global_step == 6
    jl = [e[4] for e in events["jax"] if e[4] is not None]
    tl = [e[4] for e in events["port"] if e[4] is not None]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=0)


FIT_LATER = {
    "checkpoint_config": lambda tmp: object(),
    "resume": lambda tmp: True,
    "elastic": lambda tmp: True,
    "resize": lambda tmp: str(tmp / "resize"),
    "preemption": lambda tmp: True,
    "steps_per_dispatch": lambda tmp: 2,
    "feed_wire": lambda tmp: {"image": object()},
    "device_cache": lambda tmp: True,
    "augment": lambda tmp: {"image": object()},
    "profile_interval_steps": lambda tmp: 5,
}


@pytest.mark.parametrize("arg", sorted(FIT_LATER))
def test_fit_arguments_of_later_slices_raise(arg, tmp_path):
    tt = tpt.Trainer(tpt.build(tmnist.mlp), topt.SGD(0.05), place=CPU)
    with pytest.raises(NotYetPorted, match=arg):
        tpt.fit(tt, _small_reader(tdata), 1, ["image", "label"], prefetch=False,
                **{arg: FIT_LATER[arg](tmp_path)})
    assert tt.global_step == 0


@pytest.mark.parametrize("kw", ["mesh", "sharding_rules", "strategy", "guard", "feed_wire",
                                "augment"])
def test_trainer_arguments_of_later_slices_raise(kw):
    with pytest.raises(NotYetPorted):
        tpt.Trainer(tpt.build(tmnist.mlp), topt.SGD(0.05), place=CPU, **{kw: object()})


def test_fit_will_not_prefetch_for_a_cpu_trainer():
    tt = tpt.Trainer(tpt.build(tmnist.mlp), topt.SGD(0.05), place=CPU)
    sample = tdata.DataFeeder(["image", "label"]).feed(next(iter(_small_reader(tdata)())))
    tt.startup(sample_feed=sample)
    with pytest.raises(EnforceError, match="side CUDA stream"):
        tpt.fit(tt, _small_reader(tdata), 1, ["image", "label"])
    assert tt.global_step == 0


def test_check_nan_inf_flag_stops_the_step_before_the_update():
    from paddle_tpu_torch.core import config
    feeds = _bench_feeds(8)
    tt = tpt.Trainer(tpt.build(tmnist.mlp), topt.SGD(0.05), place=CPU)
    tt.startup(sample_feed=feeds[0])
    before = {k: v.detach().clone() for k, v in tt.scope.params.items()}
    bad = dict(feeds[0], image=np.full_like(feeds[0]["image"], np.nan))
    config.set_flag("check_nan_inf", True)
    try:
        with pytest.raises(FloatingPointError, match="NaN/Inf"):
            tt.step(bad)
        tt.step(feeds[0])  # a finite step goes through
    finally:
        config.set_flag("check_nan_inf", False)
    assert tt.global_step == 1
    assert not torch.equal(before["fc_0/w"], tt.scope.params["fc_0/w"])


def test_trainer_place_and_device_must_agree():
    with pytest.raises(EnforceError, match="two devices"):
        tpt.Trainer(tpt.build(tmnist.mlp), topt.SGD(0.05), place=CPU, device="cuda")
    tr = tpt.Trainer(tpt.build(tmnist.mlp), topt.SGD(0.05), device="cpu")
    assert tr.place == tr.device == torch.device("cpu")
