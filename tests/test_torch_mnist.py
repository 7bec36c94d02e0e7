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
    fit will not prefetch for a trainer on the CPU; the check_nan_inf flag
    stops a non-finite step before its update.
(f) The single-device half of tests/test_e2e_mnist.py:84-107 with the JAX
    package's keyword names: ``startup(rng=3, sample_feed=...)`` and
    ``step(feed, rng=100 + i)`` give the positional calls' losses, and
    ``Executor.startup(prog, rng=3, **feed)`` the positional call's
    params; a given step rng replaces the derived one."""

import numpy as np
import pytest

import torch

import paddle_tpu as jpt
from paddle_tpu import data as jdata
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import mnist as jmnist

import paddle_tpu_torch as tpt
from paddle_tpu_torch import data as tdata
from paddle_tpu_torch import layers as tL
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


@pytest.mark.parametrize("arg", ["elastic", "resize"])
def test_fit_elastic_and_resize_are_ported(arg, tmp_path):
    """Once NotYetPorted (ROADMAP item 22): elastic without resume is
    refused as the JAX fit refuses it, and a resize path that no request
    has written lets the epoch run to its end."""
    tt = tpt.Trainer(tpt.build(tmnist.mlp), topt.SGD(0.05), place=CPU)
    tt.startup(0, sample_feed=tdata.DataFeeder(["image", "label"]).feed(
        next(iter(_small_reader(tdata)()))))
    if arg == "elastic":
        with pytest.raises(EnforceError, match=r"fit\(elastic=True\) without resume=True"):
            tpt.fit(tt, _small_reader(tdata), 1, ["image", "label"], prefetch=False,
                    elastic=True)
        assert tt.global_step == 0
    else:
        tpt.fit(tt, _small_reader(tdata), 1, ["image", "label"], prefetch=False,
                resize=str(tmp_path / "resize"))
        assert tt.global_step == 3


@pytest.mark.parametrize("kw", ["strategy", "feed_wire", "augment"])
def test_trainer_arguments_of_later_slices_raise(kw):
    # a strategy raises for its fields of later slices (loss scaling, remat,
    # accumulation and the multi-GPU slice's pipeline are ported)
    value = tpt.DistStrategy(async_mode=True) if kw == "strategy" else object()
    with pytest.raises(NotYetPorted):
        tpt.Trainer(tpt.build(tmnist.mlp), topt.SGD(0.05), place=CPU, **{kw: value})


@pytest.mark.parametrize("kw", ["mesh", "sharding_rules"])
def test_trainer_mesh_arguments_are_typed(kw):
    with pytest.raises(EnforceError, match=kw):
        tpt.Trainer(tpt.build(tmnist.mlp), topt.SGD(0.05), place=CPU, **{kw: object()})


def test_fit_will_not_prefetch_for_a_cpu_trainer():
    tt = tpt.Trainer(tpt.build(tmnist.mlp), topt.SGD(0.05), place=CPU)
    sample = tdata.DataFeeder(["image", "label"]).feed(next(iter(_small_reader(tdata)())))
    tt.startup(sample_feed=sample)
    with pytest.raises(EnforceError, match="side CUDA stream"):
        tpt.fit(tt, _small_reader(tdata), 1, ["image", "label"])
    assert tt.global_step == 0


def test_check_nan_inf_flag_stops_the_step_before_the_update():
    # the flag is read at startup and routes to the guard, as in the JAX
    # package: the non-finite step raises and its update is discarded
    from paddle_tpu_torch.core import config
    feeds = _bench_feeds(8)
    tt = tpt.Trainer(tpt.build(tmnist.mlp), topt.SGD(0.05), place=CPU)
    bad = dict(feeds[0], image=np.full_like(feeds[0]["image"], np.nan))
    config.set_flag("check_nan_inf", True)
    try:
        tt.startup(sample_feed=feeds[0])
        before = {k: v.detach().clone() for k, v in tt.scope.params.items()}
        with pytest.raises(FloatingPointError, match="non-finite"):
            tt.step(bad)
        assert all(torch.equal(before[k], v) for k, v in tt.scope.params.items())
        tt.step(feeds[0])  # a finite step goes through
    finally:
        config.set_flag("check_nan_inf", False)
    assert tt.global_step == 2
    assert not torch.equal(before["fc_0/w"], tt.scope.params["fc_0/w"])


def test_trainer_place_and_device_must_agree():
    with pytest.raises(EnforceError, match="two devices"):
        tpt.Trainer(tpt.build(tmnist.mlp), topt.SGD(0.05), place=CPU, device="cuda")
    tr = tpt.Trainer(tpt.build(tmnist.mlp), topt.SGD(0.05), device="cpu")
    assert tr.place == tr.device == torch.device("cpu")


def test_rng_keywords_give_the_positional_calls_losses():
    sample = next(_feed_iter(batch_size=64))
    runs = {}
    for how in ("keyword", "positional"):
        tr = tpt.Trainer(tpt.build(tmnist.mlp), topt.SGD(0.1), loss_name="loss", place=CPU)
        if how == "keyword":
            tr.startup(rng=3, sample_feed=sample)
        else:
            tr.startup(3, sample)
        losses = []
        for i, feed in enumerate(_feed_iter(batch_size=64)):
            out = (tr.step(feed, rng=100 + i, span=f"s{i}") if how == "keyword"
                   else tr.step(feed, 100 + i))
            losses.append(float(out["loss"]))
            if i >= 4:
                break
        runs[how] = losses
    assert runs["keyword"] == runs["positional"]
    assert runs["keyword"][-1] < runs["keyword"][0]
    prog = tpt.build(tmnist.mlp)
    by_kw = tpt.Executor(CPU).startup(prog, rng=3, **sample).params
    by_pos = tpt.Executor(CPU).startup(prog, 3, **sample).params
    assert sorted(by_kw) == [f"fc_{i}/{p}" for i in range(3) for p in ("b", "w")]
    assert all(torch.equal(by_kw[k], by_pos[k]) for k in by_kw)


def _noisy(x):
    w = tpt.create_parameter([3], name="w", initializer=tpt.initializer.Constant(1.0))
    return {"loss": tL.mean(x * w * tL.uniform_random([3]))}


def test_step_rng_replaces_the_derived_seed():
    """A program that draws from its rng: ``step(feed, rng=k)`` draws what
    ``apply(..., rng=k)`` draws, and without ``rng`` the first step derives
    its seed from (seed + 1, global_step 0) as before."""
    from paddle_tpu_torch.core.config import get_flag
    from paddle_tpu_torch.initializer import mix_seed

    prog = tpt.build(_noisy)
    x = np.ones((2, 3), np.float32)
    derived_seed = mix_seed(get_flag("seed") + 1, 0)
    want = {k: prog.apply({"w": torch.ones(3)}, {}, x, rng=k, place=CPU)[0]["loss"]
            for k in (7, derived_seed)}
    losses = {}
    for rng in (7, None):
        tr = tpt.Trainer(prog, topt.SGD(0.1), place=CPU).startup(0, {"x": x})
        losses[rng] = tr.step({"x": x}, rng=rng)["loss"]
    assert torch.equal(losses[7], want[7])
    assert torch.equal(losses[None], want[derived_seed])
    assert not torch.equal(losses[7], losses[None])
