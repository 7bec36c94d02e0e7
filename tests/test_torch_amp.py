"""Loss scaling, ``DistStrategy`` and the NaN/Inf guard of the port, on
the CPU, against ``paddle_tpu``.

- The port's ``LossScaler`` against ``paddle_tpu.amp.LossScaler`` over the
  same sequence of finite and non-finite steps, state for state (exact:
  the same f32 products by powers of two).
- The analogs of tests/test_amp.py: scaler dynamics and static mode, an
  overflow skips the step and halves the scale, a static scale trains as
  no scale (params within 1e-6), and the scale survives a checkpoint.
- A scaler-running trainer's checkpoint moves between the packages with
  its ``loss_scale_state``.
- The analogs of the guard tests of tests/test_resilience.py (:166,
  :257-366 and :473, without the fused-step and mesh cases): the mask
  folds past 32 checked values, a NaN batch is discarded with the params
  bit-equal and one incident recorded, fit runs through a NaN batch,
  escalation after ``max_incidents``, the ``check_nan_inf`` flag routes
  to an immediate guard, ``guard=False`` overrides it, with a loss scaler
  the guard leaves grad overflows to the scaler, and a pending escalation
  at preemption still saves the boundary checkpoint.
"""

import os
import signal

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as jpt
from paddle_tpu import io as jio
from paddle_tpu import optimizer as jopt
from paddle_tpu.amp import LossScaler as JScaler
from paddle_tpu.parallel import DistStrategy as JStrategy

import paddle_tpu_torch as tpt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import layers as tL
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch.amp import LossScaler
from paddle_tpu_torch.core import config
from paddle_tpu_torch.core.errors import EnforceError, NotYetPorted
from paddle_tpu_torch.parallel import DistStrategy
from paddle_tpu_torch.parallel.strategy import unported_fields

CPU = tpt.CPUPlace()
DIM, CLASSES, BS, N_BATCHES = 6, 4, 4, 8


def _net(x, label):
    h = tL.fc(x, 16, name="fc1")
    logits = tL.fc(h, CLASSES, name="fc2")
    return {"loss": tL.mean(tL.softmax_with_cross_entropy(logits, label))}


_PROG = tpt.build(_net)
_FEED = {"x": np.zeros((BS, DIM), np.float32), "label": np.zeros((BS, 1), np.int64)}


def _nan_feed(feed, name="x", value=float("nan")):
    return dict(feed, **{name: np.full_like(feed[name], value)})


def _trainer(strategy=None, guard=None, prog=_PROG, feed=_FEED, opt=None):
    tr = tpt.Trainer(prog, opt or topt.SGD(0.1), loss_name="loss", strategy=strategy,
                     guard=guard, place=CPU)
    return tr.startup(0, sample_feed=feed)


def _reader(n_batches=N_BATCHES, seed=7):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n_batches):
            x = rng.randn(BS, DIM).astype(np.float32)
            y = rng.randint(0, CLASSES, (BS,)).astype(np.int64)
            yield [(x[j], y[j:j + 1]) for j in range(BS)]
    return reader


def _snapshot(tr):
    return {k: v.detach().clone() for k, v in tr.scope.params.items()}


def _equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


AMP = dict(loss_scale=2.0 ** 10, dynamic_loss_scale=True)


# -- the scaler against paddle_tpu's ----------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(init_scale=1024.0, dynamic=True, growth_interval=3),
    dict(init_scale=4.0, dynamic=True, growth_interval=2, factor=4.0, min_scale=2.0,
         max_scale=64.0),
    dict(init_scale=128.0, dynamic=False),
], ids=["dynamic", "clipped", "static"])
def test_scaler_matches_paddle_tpu_state_for_state(kw):
    finite_seq = [False, True, True, True, True, False, False, False, True, True, True,
                  True, True, True, True]
    js, ts = JScaler(**kw), LossScaler(**kw)
    jl, tls = js.init_state(), ts.init_state()
    for i, f in enumerate(finite_seq):
        jl = js.update(jl, jnp.bool_(f))
        tls = ts.update(tls, torch.tensor(f))
        for k in jl:
            assert float(tls[k]) == float(jl[k]), (i, k)
        assert tls["scale"].dtype == torch.float32 and tls["good_steps"].dtype == torch.int32
    g = {"a": np.full((3,), 6.0, np.float32), "b": np.ones((2, 2), np.float32)}
    jg = js.unscale({k: jnp.asarray(v) for k, v in g.items()}, jl)
    tg = ts.unscale({k: torch.from_numpy(v) for k, v in g.items()}, tls)
    for k in g:
        np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
    loss = jnp.float32(0.75)
    assert float(ts.scale_loss(torch.tensor(0.75), tls)) == float(js.scale_loss(loss, jl))


@pytest.mark.parametrize("bad", [None, float("nan"), float("inf"), float("-inf")])
def test_all_finite_and_select(bad):
    grads = [torch.ones(5), torch.zeros(3, 4, dtype=torch.bfloat16), torch.arange(7.0)]
    if bad is not None:
        grads[1][2, 1] = bad
    got = LossScaler.all_finite(grads)
    assert got.dtype == torch.bool and bool(got) == (bad is None)
    want = JScaler.all_finite([jnp.asarray(g.float().numpy()) for g in grads])
    assert bool(want) == bool(got)
    new, old = {"p": torch.ones(2), "s": {"q": torch.zeros(1)}}, {"p": torch.zeros(2),
                                                                 "s": {"q": torch.ones(1)}}
    picked = LossScaler.select(got, new, old)
    assert torch.equal(picked["p"], (new if bad is None else old)["p"])
    assert torch.equal(picked["s"]["q"], (new if bad is None else old)["s"]["q"])


def test_scaler_dynamics():
    sc = LossScaler(init_scale=1024.0, dynamic=True, growth_interval=3, factor=2.0)
    ls = sc.init_state()
    ls = sc.update(ls, torch.tensor(False))  # overflow → halve
    assert float(ls["scale"]) == 512.0 and int(ls["good_steps"]) == 0
    assert int(ls["overflows"]) == 1
    for _ in range(2):
        ls = sc.update(ls, torch.tensor(True))
    assert float(ls["scale"]) == 512.0  # not yet at the interval
    ls = sc.update(ls, torch.tensor(True))  # 3rd good step → grow
    assert float(ls["scale"]) == 1024.0 and int(ls["good_steps"]) == 0


def test_scaler_static_mode():
    sc = LossScaler(init_scale=128.0, dynamic=False)
    ls = sc.update(sc.init_state(), torch.tensor(False))
    assert float(ls["scale"]) == 128.0 and int(ls["overflows"]) == 1


# -- loss scaling in Trainer.step --------------------------------------------------


def _mlp(x, label):
    h = tL.fc(x, 32, act="relu", name="h")
    logits = tL.fc(h, 4, name="out")
    return {"loss": tL.mean(tL.softmax_with_cross_entropy(logits, label))}


_MLP = tpt.build(_mlp)


def _mlp_trainer(strategy=None, seed=0):
    rng = np.random.RandomState(seed)
    feed = {"x": rng.randn(16, 8).astype(np.float32),
            "label": rng.randint(0, 4, (16, 1)).astype(np.int64)}
    return _trainer(strategy, prog=_MLP, feed=feed), feed


def test_overflow_skips_step_and_shrinks_scale():
    tr, feed = _mlp_trainer(DistStrategy(**AMP))
    p0 = _snapshot(tr)
    opt0 = int(tr.scope.opt_state["step"])
    out = tr.step(_nan_feed(feed))
    assert float(out["loss_scale"]) == 512.0
    assert _equal(_snapshot(tr), p0)
    assert int(tr.scope.opt_state["step"]) == opt0 and tr.global_step == 1
    out = tr.step(feed)  # a clean batch: the params move
    assert float(out["loss_scale"]) == 512.0
    assert not _equal(_snapshot(tr), p0)
    assert int(tr.scope.loss_scale_state["overflows"]) == 1


def test_static_scale_matches_unscaled_training():
    tr_a, feed = _mlp_trainer()
    tr_b, _ = _mlp_trainer(DistStrategy(loss_scale=1024.0))
    for i in range(3):
        tr_a.step(feed, rng=7 + i)
        tr_b.step(feed, rng=7 + i)
    for k in tr_a.scope.params:
        torch.testing.assert_close(tr_a.scope.params[k], tr_b.scope.params[k],
                                   atol=1e-6, rtol=1e-6)


def test_loss_scaling_matches_paddle_tpu_step_for_step():
    """The same MLP from carried params under dynamic scaling (growth every
    2 steps), with a NaN batch at step 2: the scale after every step equals
    paddle_tpu's, the losses within 1e-6 and the params within 1e-6."""
    from paddle_tpu import layers as jL

    def jnet(x, label):
        h = jL.fc(x, 32, act="relu", name="h")
        logits = jL.fc(h, 4, name="out")
        return {"loss": jL.mean(jL.softmax_with_cross_entropy(logits, label))}

    strat = dict(loss_scale=8.0, dynamic_loss_scale=True, loss_scale_growth_interval=2)
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(16, 8).astype(np.float32),
            "label": rng.randint(0, 4, (16, 1)).astype(np.int64)}
    jt = jpt.Trainer(jpt.build(jnet), jopt.Momentum(0.1, 0.9), loss_name="loss",
                     strategy=JStrategy(**strat))
    jt.startup(sample_feed=feed)
    tt = tpt.Trainer(_MLP, topt.Momentum(0.1, 0.9), loss_name="loss", place=CPU,
                     strategy=DistStrategy(**strat))
    tt.startup(0, feed, params=tpt.framework.params_from_jax(
        {k: np.asarray(v) for k, v in jt.scope.params.items()}, device="cpu"))
    for i in range(6):
        f = _nan_feed(feed) if i == 2 else feed
        jo, to = jt.step(f), tt.step(f)
        assert float(to["loss_scale"]) == float(jo["loss_scale"]), i
        if i != 2:
            assert abs(float(to["loss"]) - float(jo["loss"])) <= 1e-6 * abs(float(jo["loss"]))
        for k, v in jt.scope.loss_scale_state.items():
            assert int(tt.scope.loss_scale_state[k]) == int(v) or \
                float(tt.scope.loss_scale_state[k]) == float(v)
    for k, v in jt.scope.params.items():
        np.testing.assert_allclose(tt.scope.params[k].detach().numpy(), np.asarray(v),
                                   atol=1e-6, rtol=1e-6)


def test_loss_scale_checkpoint_roundtrip(tmp_path):
    tr, feed = _mlp_trainer(DistStrategy(dynamic_loss_scale=True, loss_scale=256.0))
    tr.step(_nan_feed(feed, value=float("inf")))
    tio.save_trainer(str(tmp_path / "ck"), tr)
    tr2, _ = _mlp_trainer(DistStrategy(dynamic_loss_scale=True, loss_scale=256.0))
    tio.load_trainer(str(tmp_path / "ck"), tr2)
    assert float(tr2.scope.loss_scale_state["scale"]) == 128.0
    assert int(tr2.scope.loss_scale_state["overflows"]) == 1
    tr2.step(feed)  # still steps after the restore


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_scaler_checkpoint_moves_between_packages(tmp_path, direction):
    """A scaler-running trainer after an overflow and a clean step: each
    package loads the other's checkpoint with its loss_scale_state, and
    the params come back bit for bit."""
    from paddle_tpu import layers as jL

    def jnet(x, label):
        h = jL.fc(x, 32, act="relu", name="h")
        logits = jL.fc(h, 4, name="out")
        return {"loss": jL.mean(jL.softmax_with_cross_entropy(logits, label))}

    strat = dict(loss_scale=64.0, dynamic_loss_scale=True)
    rng = np.random.RandomState(1)
    feed = {"x": rng.randn(16, 8).astype(np.float32),
            "label": rng.randint(0, 4, (16, 1)).astype(np.int64)}
    jt = jpt.Trainer(jpt.build(jnet), jopt.Momentum(0.1, 0.9), loss_name="loss",
                     strategy=JStrategy(**strat))
    jt.startup(sample_feed=feed)
    tt = tpt.Trainer(_MLP, topt.Momentum(0.1, 0.9), loss_name="loss", place=CPU,
                     strategy=DistStrategy(**strat)).startup(0, feed)
    d = str(tmp_path / "ck")
    src, dst = (tt, jt) if direction == "port_to_jax" else (jt, tt)
    src.step(_nan_feed(feed))
    src.step(feed)
    (tio if src is tt else jio).save_trainer(d, src)
    (jio if dst is jt else tio).load_trainer(d, dst)
    want = {"scale": 32.0, "good_steps": 1, "overflows": 1}
    for k, v in want.items():
        assert float(dst.scope.loss_scale_state[k]) == v, k
    assert dst.global_step == 2
    for k, v in src.scope.params.items():
        a = v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        b = dst.scope.params[k]
        b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        np.testing.assert_array_equal(a, b)


def test_loss_scale_state_mismatch_warns_not_crashes(tmp_path):
    plain = _trainer()
    plain.step(_FEED)
    d1 = str(tmp_path / "plain")
    tio.save_trainer(d1, plain)
    scaled = _trainer(strategy=DistStrategy(**AMP))
    with pytest.warns(UserWarning, match="no loss_scale_state"):
        tio.load_trainer(d1, scaled)
    assert float(scaled.scope.loss_scale_state["scale"]) == 2.0 ** 10
    scaled.step(_FEED)
    d2 = str(tmp_path / "scaled")
    tio.save_trainer(d2, scaled)
    plain2 = _trainer()
    with pytest.warns(UserWarning, match="no loss scaler"):
        tio.load_trainer(d2, plain2)
    plain2.step(_FEED)
    d3 = str(tmp_path / "partial")
    tio.save_trainer(d3, plain2, extra_meta={"loss_scale_state": {"scale": 8.0}})
    with pytest.warns(UserWarning, match="missing"):
        tio.load_trainer(d3, scaled)
    assert float(scaled.scope.loss_scale_state["scale"]) == 8.0
    assert int(scaled.scope.loss_scale_state["overflows"]) == 0


# -- DistStrategy ----------------------------------------------------------------


def test_dist_strategy_has_every_field_of_paddle_tpu():
    import dataclasses
    want = {f.name: f.default for f in dataclasses.fields(JStrategy)}
    got = {f.name: f.default for f in dataclasses.fields(DistStrategy)}
    assert got == want
    assert unported_fields(DistStrategy(**AMP, loss_scale_growth_interval=5)) == {}
    assert unported_fields(DistStrategy(opt_state_dtype="bfloat16")) == {}


@pytest.mark.parametrize("field, value, slice_", [
    ("dump_hlo_path", "/nonexistent", "item 25"), ("async_mode", True, "slice 9")])
def test_strategy_fields_of_later_slices_raise(field, value, slice_):
    with pytest.raises(NotYetPorted, match=f"{field}.*{slice_}"):
        tpt.Trainer(_PROG, topt.SGD(0.1), place=CPU,
                    strategy=DistStrategy(**{field: value}, **AMP))
    with pytest.raises(EnforceError, match="DistStrategy"):
        tpt.Trainer(_PROG, topt.SGD(0.1), place=CPU, strategy=object())


@pytest.mark.parametrize("field, value", [
    ("accum_exchange", "hoisted"), ("zero_sharding", True), ("quantized_allreduce", "int8")])
def test_exchange_fields_need_a_mesh(field, value):
    """The multi-GPU slice's exchange knobs act on a mesh: without one they
    raise rather than do nothing (the JAX Trainer's _local_exchange_axes)."""
    with pytest.raises(EnforceError, match=f"{field}.*needs a mesh"):
        tpt.Trainer(_PROG, topt.SGD(0.1), place=CPU,
                    strategy=DistStrategy(**{field: value}, **AMP))


# -- the NaN/Inf guard ------------------------------------------------------------


def test_guard_mask_caps_at_32_checked_values():
    def many(x, label):
        out = {"loss": tL.mean(tL.softmax_with_cross_entropy(tL.fc(x, CLASSES, name="mfc"),
                                                             label))}
        for i in range(40):
            out[f"m{i:02d}"] = x.sum() * (i + 1.0)
        return out

    tr = _trainer(guard=tpt.GuardPolicy(), prog=tpt.build(many))
    before = _snapshot(tr)
    tr.step(_nan_feed(_FEED))
    tr.drain_guard()
    assert _equal(before, _snapshot(tr))
    (inc,) = tr.guard_incidents
    assert len(inc.outputs) == 32 and inc.outputs[-1].startswith("any-of-")


def test_nan_batch_discarded_params_unchanged_incident_recorded():
    tr = _trainer(guard=tpt.GuardPolicy(max_incidents=3, window=100))
    tr.step(_FEED)
    before = _snapshot(tr)
    tr.step(_nan_feed(_FEED))
    tr.drain_guard()
    assert _equal(before, _snapshot(tr))
    assert len(tr.guard_incidents) == 1
    inc = tr.guard_incidents[0]
    assert inc.step == 1 and "grads" in inc.outputs and "loss" in inc.outputs
    assert inc.feed_digest == tres.feed_digest(tr._put_feed(_nan_feed(_FEED)))
    tr.step(_FEED)  # training goes on: the next good step moves the params
    tr.drain_guard()
    assert not _equal(before, _snapshot(tr))
    assert len(tr.guard_incidents) == 1 and tr.guard_incident_total == 1


def test_nan_batch_mid_fit_completes_training():
    def reader():
        for i, batch in enumerate(_reader()()):
            if i == 3:
                batch = [(np.full_like(x, np.nan), y) for x, y in batch]
            yield batch

    tr = _trainer(guard=tpt.GuardPolicy())
    tpt.fit(tr, reader, 1, ["x", "label"], dtypes=["float32", "int64"], prefetch=False)
    assert tr.global_step == N_BATCHES  # no step lost
    assert [i.step for i in tr.guard_incidents] == [3]  # fit drained the last mask
    assert np.isfinite(float(tr.eval(_FEED)["loss"]))


@pytest.mark.parametrize("strategy", [None, DistStrategy(**AMP)], ids=["guard", "guard+scaler"])
def test_deferred_guard_discards_the_update_at_the_step_at_fault(strategy):
    """defer_readback defers the incident, not the skip: right after the NaN
    step the params and optimizer state are the old ones, and the incident
    is recorded one step later."""
    tr = _trainer(strategy=strategy, guard=tpt.GuardPolicy(defer_readback=True))
    tr.step(_FEED)
    before, opt_step = _snapshot(tr), int(tr.scope.opt_state["step"])
    tr.step(_nan_feed(_FEED))
    assert _equal(before, _snapshot(tr)) and int(tr.scope.opt_state["step"]) == opt_step
    assert tr.guard_incidents == []
    tr.step(_FEED)
    assert [i.step for i in tr.guard_incidents] == [1]
    assert not _equal(before, _snapshot(tr))


def test_guard_escalates_after_max_incidents():
    tr = _trainer(guard=tpt.GuardPolicy(max_incidents=1, window=100))
    bad = _nan_feed(_FEED)
    tr.step(bad)
    tr.step(bad)
    with pytest.raises(FloatingPointError, match="non-finite steps"):
        tr.step(_FEED)  # the deferred readback of step 1 escalates here
    assert len(tr.guard_incidents) == 2


def test_check_nan_inf_flag_routes_to_fused_guard():
    """The flag, read at startup, aborts AT the step at fault and leaves
    the params as they were."""
    config.set_flag("check_nan_inf", True)
    try:
        tr = _trainer()
        before = _snapshot(tr)
        with pytest.raises(FloatingPointError):
            tr.step(_nan_feed(_FEED))
        assert _equal(before, _snapshot(tr))
        assert len(tr.guard_incidents) == 1
        assert tr.guard_incidents[0].feed_digest is None
    finally:
        config.set_flag("check_nan_inf", False)


def test_flag_set_after_startup_warns():
    tr = _trainer()
    config.set_flag("check_nan_inf", True)
    try:
        with pytest.warns(UserWarning, match="after Trainer.startup"):
            tr.step(_nan_feed(_FEED))
    finally:
        config.set_flag("check_nan_inf", False)


def test_guard_with_loss_scaler_leaves_grad_overflow_to_scaler():
    tr = _trainer(strategy=DistStrategy(**AMP), guard=tpt.GuardPolicy())
    tr.step(_FEED)
    assert "grads" not in tr._guard_bit_names
    assert "loss" in tr._guard_bit_names and "loss_scale" in tr._guard_bit_names
    tr2 = _trainer(guard=tpt.GuardPolicy())
    tr2.step(_FEED)
    assert "grads" in tr2._guard_bit_names


def test_guard_false_overrides_check_nan_inf_flag():
    config.set_flag("check_nan_inf", True)
    try:
        tr = _trainer(guard=False)
        out = tr.step(_nan_feed(_FEED))  # must not raise
        assert "guard_nonfinite" not in out
    finally:
        config.set_flag("check_nan_inf", False)


def test_preemption_with_pending_escalation_still_saves_boundary(tmp_path):
    tr = _trainer(guard=tpt.GuardPolicy(max_incidents=0, window=100))
    cfg = tpt.CheckpointConfig(str(tmp_path), epoch_interval=0, step_interval=0)

    def reader():
        for i, batch in enumerate(_reader()()):
            yield [(np.full_like(x, np.nan), y) for x, y in batch] if i == 1 else batch

    def handler(e):
        if e.kind == "end_step" and e.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    with pytest.raises(FloatingPointError):
        tpt.fit(tr, reader, 1, ["x", "label"], dtypes=["float32", "int64"],
                checkpoint_config=cfg, event_handler=handler, prefetch=False)
    assert os.path.isdir(tmp_path / "step_2")
    assert [i.step for i in tr.guard_incidents] == [1]


def test_guard_argument_is_checked():
    with pytest.raises(EnforceError, match="GuardPolicy"):
        tpt.Trainer(_PROG, topt.SGD(0.1), place=CPU, guard=object())
