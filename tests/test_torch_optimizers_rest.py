"""The rest of ``optimizer.py`` against ``paddle_tpu.optimizer``:
LarsMomentum, Adagrad, Adamax, DecayedAdagrad, Adadelta, RMSProp (plain,
momentum, centered), Ftrl (both ``lr_power`` branches), Lamb; the
parameter averages ModelAverage (across its window restart) and
ExponentialMovingAverage; ``set_state_dtype`` and
``DistStrategy(opt_state_dtype=)``; ``lr_scheduler.append_LARS``.

Each optimizer takes 5 updates of the same params (one of them bf16) and
grads in both packages; the new params and every optimizer-state leaf
are compared after each. Tolerance: rtol 1e-6, atol 1e-7, as
tests/test_torch_optimizers.py states it (f32 updates of the same numbers
in the same order; the norms of Lars and Lamb are sums over at most 12
elements). Under a bf16 state the stored accumulators are compared bit
for bit: both packages round the same f32 results to bf16."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as jpt
from paddle_tpu import layers as jL
from paddle_tpu import lr_scheduler as jlr
from paddle_tpu import optimizer as jopt
from paddle_tpu.parallel import DistStrategy as JStrategy

import paddle_tpu_torch as tpt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import layers as tL
from paddle_tpu_torch import lr_scheduler as tlr
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import params_from_jax
from paddle_tpu_torch.parallel import DistStrategy

RTOL, ATOL = 1e-6, 1e-7
STEPS = 5
CPU = tpt.CPUPlace()


def _params_and_grads(seed):
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(3).astype(np.float32),
              "emb_bf16": rng.randn(5, 2).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 0.1).astype(np.float32)
              for k, v in params.items()} for _ in range(STEPS)]
    return params, grads


def _to_jax(params):
    return {k: jnp.asarray(v, jnp.bfloat16 if k == "emb_bf16" else jnp.float32)
            for k, v in params.items()}


def _to_torch(params):
    return {k: torch.from_numpy(v).to(torch.bfloat16 if k == "emb_bf16" else torch.float32)
            for k, v in params.items()}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


OPTIMIZERS = {
    "lars_momentum": lambda m: m.LarsMomentum(0.1, momentum=0.9, lars_coeff=0.01,
                                              lars_weight_decay=5e-4),
    "lars_momentum_eps": lambda m: m.LarsMomentum(0.1, lars_coeff=0.02, epsilon=1e-3),
    "adagrad": lambda m: m.Adagrad(0.05),
    "adagrad_initial_acc": lambda m: m.Adagrad(0.05, epsilon=1e-5,
                                               initial_accumulator_value=0.1),
    "adamax": lambda m: m.Adamax(0.01, beta1=0.8, beta2=0.95),
    "decayed_adagrad": lambda m: m.DecayedAdagrad(0.05, decay=0.9),
    "adadelta": lambda m: m.Adadelta(1.0, rho=0.9),
    "rmsprop": lambda m: m.RMSProp(0.01),
    "rmsprop_momentum": lambda m: m.RMSProp(0.01, rho=0.9, momentum=0.5),
    "rmsprop_centered": lambda m: m.RMSProp(0.01, rho=0.9, momentum=0.5, centered=True),
    "ftrl_sqrt": lambda m: m.Ftrl(0.1, l1=0.01, l2=0.1),
    "ftrl_pow": lambda m: m.Ftrl(0.1, l1=0.01, l2=0.1, lr_power=-0.3),
    "ftrl_no_l1": lambda m: m.Ftrl(0.1),
    "lamb": lambda m: m.Lamb(0.01, lamb_weight_decay=0.01),
    "lamb_callable_lr": lambda m: m.Lamb(lambda step: 0.01 / (1.0 + step)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_updates_and_state_match_jax(name):
    params, grads = _params_and_grads(0)
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](topt)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jo.init(jp), to.init(tp)
    for step, g in enumerate(grads):
        jg = {k: jnp.asarray(v).astype(jp[k].dtype) for k, v in g.items()}
        tg = {k: torch.from_numpy(v).to(tp[k].dtype) for k, v in g.items()}
        jp, js = jo.update(jg, js, jp)
        tp, ts = to.update(tg, ts, tp)
        for k in params:
            assert tp[k].dtype == {"emb_bf16": torch.bfloat16}.get(k, torch.float32)
            np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} step {step} param {k}")
        jl, tl = dict(_leaves(js)), dict(_leaves(ts))
        assert sorted(jl) == sorted(tl), (sorted(jl), sorted(tl))
        for path in jl:
            np.testing.assert_allclose(_np(tl[path]), _np(jl[path]), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{name} step {step} {path}")
    assert int(ts["step"]) == STEPS


def test_fluid_aliases_name_the_same_classes():
    for alias in ("SGD", "Momentum", "LarsMomentum", "Adagrad", "Adam", "Adamax",
                  "DecayedAdagrad", "Adadelta", "RMSProp", "Ftrl"):
        assert getattr(topt, alias + "Optimizer") is getattr(topt, alias)
        assert hasattr(jopt, alias + "Optimizer")


@pytest.mark.parametrize("name", ["adam", "adagrad", "rmsprop_centered", "lamb", "adamax",
                                  "momentum"])
def test_bf16_state_is_stored_as_the_jax_package_stores_it(name):
    make = dict(OPTIMIZERS, adam=lambda m: m.Adam(0.01, beta1=0.8, beta2=0.95),
                momentum=lambda m: m.Momentum(0.1, 0.9))[name]
    params, grads = _params_and_grads(1)
    jo = make(jopt).set_state_dtype("bfloat16")
    to = make(topt).set_state_dtype("bfloat16")
    assert to.state_dtype == torch.bfloat16
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jo.init(jp), to.init(tp)
    for step, g in enumerate(grads):
        jp, js = jo.update({k: jnp.asarray(v).astype(jp[k].dtype) for k, v in g.items()},
                           js, jp)
        tp, ts = to.update({k: torch.from_numpy(v).to(tp[k].dtype) for k, v in g.items()},
                           ts, tp)
        for k in params:
            np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} step {step} param {k}")
        for path, want in _leaves(js["accums"]):
            got = dict(_leaves(ts["accums"]))[path]
            assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16, path
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          np.asarray(want).view(np.int16),
                                          err_msg=f"{name} step {step} {path}")
    # None restores f32 accumulators
    assert topt.Adam(0.1).set_state_dtype("bfloat16").set_state_dtype(None).init(
        tp)["accums"]["w"]["moment1"].dtype == torch.float32


def _model_average_run(m, window_max):
    rng = np.random.RandomState(5)
    seq = [{"w": rng.randn(3, 2).astype(np.float32), "h": rng.randn(4).astype(np.float32)}
           for _ in range(7)]
    conv = (lambda p: {k: jnp.asarray(v) for k, v in p.items()}) if m is jopt else \
        (lambda p: {k: torch.from_numpy(v) for k, v in p.items()})
    ma = m.ModelAverage(min_average_window=2, max_average_window=window_max)
    st = ma.init(conv(seq[0]))
    avgs = []
    for p in seq:
        st = ma.accumulate(st, conv(p))
        avgs.append({k: _np(v) for k, v in ma.average_params(st, conv(p)).items()})
    return avgs, float(st["num"])


@pytest.mark.parametrize("window_max", [3, 100])
def test_model_average_matches_jax_across_its_window_restart(window_max):
    want, n_want = _model_average_run(jopt, window_max)
    got, n_got = _model_average_run(topt, window_max)
    assert n_got == n_want == (7 if window_max == 100 else 1)  # restarts at 4 and 7
    for i, (g, w) in enumerate(zip(got, want)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL, err_msg=f"{i} {k}")


def test_exponential_moving_average_matches_jax():
    rng = np.random.RandomState(6)
    seq = [rng.randn(3, 2).astype(np.float32) for _ in range(5)]
    je, te = jopt.ExponentialMovingAverage(0.9), topt.ExponentialMovingAverage(0.9)
    js = je.init({"w": jnp.asarray(seq[0], jnp.bfloat16)})
    ts = te.init({"w": torch.from_numpy(seq[0]).to(torch.bfloat16)})
    for p in seq[1:]:
        js = je.accumulate(js, {"w": jnp.asarray(p)})
        ts = te.accumulate(ts, {"w": torch.from_numpy(p)})
        np.testing.assert_allclose(_np(ts["w"]), _np(js["w"]), rtol=RTOL, atol=ATOL)
    got = te.average_params(ts, {"w": torch.zeros(3, 2, dtype=torch.bfloat16)})["w"]
    want = je.average_params(js, {"w": jnp.zeros((3, 2), jnp.bfloat16)})["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))


def test_append_lars_matches_jax():
    rng = np.random.RandomState(7)
    pairs = [(rng.randn(4, 3).astype(np.float32), rng.randn(4, 3).astype(np.float32) * 0.1),
             (rng.randn(5).astype(np.float32), np.zeros(5, np.float32))]
    want = jlr.append_LARS([(jnp.asarray(p), jnp.asarray(g)) for p, g in pairs], 0.1,
                           weight_decay=1e-3)
    got = tlr.append_LARS([(torch.from_numpy(p), torch.from_numpy(g)) for p, g in pairs],
                          0.1, weight_decay=1e-3)
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=RTOL)


def _net(L):
    def net(x, label):
        h = L.fc(x, 16, act="relu", name="h")
        return {"loss": L.mean(L.softmax_with_cross_entropy(L.fc(h, 4, name="o"), label))}
    return net


def _feed():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(8, 6).astype(np.float32),
            "label": rng.randint(0, 4, (8, 1)).astype(np.int64)}


def test_opt_state_dtype_strategy_trains_as_the_jax_trainer():
    """``DistStrategy(opt_state_dtype="bfloat16")``: the Trainer sets the
    dtype before ``init``; after 3 Adam steps from the same params the
    stored moments equal the JAX trainer's bit for bit, the params within
    the tolerance."""
    feed = _feed()
    jt = jpt.Trainer(jpt.build(_net(jL)), jopt.Adam(5e-3), loss_name="loss",
                     strategy=JStrategy(opt_state_dtype="bfloat16"))
    jt.startup(sample_feed=feed)
    p0 = {k: np.asarray(v) for k, v in jt.scope.params.items()}
    tt = tpt.Trainer(tpt.build(_net(tL)), topt.Adam(5e-3), loss_name="loss", place=CPU,
                     strategy=DistStrategy(opt_state_dtype="bfloat16"))
    tt.startup(sample_feed=feed, params=params_from_jax(p0, device="cpu"))
    assert tt.optimizer.state_dtype == torch.bfloat16
    for _ in range(3):
        jl, tl = float(jt.step(feed)["loss"]), float(tt.step(feed)["loss"])
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for k in p0:
        np.testing.assert_allclose(tt.scope.params[k].detach().numpy(),
                                   np.asarray(jt.scope.params[k]), rtol=1e-5, atol=1e-6)
        for slot, want in jt.scope.opt_state["accums"][k].items():
            got = tt.scope.opt_state["accums"][k][slot]
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32),
                                          err_msg=f"{k}/{slot}")


def test_bf16_optimizer_state_checkpoint_round_trip(tmp_path):
    """As tests/test_optimizers.py:250 for the JAX package: bf16 accums
    survive ``save_trainer``/``load_trainer`` with dtype and values."""
    feed = _feed()

    def trainer():
        return tpt.Trainer(tpt.build(_net(tL)), topt.Adam(1e-3), loss_name="loss",
                           place=CPU, strategy=DistStrategy(opt_state_dtype="bfloat16"))

    tr = trainer().startup(0, feed)
    tr.step(feed)
    d = str(tmp_path / "ck")
    tio.save_trainer(d, tr)
    tr2 = trainer().startup(1, feed)
    tio.load_trainer(d, tr2)
    for k, acc in tr.scope.opt_state["accums"].items():
        for name, v in acc.items():
            got = tr2.scope.opt_state["accums"][k][name]
            assert got.dtype == v.dtype == torch.bfloat16, (k, name)
            assert torch.equal(got, v), (k, name)
    out1, out2 = tr.step(feed), tr2.step(feed)
    assert torch.equal(out1["loss"], out2["loss"])


@pytest.mark.parametrize("name", ["lamb", "lars_momentum"])
def test_norm_optimizers_train_fused_as_stepped(name):
    """Lamb and LarsMomentum, whose norms are reductions, give the same
    bits through ``run_steps`` (its static-slot body, on the CPU) as
    through ``step``."""
    feed = _feed()
    trs = [tpt.Trainer(tpt.build(_net(tL)), OPTIMIZERS[name](topt), loss_name="loss",
                       place=CPU).startup(0, feed) for _ in range(2)]
    eager = torch.stack([trs[0].step(feed)["loss"] for _ in range(3)])
    fused = trs[1].run_steps(tpt.data.stack_batches([feed] * 3))["loss"]
    assert torch.equal(eager, fused)
    for k, p in trs[0].scope.params.items():
        assert torch.equal(p, trs[1].scope.params[k]), k
