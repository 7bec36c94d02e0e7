"""What the optimizer consults per parameter, against the JAX package:
global and per-parameter regularizers (L1Decay, L2Decay, the per-param
one winning), each gradient clip, the per-parameter learning-rate
multiplier and frozen parameters, in one update of SGD, Adam and AdamW;
and every learning-rate schedule over 20 steps.

Tolerance: new params and every optimizer-state leaf to 1e-6 (rtol and
atol: the same f32 update of the same numbers, with norms summed in
another order); schedules to 1e-6 relative. A frozen parameter gets a
zero grad in both (``stop_gradient`` in the JAX package; in the port the
param is detached and ``Trainer.step`` hands the optimizer zeros for it):
both must leave it and its accumulators as they were, and the other
params must see the same global norm, which includes the frozen param's
regularized zero grad."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu import clip as jclip
from paddle_tpu import framework as jF
from paddle_tpu import lr_scheduler as jlr
from paddle_tpu import optimizer as jopt
from paddle_tpu import regularizer as jreg

from paddle_tpu_torch import clip as tclip
from paddle_tpu_torch import framework as tF
from paddle_tpu_torch import lr_scheduler as tlr
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.core.errors import NotYetPorted

TOL = 1e-6

OPTIMIZERS = {
    "sgd": lambda m, **kw: m.SGD(0.1, **kw),
    "adam": lambda m, **kw: m.Adam(0.01, beta1=0.8, beta2=0.95, epsilon=1e-6, **kw),
    "adamw": lambda m, **kw: m.AdamW(0.01, weight_decay=0.05, **kw),
}

# (optimizer kwargs, per-param attrs), each as fn(regularizer module, clip module)
CONFIGS = {
    "l2_global": (lambda R, C: {"regularization": R.L2Decay(0.05)}, {}),
    "l1_global": (lambda R, C: {"regularization": R.L1Decay(0.05)}, {}),
    "l2_alias": (lambda R, C: {"regularization": R.L2DecayRegularizer(0.02)}, {}),
    "per_param_wins": (lambda R, C: {"regularization": R.L2Decay(0.05)},
                       {"w": lambda R: {"regularizer": R.L1Decay(0.3)}}),
    "per_param_only": (lambda R, C: {}, {"b": lambda R: {"regularizer": R.L2Decay(0.5)}}),
    "clip_by_value": (lambda R, C: {"grad_clip": C.GradientClipByValue(0.05)}, {}),
    "clip_by_value_min": (lambda R, C: {"grad_clip": C.GradientClipByValue(0.05, -0.02)}, {}),
    "clip_by_norm": (lambda R, C: {"grad_clip": C.GradientClipByNorm(0.1)}, {}),
    "clip_by_global_norm": (lambda R, C: {"grad_clip": C.GradientClipByGlobalNorm(0.1)}, {}),
    "reg_then_clip": (lambda R, C: {"regularization": R.L2Decay(0.5),
                                    "grad_clip": C.GradientClipByGlobalNorm(0.2)}, {}),
    "per_param_lr": (lambda R, C: {}, {"w": lambda R: {"learning_rate": 0.25},
                                       "b": lambda R: {"learning_rate": 3.0}}),
    "frozen": (lambda R, C: {"regularization": R.L2Decay(0.05),
                             "grad_clip": C.GradientClipByGlobalNorm(0.1)},
               {"b": lambda R: {"trainable": False}}),
}


def _params_and_grads(seed=0):
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(3).astype(np.float32),
              "v": rng.randn(5).astype(np.float32)}
    grads = {k: (rng.randn(*v.shape) * 0.2).astype(np.float32) for k, v in params.items()}
    return params, grads


def _info(F, R, attrs, params):
    return {k: F.ParamInfo(shape=v.shape, dtype="float32",
                           **(attrs[k](R) if k in attrs else {}))
            for k, v in params.items()}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_one_update_matches_jax(opt, config):
    opt_kw, attrs = CONFIGS[config]
    params, grads = _params_and_grads()
    jo = OPTIMIZERS[opt](jopt, **opt_kw(jreg, jclip))
    to = OPTIMIZERS[opt](topt, **opt_kw(treg, tclip))
    jinfo, tinfo = _info(jF, jreg, attrs, params), _info(tF, treg, attrs, params)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    frozen = {k for k, i in tinfo.items() if not i.trainable}
    jg = {k: jnp.zeros_like(jp[k]) if k in frozen else jnp.asarray(v) for k, v in grads.items()}
    tg = {k: torch.zeros_like(tp[k]) if k in frozen else torch.from_numpy(v)
          for k, v in grads.items()}
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(2):  # two steps: the state after one is read by the next
        jp, js = jo.update(jg, js, jp, jinfo)
        tp, ts = to.update(tg, ts, tp, tinfo)
    for k in params:
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), rtol=TOL, atol=TOL, err_msg=k)
    jl, tl = dict(_leaves(js)), dict(_leaves(ts))
    assert sorted(jl) == sorted(tl)
    for path in jl:
        np.testing.assert_allclose(_np(tl[path]), _np(jl[path]), rtol=TOL, atol=TOL,
                                   err_msg=path)
    for k in frozen:  # untouched: the value and its accumulators
        assert np.array_equal(_np(tp[k]), params[k])
        for path, leaf in _leaves(ts["accums"][k]):
            assert np.array_equal(_np(leaf), _np(to.init({k: torch.from_numpy(params[k])})
                                                 ["accums"][k][path.strip("/")])), path


def test_clip_helpers_match_jax():
    params, grads = _params_and_grads(1)
    jn = jclip.global_norm([jnp.asarray(g) for g in grads.values()])
    tn = tclip.global_norm([torch.from_numpy(g) for g in grads.values()])
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=TOL)
    assert float(tclip.global_norm([])) == 0.0


SCHEDULES = {
    "noam": lambda m: m.noam_decay(64, 5, learning_rate=2.0),
    "exponential": lambda m: m.exponential_decay(0.1, 4, 0.5),
    "exponential_staircase": lambda m: m.exponential_decay(0.1, 4, 0.5, staircase=True),
    "natural_exp": lambda m: m.natural_exp_decay(0.1, 4, 0.3),
    "natural_exp_staircase": lambda m: m.natural_exp_decay(0.1, 4, 0.3, staircase=True),
    "inverse_time": lambda m: m.inverse_time_decay(0.1, 4, 0.5),
    "inverse_time_staircase": lambda m: m.inverse_time_decay(0.1, 4, 0.5, staircase=True),
    "polynomial": lambda m: m.polynomial_decay(0.1, 12, end_learning_rate=0.01, power=2.0),
    "polynomial_cycle": lambda m: m.polynomial_decay(0.1, 6, end_learning_rate=0.01,
                                                     cycle=True),
    "piecewise": lambda m: m.piecewise_decay([3, 8, 15], [1.0, 0.5, 0.1, 0.01]),
    "cosine": lambda m: m.cosine_decay(0.1, 3, 7),
    "cosine_steps": lambda m: m.cosine_decay_steps(0.1, 15, min_lr=0.001),
    "warmup_constant": lambda m: m.linear_lr_warmup(0.1, 5, 0.0, 0.1),
    "warmup_schedule": lambda m: m.linear_lr_warmup(m.exponential_decay(0.1, 4, 0.5),
                                                    6, 0.01, 0.1),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax_over_20_steps(name):
    js, ts = SCHEDULES[name](jlr), SCHEDULES[name](tlr)
    for step in range(20):
        want = float(js(jnp.asarray(step, jnp.int32)))
        got = ts(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=TOL, atol=0, err_msg=f"step {step}")


def test_a_schedule_drives_the_optimizer_without_reading_the_step_back():
    """The optimizer calls the schedule with its 0-d int32 step tensor; the
    rate never crosses to the host (``Tensor.item`` is not called)."""
    params, grads = _params_and_grads(2)
    o = topt.SGD(tlr.piecewise_decay([1], [0.1, 0.01]))
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    s = o.init(tp)
    item = torch.Tensor.item

    def no_item(self):
        raise AssertionError("a schedule read a tensor back to the host")

    torch.Tensor.item = no_item
    try:
        p1, s = o.update(tg, s, tp)
        p2, s = o.update(tg, s, p1)
    finally:
        torch.Tensor.item = item
    np.testing.assert_allclose(p1["w"].numpy(), params["w"] - 0.1 * grads["w"], rtol=TOL)
    np.testing.assert_allclose(p2["w"].numpy(), p1["w"].numpy() - 0.01 * grads["w"],
                               rtol=TOL)


def test_lars_is_not_ported():
    with pytest.raises(NotYetPorted):
        tlr.append_LARS([], 0.1)
