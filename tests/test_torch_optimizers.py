"""The port's SGD, Adam and AdamW against the JAX package's: the same
params (one of them bf16) and grads, three updates, new params and
optimizer state compared leaf by leaf.

Tolerance: rtol 1e-6, atol 1e-7 (f32 updates of the same numbers in the
same order; bf16 params compared after both round them to bf16, where
equal f32 values round alike)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core.errors import EnforceError, NotYetPorted

RTOL, ATOL = 1e-6, 1e-7


def _params_and_grads(seed):
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(3).astype(np.float32),
              "emb_bf16": rng.randn(5, 2).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 0.1).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    return params, grads


def _to_jax(params, bf16="emb_bf16"):
    return {k: jnp.asarray(v, jnp.bfloat16 if k == bf16 else jnp.float32)
            for k, v in params.items()}


def _to_torch(params, bf16="emb_bf16"):
    return {k: torch.from_numpy(v).to(torch.bfloat16 if k == bf16 else torch.float32)
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
    "sgd": lambda m: m.SGD(0.1),
    "adam": lambda m: m.Adam(0.01, beta1=0.8, beta2=0.95, epsilon=1e-6),
    "adamw": lambda m: m.AdamW(0.01, weight_decay=0.05),
    "adamw_callable_lr": lambda m: m.AdamW(lambda step: 0.01 / (1.0 + step),
                                           weight_decay=0.01),
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
    assert int(ts["step"]) == 3


def test_a_param_without_grad_keeps_value_and_state():
    params, grads = _params_and_grads(1)
    o = topt.AdamW(0.01)
    tp = _to_torch(params)
    s = o.init(tp)
    g = {k: torch.from_numpy(v) for k, v in grads[0].items()}
    g["b"] = None
    new, s2 = o.update(g, s, tp)
    assert new["b"] is tp["b"] and s2["accums"]["b"] is s["accums"]["b"]
    assert not torch.equal(new["w"], tp["w"])


@pytest.mark.parametrize("kw", [{"regularization": object()}, {"grad_clip": object()}])
def test_regularization_and_clipping_are_not_ported(kw):
    """Regularization and clipping are ported now (their parity is in
    test_torch_optimizer_attrs.py); what is refused up front is an object
    that is neither a regularizer nor a clip."""
    with pytest.raises(EnforceError, match="expected a"):
        topt.AdamW(0.01, **kw)


def test_reduced_state_dtype_is_not_ported():
    o = topt.Adam(0.01)
    assert o.set_state_dtype(None) is o
    with pytest.raises(NotYetPorted):
        o.set_state_dtype("bfloat16")
