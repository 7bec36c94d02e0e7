"""The mixture of experts of the port (``parallel/moe.py``,
``models/moe_transformer.py``) against ``paddle_tpu.parallel.moe`` and the
JAX MoE LM.

In this process: the top-k dispatch (ties included) and its capacity
drops, the load-balance loss (a uniform router gives 1.0), the recorded
routing configs, the layer's output and grads and the LM's loss and grads
in f32 from the JAX package's params.

On one spawned gloo world of 4 ranks (``torch_dist_worker.py``, suite
"moe"): the layer at ep=4 and dp2×ep2 (experts sharded by
``moe_ep_rules``, tokens over the data axes and ep) and at dp=4 (the dense
path on a mesh: every rank routes the whole batch), forward and backward
under a fixed cotangent, against the JAX dense path and the port's own;
then two Adam steps of the LM (d 32, 2 layers, 8 experts, top-2, aux
weight 0, capacity factor 4: no token dropped) at ep=4 and dp2×ep2
against the JAX single-device Trainer and the port's dense Trainer, as
tests/test_moe_transformer.py holds the JAX ep mesh to its dense path.

Tolerances: the layer 1e-5 (its grads relative to the largest), the
losses 2e-4 (tests/test_moe_transformer.py:66)."""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import moe_transformer as jmt
from paddle_tpu.parallel import moe as jmoe

import torch

import paddle_tpu_torch as tpt
from paddle_tpu_torch import framework as tF
from paddle_tpu_torch.models import moe_transformer as tmt
from paddle_tpu_torch.parallel import moe as tmoe

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as W  # noqa: E402

CPU = tpt.CPUPlace()


def _jlayer(c=W.MOE_LAYER, mesh=None):
    def fn(x):
        out, aux = jmoe.moe(x, num_experts=c["E"], d_ff=c["ff"], top_k=c["top_k"],
                            capacity_factor=c["cf"], mesh=mesh)
        return {"out": out, "aux": aux}
    return pt.build(fn)


def _jlayer_run(params, c=W.MOE_LAYER):
    x, g = W.moe_input(c)
    prog = _jlayer(c)

    def f(p, xv):
        out, _ = prog.apply(p, {}, xv)
        return out["out"], out["aux"]
    (out, aux), vjp = jax.vjp(jax.jit(f), params, jnp.asarray(x))
    gp, gx = vjp((jnp.asarray(g), jnp.zeros_like(aux)))
    return (np.asarray(out), float(aux), {k: np.asarray(v) for k, v in gp.items()},
            np.asarray(gx))


@pytest.fixture(scope="module")
def layer_params():
    x, _ = W.moe_input()
    params, _ = _jlayer().init(jax.random.PRNGKey(0), x)
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def jax_layer(layer_params):
    return _jlayer_run({k: jnp.asarray(v) for k, v in layer_params.items()})


def _jax_lm_trainer():
    prog = pt.build(jmt.make_model(jmt.base_config(**W.MOE_CFG)))
    tr = pt.Trainer(prog, jopt.Adam(W.MOE_LR), loss_name="loss")
    tr.startup(sample_feed=W.moe_feed())
    return tr


@pytest.fixture(scope="module")
def jax_lm():
    tr = _jax_lm_trainer()
    params = {k: np.asarray(v) for k, v in tr.scope.params.items()}
    losses = np.array([float(tr.step(W.moe_feed(seed=i))["loss"])
                       for i in range(W.MOE_STEPS)])
    return params, losses


@pytest.fixture(scope="module")
def world(tmp_path_factory, layer_params, jax_lm):
    d = str(tmp_path_factory.mktemp("moe_world"))
    np.savez(os.path.join(d, "params_moe_layer.npz"), **layer_params)
    np.savez(os.path.join(d, "params_moe.npz"), **jax_lm[0])
    return dict(np.load(W.spawn_world("moe", d, d)))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-30))


# -- routing ----------------------------------------------------------------------------


def _probs_with_ties(t=12, e=4, seed=0):
    rng = np.random.RandomState(seed)
    p = rng.rand(t, e).astype(np.float32)
    p[0] = [0.25, 0.25, 0.25, 0.25]      # all tied
    p[1] = [0.1, 0.4, 0.4, 0.1]          # tied first choices
    p[2] = [0.3, 0.3, 0.2, 0.2]
    p[5] = p[1]
    return p / p.sum(1, keepdims=True)


@pytest.mark.parametrize("top_k, capacity, normalize", [
    (1, 3, True), (2, 3, True), (2, 2, False), (2, 12, True), (3, 4, True)])
def test_topk_dispatch_matches_paddle_tpu(top_k, capacity, normalize):
    p = _probs_with_ties()
    jd, jc, jm = jmoe._topk_dispatch(jnp.asarray(p), top_k, capacity, normalize)
    td, tc, tm = tmoe._topk_dispatch(torch.from_numpy(p), top_k, capacity, normalize)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_aux_loss_of_a_uniform_router_is_one():
    t = torch.full((16, 8), 1.0 / 8)
    _, _, mask = tmoe._topk_dispatch(t, 2, 8, True)
    np.testing.assert_allclose(float(tmoe._aux_loss(t, mask)), 1.0, atol=1e-6)
    p = _probs_with_ties()
    _, _, jm = jmoe._topk_dispatch(jnp.asarray(p), 2, 4, True)
    _, _, tm = tmoe._topk_dispatch(torch.from_numpy(p), 2, 4, True)
    np.testing.assert_allclose(float(tmoe._aux_loss(torch.from_numpy(p), tm)),
                               float(jmoe._aux_loss(jnp.asarray(p), jm)), rtol=1e-6)


def test_capacity_drops_tokens_as_paddle_tpu():
    c = dict(W.MOE_LAYER, b=4, cf=0.25, top_k=1)
    x, _ = W.moe_input(c)
    jparams, _ = _jlayer(c).init(jax.random.PRNGKey(0), x)
    jout, jaux, _, _ = _jlayer_run(jparams, c)
    params = tF.params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    out, _ = W.moe_layer_program(None, c).apply(params, {}, x=torch.from_numpy(x), place=CPU)
    got = out["out"].numpy()
    _close(got, jout)
    assert np.isfinite(got).all()
    # tokens past capacity: zero rows
    assert (np.abs(got.reshape(-1, c["d"])).sum(1) == 0).sum() > 0


def test_recorded_configs_match_paddle_tpu():
    x, _ = W.moe_input()
    # the JAX side records while it traces: its init's shapes are enough
    with jmoe.capture_moe_configs() as jlog:
        jax.eval_shape(lambda: _jlayer().init(jax.random.PRNGKey(0), x))
    with tmoe.capture_moe_configs() as tlog:
        W.moe_layer_program(None).init(0, torch.from_numpy(x), place=CPU)
    assert tlog == jlog and len(tlog) == 1
    cfg = tmt.base_config(**W.MOE_CFG)
    feed = W.moe_feed()
    with tmoe.capture_moe_configs() as tlog:
        tpt.build(tmt.make_model(cfg)).init(0, place=CPU, **{k: torch.from_numpy(v)
                                                              for k, v in feed.items()})
    with jmoe.capture_moe_configs() as jlog:
        jax.eval_shape(lambda: pt.build(jmt.make_model(jmt.base_config(**W.MOE_CFG))).init(
            jax.random.PRNGKey(0), **feed))
    assert tlog == jlog


def test_moe_layer_matches_paddle_tpu(layer_params, jax_layer):
    jout, jaux, jgp, jgx = jax_layer
    x, g = W.moe_input()
    params = {k: v.requires_grad_(True) for k, v in
              tF.params_from_jax(layer_params, device="cpu").items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, _ = W.moe_layer_program(None).apply(params, {}, x=tx, place=CPU)
    _close(out["out"].detach().numpy(), jout)
    np.testing.assert_allclose(float(out["aux"].detach()), jaux, rtol=1e-6)
    (out["out"] * torch.from_numpy(g)).sum().backward()
    for k in jgp:
        _close(params[k].grad.numpy(), jgp[k], 1e-5)
    _close(tx.grad.numpy(), jgx)


@pytest.mark.parametrize("n", [2, 4])
def test_ep_ranks_in_one_process_match_paddle_tpu(layer_params, jax_layer, n):
    # LocalRanks(n, "ep"): the n ep ranks' routes, layouts and exchanges run
    # in this process; no token is dropped at MOE_LAYER's capacity factor,
    # so the JAX dense path is the reference
    from paddle_tpu_torch.parallel.pipeline import LocalRanks
    jout, jaux, jgp, jgx = jax_layer
    x, g = W.moe_input()
    params = {k: v.requires_grad_(True) for k, v in
              tF.params_from_jax(layer_params, device="cpu").items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    with tmoe.capture_moe_configs() as log:
        out, _ = W.moe_layer_program(LocalRanks(n, "ep")).apply(params, {}, x=tx, place=CPU)
    c = W.MOE_LAYER
    assert log[0]["ep"] == n and log[0]["tokens"] == c["b"] // n * c["s"]
    _close(out["out"].detach().numpy(), jout)
    # the aux is the mean of the ranks' own, as on the world's ep path
    assert np.isfinite(float(out["aux"].detach()))
    assert float(out["aux"].detach()) >= 1.0 - 1e-5
    (out["out"] * torch.from_numpy(g)).sum().backward()
    for k in jgp:
        _close(params[k].grad.numpy(), jgp[k], 1e-5)
    _close(tx.grad.numpy(), jgx)


def test_moe_lm_loss_and_grads_match_paddle_tpu():
    kw = dict(W.MOE_CFG, aux_weight=0.01, capacity_factor=1.25)
    feed = W.moe_feed()
    jprog = pt.build(jmt.make_model(jmt.base_config(**kw)))
    jp, _ = jprog.init(jax.random.PRNGKey(1), **feed)

    def jl(p):
        out, _ = jprog.apply(p, {}, **feed)
        return out["loss"], out
    (jloss, jout), jg = jax.jit(jax.value_and_grad(jl, has_aux=True))(jp)
    tp = {k: v.requires_grad_(True) for k, v in
          tF.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, device="cpu").items()}
    assert set(tp) == set(jp) and any(k.endswith("moe_0/router_w") for k in tp)
    out, _ = tpt.build(tmt.make_model(tmt.base_config(**kw))).apply(
        tp, {}, place=CPU, **{k: torch.from_numpy(v) for k, v in feed.items()})
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(out["aux_loss"]), float(jout["aux_loss"]), rtol=1e-5)
    gmax = max(float(np.abs(np.asarray(v)).max()) for v in jg.values())
    for k in jp:
        # a key projection's bias gets a grad of 0 in exact arithmetic: held
        # against the model's largest grad
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]), rtol=1e-4,
                                   atol=1e-5 * gmax, err_msg=k)


def test_a_bank_that_does_not_split_over_ep_raises():
    class _M:
        axis_names, shape = ("ep",), {"ep": 3}
    prog = tpt.build(lambda x: dict(zip(("out", "aux"), tmoe.moe(x, 8, 16, mesh=_M()))))
    with pytest.raises(ValueError, match="not divisible by ep=3"):
        prog.init(0, torch.zeros(2, 2, 4), place=CPU)


def test_moe_ep_rules_match_paddle_tpu():
    got = [(pat, tuple(spec)) for pat, spec in tmoe.moe_ep_rules()]
    want = [(pat, tuple(spec)) for pat, spec in jmoe.moe_ep_rules()]
    assert got == want


# -- the world of 4 -----------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(W.MOE_MESHES))
def test_ep_layer_matches_the_dense_paths(world, jax_layer, name):
    jout, _, jgp, jgx = jax_layer
    _close(world[f"{name}/layer/out"], jout)
    _close(world[f"{name}/layer/dx"], jgx)
    _close(world[f"{name}/layer/out"], world["dense/layer/out"])
    for k in jgp:
        _close(world[f"{name}/layer/grad/{k}"], jgp[k])
        _close(world[f"{name}/layer/grad/{k}"], world[f"dense/layer/grad/{k}"])
    assert np.isfinite(float(world[f"{name}/layer/aux"]))
    assert float(world[f"{name}/layer/aux"]) >= 1.0 - 1e-5
    w1 = [k for k in jgp if k.endswith("expert_w1")][0]
    if "ep" in W.MOE_MESHES[name]:
        assert str(world[f"{name}/layer/spec/{w1}"]).startswith("P('ep'")
    # the capacity comes from the global batch, as the JAX ep path traces it
    x, _ = W.moe_input()
    mesh = pt.make_mesh(W.MOE_MESHES[name], devices=jax.devices()[:4])
    with jmoe.capture_moe_configs() as jlog:
        jax.eval_shape(lambda: _jlayer(mesh=mesh).init(jax.random.PRNGKey(0), x))
    assert str(world[f"{name}/layer/config"]) == repr(sorted(jlog[0].items()))


@pytest.mark.parametrize("name", sorted(n for n, a in W.MOE_MESHES.items() if "ep" in a))
def test_ep_lm_training_matches_paddle_tpu_and_the_dense_trainer(world, jax_lm, name):
    np.testing.assert_allclose(world[f"{name}/losses"], jax_lm[1], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(world[f"{name}/losses"], world["dense/losses"], rtol=2e-4,
                               atol=2e-4)
