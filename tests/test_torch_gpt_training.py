"""The GPT training slice of the port against the JAX package: a small
GPT (vocab 50 in CE chunks of 16, d_model 64, 2 heads of 32, d_inner
128, 2 layers, seq 16, batch 2, use_flash=True, fused_ce=True) is built
and initialised in ``paddle_tpu``, its params are jittered from a numpy
seed (so norms and biases are not constants) and carried across with
``params_from_jax``, and both packages' Trainers take the same AdamW
steps on the same feeds, whose labels hold pad ids 0. The JAX flash
kernels run in interpret mode on the CPU; the port runs its plain
versions (``device="cpu"``).

Tolerances: f32 compute — losses rel 1e-5, step-1 grads 1e-5·max|g| per
param (the same f32 arithmetic summed in another order). bf16 compute
(``cfg.dtype`` and the compute dtype bf16, bench.py's GPT config, so the
residual stream is bf16 too) — losses rel 2e-2; step-1 grads, per
param, no farther from the JAX package's bf16 grads (relative L2) than
twice the distance of those from the JAX package's own f32 grads on the
same params, or 2e-2 where that is larger: bf16 rounds at the same
points in both, from f32 values that differ in the last bits, so the
two bf16 runs may differ by as much as bf16 rounding moves either one
(3-5% relative L2 here, measured)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as pt
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework import amp_guard
from paddle_tpu.models import gpt as jgpt

from paddle_tpu_torch import Trainer
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core.errors import NotYetPorted
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import flash_attention as tfa

CPU = "cpu"
SMALL = dict(vocab_size=50, max_len=32, d_model=64, d_inner=128, num_heads=2,
             num_layers=2, use_flash=True, fused_ce=True, ce_chunk=16)
B, S, STEPS = 2, 16, 3
LR, WD = 1e-3, 0.01
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _feeds(n=STEPS, seed=0):
    rng = np.random.RandomState(seed)
    feeds = []
    for _ in range(n):
        ids = rng.randint(3, SMALL["vocab_size"], (B, S)).astype(np.int32)
        labels = np.concatenate([ids[:, 1:], np.full((B, 1), 2)], 1).astype(np.int32)
        labels[0, -4:] = 0  # padding: masked out of the loss and the count
        feeds.append({"ids": ids, "labels": labels})
    return feeds


def _jittered(params, seed=1, scale=0.1):
    rng = np.random.RandomState(seed)
    out = {}
    for k in sorted(params):
        a = np.asarray(params[k])
        noisy = a.astype(np.float32) + scale * rng.randn(*a.shape).astype(np.float32)
        out[k] = np.asarray(jnp.asarray(noisy, a.dtype))
    return out


def _jax_training(dtype, compute, **cfg_kw):
    """(params before the first step, step-1 grads, per-step losses,
    token count) of the JAX Trainer, all as numpy."""
    feeds = _feeds()
    cfg = jgpt.base_config(dtype=dtype, **{**SMALL, **cfg_kw})
    with amp_guard(compute):
        prog = pt.build(jgpt.make_model(cfg))
        tr = pt.Trainer(prog, jopt.AdamW(LR, weight_decay=WD), loss_name="loss",
                        fetch_list=["loss"])
        tr.startup(sample_feed=feeds[0])
        params = _jittered(tr.scope.params)
        out, grads = _jax_grads(prog, params, tr.scope.state, feeds[0])
        tr.scope.params = {k: jnp.asarray(v) for k, v in params.items()}
        losses = [float(tr.step(f)["loss"]) for f in feeds]
    return params, grads, losses, float(out["token_count"])


def _jax_grads(prog, params, state, feed):
    """(outputs, grads of the loss as f32 numpy) of one JAX program."""
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    out, _ = prog.apply(jparams, state, **feed, training=True)
    grads = jax.grad(lambda p: prog.apply(p, state, **feed,
                                          training=True)[0]["loss"])(jparams)
    return out, {k: np.asarray(v, np.float32) for k, v in grads.items()}


def _jax_f32_grads(params):
    """The JAX package's step-1 grads in f32 (config and compute) on the
    same param values."""
    feed = _feeds(1)[0]
    prog = pt.build(jgpt.make_model(jgpt.base_config(dtype="float32", **SMALL)))
    _, state = prog.init(jax.random.PRNGKey(0), **feed)
    f32 = {k: np.asarray(v, np.float32) for k, v in params.items()}
    return _jax_grads(prog, f32, state, feed)[1]


@pytest.fixture(scope="module")
def jax_f32():
    return _jax_training("float32", "float32")


@pytest.fixture(scope="module")
def jax_bf16():
    return _jax_training("bfloat16", "bfloat16")


def _port_training(params, dtype, compute, **cfg_kw):
    """(step-1 grads, per-step losses, trainer) of the port's Trainer
    from the carried-over params."""
    cfg = tgpt.base_config(dtype=dtype, **{**SMALL, **cfg_kw})
    model = tgpt.make_model(cfg, compute_dtype=compute, device=CPU)
    tr = Trainer(model, topt.AdamW(LR, weight_decay=WD), loss_name="loss",
                 fetch_list=["loss"], device=CPU)
    tr.startup(params=tgpt.params_from_jax(params, device=CPU))
    losses, grads = [], None
    for f in _feeds():
        losses.append(float(tr.step(f)["loss"]))
        if grads is None:
            grads = {k: p.grad.float().numpy().copy()
                     for k, p in tr.scope.params.items()}
    return grads, losses, tr


@pytest.mark.parametrize("dtype,compute", [("float32", "float32"),
                                           ("bfloat16", "bfloat16"),
                                           ("float32", "bfloat16")])
def test_param_names_shapes_and_dtypes_are_program_init_s(dtype, compute):
    """Including the trap: ``gpt/layer_norm_0`` is created in its input's
    dtype, so it is bf16 under bf16 compute with a bf16 config, while the
    stack stays f32 and the embedding and head follow ``cfg.dtype``."""
    feed = _feeds(1)[0]
    with amp_guard(compute):
        prog = pt.build(jgpt.make_model(jgpt.base_config(dtype=dtype, **SMALL)))
        params, _ = prog.init(jax.random.PRNGKey(0), **feed)
    model = tgpt.make_model(tgpt.base_config(dtype=dtype, **SMALL),
                            compute_dtype=compute, device=CPU)
    flat = model.flat_params()
    assert sorted(flat) == sorted(params)
    for name, a in params.items():
        assert tuple(flat[name].shape) == a.shape, name
        assert str(flat[name].dtype).replace("torch.", "") == str(a.dtype), name
        assert flat[name].requires_grad, name


def test_f32_training_steps_match_jax(jax_f32):
    params, jgrads, jlosses, _ = jax_f32
    launches = (tfa.flash_fwd_launches, tfa.flash_bwd_dq_launches,
                tfa.flash_bwd_dkv_launches)
    grads, losses, _ = _port_training(params, "float32", "float32")
    # the CPU takes the plain versions: no kernel launch is counted
    assert (tfa.flash_fwd_launches, tfa.flash_bwd_dq_launches,
            tfa.flash_bwd_dkv_launches) == launches
    np.testing.assert_allclose(losses, jlosses, rtol=TOL["float32"])
    assert sorted(grads) == sorted(jgrads)
    for k, g in jgrads.items():
        np.testing.assert_allclose(grads[k], g, rtol=0,
                                   atol=TOL["float32"] * np.abs(g).max(), err_msg=k)


def test_bf16_training_steps_match_jax(jax_bf16):
    params, jgrads, jlosses, _ = jax_bf16
    grads, losses, tr = _port_training(params, "bfloat16", "bfloat16")
    assert tr.scope.params["gpt/layer_norm_0/scale"].dtype == torch.bfloat16
    assert tr.scope.params["tok/embedding_0/w"].grad.dtype == torch.bfloat16
    np.testing.assert_allclose(losses, jlosses, rtol=TOL["bfloat16"])
    f32_grads = _jax_f32_grads(params)

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    for k, g in jgrads.items():
        spread = rel(g, f32_grads[k])  # how far bf16 rounding moves JAX's grads
        assert rel(grads[k], g) <= max(2 * spread, TOL["bfloat16"]), (
            k, rel(grads[k], g), spread)


def test_eval_matches_jax_and_does_not_update(jax_f32):
    params, _, jlosses, jcount = jax_f32
    model = tgpt.make_model(tgpt.base_config(**SMALL), device=CPU)
    tr = Trainer(model, topt.AdamW(LR), device=CPU)
    tr.startup(params=tgpt.params_from_jax(params, device=CPU))
    before = {k: v.clone() for k, v in tr.scope.params.items()}
    out = tr.eval(_feeds()[0])
    # step 1's loss is computed before its update: the same number
    np.testing.assert_allclose(float(out["loss"]), jlosses[0], rtol=TOL["float32"])
    assert float(out["token_count"]) == jcount == B * S - 4
    assert tr.global_step == 0
    assert all(torch.equal(before[k], v) for k, v in tr.scope.params.items())


def test_remat_gives_the_same_grads(jax_f32):
    params = jax_f32[0]
    plain, plain_losses, _ = _port_training(params, "float32", "float32")
    remat, remat_losses, _ = _port_training(params, "float32", "float32", remat=True)
    # the same arithmetic, its forward recomputed in the backward
    assert remat_losses == plain_losses
    for k in plain:
        np.testing.assert_array_equal(remat[k], plain[k], err_msg=k)


def test_trained_params_serve_in_both_generators(jax_f32):
    """make_model's params load straight into make_generator: the port's
    trained params give the same greedy ids in the JAX generator and the
    port's."""
    _, _, tr = _port_training(jax_f32[0], "float32", "float32")
    trained = {k: v.detach().numpy() for k, v in tr.scope.params.items()}
    prompts = np.random.RandomState(5).randint(3, 50, (2, 6)).astype(np.int32)
    gen = tgpt.make_generator(tgpt.base_config(**SMALL), 5, device=CPU)
    got = gen.load_params(tgpt.params_from_jax(trained, device=CPU))(prompts)["ids"]
    jprog = pt.build(jgpt.make_generator(jgpt.base_config(**SMALL), max_new_tokens=5))
    _, state = jprog.init(jax.random.PRNGKey(0), prompts)
    want, _ = jprog.apply({k: jnp.asarray(v) for k, v in trained.items()}, state,
                          prompts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want["ids"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_and_layer_norm_match_jax(dtype):
    """layers/nn.py's two layers on their own, from JAX-initialised and
    jittered params: the gather with the JAX index rule (negative ids
    count from the end, out-of-range ids clamp) and the cast to the
    compute dtype; layer norm with f32 statistics, output in x's dtype.
    Tolerance: f32 1e-6 (the same arithmetic), bf16 one ulp (2⁻⁷ rel)."""
    from paddle_tpu import layers as jL
    from paddle_tpu_torch.layers import nn as tL

    rng = np.random.RandomState(3)
    ids = np.array([[0, 5, -1, 49], [50, 7, -50, 3]], np.int32)
    x = rng.randn(2, 4, 16).astype(np.float32)

    def net(ids, x):
        e = jL.embedding(ids, size=[50, 16], dtype=dtype)
        return {"e": e, "n": jL.layer_norm(x.astype(dtype) + e, begin_norm_axis=2)}

    with amp_guard(dtype):
        prog = pt.build(net)
        params, state = prog.init(jax.random.PRNGKey(0), ids, x)
        params = _jittered(params)
        want, _ = prog.apply({k: jnp.asarray(v) for k, v in params.items()}, state,
                             ids, x)
    tp = tgpt.params_from_jax(params, device=CPU)
    e = tL.embedding(torch.from_numpy(ids), tp["embedding_0/w"], dtype)
    n = tL.layer_norm(torch.from_numpy(x).to(e.dtype) + e, tp["layer_norm_0/scale"],
                      tp["layer_norm_0/bias"], begin_norm_axis=2)
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    for got, w in ((e, want["e"]), (n, want["n"])):
        assert str(got.dtype).replace("torch.", "") == str(w.dtype)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(w, np.float32),
                                   rtol=tol, atol=tol)


def test_training_never_writes_to_the_callers_params(jax_f32):
    """``startup(params=...)`` copies: the in-place updates of a step
    leave the caller's tensors as they were."""
    given = tgpt.params_from_jax(jax_f32[0], device=CPU)
    kept = {k: v.clone() for k, v in given.items()}
    model = tgpt.make_model(tgpt.base_config(**SMALL), device=CPU)
    tr = Trainer(model, topt.AdamW(LR), device=CPU).startup(params=given)
    tr.step(_feeds(1)[0])
    assert tr.global_step == 1
    assert all(torch.equal(given[k], kept[k]) for k in given)
    assert not torch.equal(tr.scope.params["lm_head_0/w"], given["lm_head_0/w"])


def test_dropout_in_training_is_not_ported():
    model = tgpt.make_model(tgpt.base_config(dropout=0.1, **SMALL), device=CPU)
    tr = Trainer(model, topt.AdamW(LR), device=CPU).startup(0)
    feed = _feeds(1)[0]
    with pytest.raises(NotYetPorted, match="dropout"):
        tr.step(feed)
    assert np.isfinite(float(tr.eval(feed)["loss"]))  # eval runs no dropout


@pytest.mark.parametrize("kw", ["mesh", "sharding_rules", "strategy", "guard",
                                "feed_wire", "augment"])
def test_trainer_options_of_later_slices_raise(kw):
    model = tgpt.make_model(tgpt.base_config(**SMALL), device=CPU)
    with pytest.raises(NotYetPorted):
        Trainer(model, topt.AdamW(LR), device=CPU, **{kw: object()})
