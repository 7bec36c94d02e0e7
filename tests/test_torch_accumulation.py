"""Gradient accumulation on one device (``DistStrategy(accum_steps=a)``,
``Trainer._step_body``) against ``paddle_tpu``'s Trainer on the CPU.

The JAX package splits every feed into ``a`` microbatches along dim 0
(``reshape((a, b // a) + ...)``), runs forward and backward on each with
``lax.scan`` (the program state carried from one to the next), sums the
grads in f32, divides them by ``a``, updates once and fetches each
output's mean over the microbatches (executor.py:1008-1029). The port
runs the same, eagerly (``step``) and through ``run_steps`` (the body a
card captures as one CUDA graph).

Models: the MNIST MLP (SGD) and ``mnist.conv_net`` (Momentum; its batch
norm's moving statistics are the state threaded through the
microbatches), batch 8, from the same JAX-initialised params. Tolerances:
f32, the same products summed in another order — losses rel 1e-5, params
and state after 3 steps within 1e-5 absolute (tests/test_torch_mnist.py
holds 20 unaccumulated steps to the same).
"""

import functools

import numpy as np
import pytest

import jax
import torch

import paddle_tpu as jpt
from paddle_tpu import optimizer as jopt
from paddle_tpu.data.feeder import stack_batches as jstack
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.parallel import DistStrategy as JStrategy

import paddle_tpu_torch as tpt
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core.errors import EnforceError
from paddle_tpu_torch.data import stack_batches
from paddle_tpu_torch.framework import params_from_jax
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.models import transformer as ttr

CPU = tpt.CPUPlace()
LOSS_RTOL, ATOL = 1e-5, 1e-5
BATCH, STEPS = 8, 3
MODELS = {"mlp": (jmnist.mlp, tmnist.mlp, lambda o: o.SGD(0.05)),
          "conv_net": (jmnist.conv_net, tmnist.conv_net, lambda o: o.Momentum(0.01, 0.9))}


def _feeds(n=STEPS, bs=BATCH, seed=3):
    r = np.random.RandomState(seed)
    return [{"image": r.randn(bs, 784).astype(np.float32),
             "label": r.randint(0, 10, (bs, 1)).astype(np.int64)} for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _jax_run(model, accum):
    """(initial params, per-step losses, final params, final state) of
    paddle_tpu's Trainer under ``DistStrategy(accum_steps=accum)``."""
    jfn, _, opt = MODELS[model]
    feeds = _feeds()
    jt = jpt.Trainer(jpt.build(jfn), opt(jopt), loss_name="loss",
                     strategy=JStrategy(accum_steps=accum) if accum > 1 else None)
    jt.startup(rng=jax.random.PRNGKey(2), sample_feed=feeds[0])
    p0 = {k: np.asarray(v) for k, v in jt.scope.params.items()}
    losses = [float(jt.step(f)["loss"]) for f in feeds]
    return (p0, losses, {k: np.asarray(v) for k, v in jt.scope.params.items()},
            {k: np.asarray(v) for k, v in jt.scope.state.items()})


def _port(model, accum, p0, **kw):
    _, tfn, opt = MODELS[model]
    strategy = tpt.DistStrategy(accum_steps=accum, **kw)
    tr = tpt.Trainer(tpt.build(tfn), opt(topt), loss_name="loss", place=CPU,
                     strategy=strategy)
    return tr.startup(0, _feeds()[0], params=params_from_jax(p0, device="cpu"))


def _close(got, want, what):
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v, rtol=0, atol=ATOL,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("route", ["step", "run_steps"])
@pytest.mark.parametrize("accum", [2, 4])
@pytest.mark.parametrize("model", ["mlp", "conv_net"])
def test_accumulation_matches_paddle_tpu(model, accum, route):
    p0, jlosses, jparams, jstate = _jax_run(model, accum)
    tr = _port(model, accum, p0)
    feeds = _feeds()
    if route == "step":
        losses = [float(tr.step(f)["loss"]) for f in feeds]
    else:
        out = tr.run_steps(stack_batches(feeds))
        assert out["loss"].shape == (STEPS,)
        losses = out["loss"].tolist()
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    _close(tr.scope.params, jparams, "param")
    _close(tr.scope.state, jstate, "state")
    if model == "conv_net":  # the batch norm's statistics moved
        assert any(not np.allclose(v, 0.0) and not np.allclose(v, 1.0)
                   for v in jstate.values())


def test_run_steps_equals_step_under_accumulation_bit_for_bit():
    """The body ``run_steps`` runs (and a card captures) is the eager
    step's: the same losses, params and state, bit for bit."""
    p0 = _jax_run("conv_net", 2)[0]
    seq, fused = _port("conv_net", 2, p0), _port("conv_net", 2, p0)
    feeds = _feeds()
    want = torch.stack([seq.step(f)["loss"] for f in feeds])
    got = fused.run_steps(stack_batches(feeds))["loss"]
    assert torch.equal(got, want)
    for tree in ("params", "state"):
        a, b = getattr(seq.scope, tree), getattr(fused.scope, tree)
        assert all(torch.equal(a[k], b[k]) for k in a), tree


def test_accumulation_equals_one_large_batch():
    """The multi_batch_merge_pass analog, as tests/test_e2e_mnist.py:109
    holds it: the MLP's mean loss over equal microbatches has the large
    batch's grads, so 4 accumulated microbatches of 16 take the SGD step of
    one batch of 64 (params within 1e-5: another summation order)."""
    feed = _feeds(1, bs=64, seed=9)[0]
    p0 = _jax_run("mlp", 2)[0]
    plain, acc = _port("mlp", 1, p0), _port("mlp", 4, p0)
    lp, la = float(plain.step(feed)["loss"]), float(acc.step(feed)["loss"])
    np.testing.assert_allclose(la, lp, rtol=LOSS_RTOL)
    for k, p in plain.scope.params.items():
        torch.testing.assert_close(acc.scope.params[k], p, rtol=0, atol=ATOL)


def test_accumulation_under_a_loss_scaler_matches_paddle_tpu():
    """Each microbatch's loss is scaled; the summed grads are unscaled,
    checked and applied once, and the scale grows per step, not per
    microbatch."""
    kw = dict(loss_scale=2.0 ** 10, dynamic_loss_scale=True, loss_scale_growth_interval=2)
    feeds = _feeds()
    jt = jpt.Trainer(jpt.build(jmnist.mlp), jopt.SGD(0.05), loss_name="loss",
                     strategy=JStrategy(accum_steps=2, **kw))
    jt.startup(rng=jax.random.PRNGKey(2), sample_feed=feeds[0])
    p0 = {k: np.asarray(v) for k, v in jt.scope.params.items()}
    jouts = [jt.step(f) for f in feeds]
    tr = _port("mlp", 2, p0, **kw)
    outs = [tr.step(f) for f in feeds]
    np.testing.assert_allclose([float(o["loss"]) for o in outs],
                               [float(o["loss"]) for o in jouts], rtol=LOSS_RTOL)
    assert [float(o["loss_scale"]) for o in outs] == \
        [float(o["loss_scale"]) for o in jouts] == [2.0 ** 10, 2.0 ** 11, 2.0 ** 11]
    _close(tr.scope.params, {k: np.asarray(v) for k, v in jt.scope.params.items()}, "param")


def test_bf16_params_accumulate_in_f32(monkeypatch):
    """GPT's bf16 params (``tok/embedding_0/w``, ``lm_head_0/w`` in a bf16
    config) get f32 grads from the accumulation, as the JAX package's
    ``jnp.zeros(p.shape, jnp.float32)`` sum hands its optimizer; the grad
    left on the param is in its own dtype."""
    cfg = tgpt.base_config(vocab_size=30, max_len=16, d_model=32, d_inner=64, num_heads=2,
                           num_layers=1, use_flash=True, fused_ce=True, ce_chunk=16,
                           dtype="bfloat16")
    r = np.random.RandomState(5)
    ids = r.randint(3, 30, (4, 8)).astype(np.int32)
    feed = {"ids": ids, "labels": np.roll(ids, -1, axis=1)}
    seen = {}
    opt = topt.AdamW(1e-3)
    update = opt.update

    def recording(grads, *a, **kw):
        seen.update({k: g.dtype for k, g in grads.items()})
        return update(grads, *a, **kw)

    monkeypatch.setattr(opt, "update", recording)
    with tpt.amp_guard("bfloat16"):
        tr = tpt.Trainer(tpt.build(tgpt.make_model(cfg)), opt, device="cpu",
                         strategy=tpt.DistStrategy(accum_steps=2)).startup(0, feed)
        out = tr.step(feed)
    assert np.isfinite(float(out["loss"]))
    assert tr.scope.params["lm_head_0/w"].dtype == torch.bfloat16
    assert set(seen.values()) == {torch.float32}
    assert tr.scope.params["lm_head_0/w"].grad.dtype == torch.bfloat16


def test_each_microbatch_draws_its_own_dropout_masks():
    """At dropout 0.1 a step of 2 microbatches of one repeated batch gives
    two different losses (each microbatch draws its masks from the step's
    stream in turn), whose mean is the step's loss; the same step seed
    draws the same masks again."""
    cfg = ttr.base_config(src_vocab=40, trg_vocab=40, max_len=8, d_model=16, d_inner=32,
                          num_heads=2, num_encoder_layers=1, num_decoder_layers=1,
                          dropout=0.1, fuse_qkv=True)
    r = np.random.RandomState(4)
    half = {k: r.randint(3, 40, (2, 8)).astype(np.int32)
            for k in ("src_ids", "trg_ids", "labels")}
    feed = {k: np.concatenate([v, v]) for k, v in half.items()}

    def make(accum):
        return tpt.Trainer(tpt.build(ttr.make_model(cfg)), topt.SGD(0.0), loss_name="loss",
                           fetch_list=["loss"], place=CPU,
                           strategy=tpt.DistStrategy(accum_steps=accum)).startup(0, feed)

    tr = make(2)
    micro = []
    run = tr._forward_backward

    def recording(*a):
        out, state = run(*a)
        micro.append(float(out["loss"]))
        return out, state

    tr._forward_backward = recording
    loss = float(tr.step(feed, rng=7)["loss"])
    assert len(micro) == 2 and micro[0] != micro[1]
    np.testing.assert_allclose(loss, sum(micro) / 2, rtol=1e-6)
    assert float(make(2).step(feed, rng=7)["loss"]) == loss


def test_a_batch_accum_steps_does_not_divide_raises():
    tr = _port("mlp", 3, _jax_run("mlp", 2)[0])
    with pytest.raises(EnforceError, match="accum_steps=3"):
        tr.step(_feeds()[0])
    assert tr.global_step == 0


def test_strategy_accum_steps_run_steps_key():
    """Accumulation is part of what a captured step is specific to."""
    from paddle_tpu_torch import _captured_step
    p0 = _jax_run("mlp", 2)[0]
    tr = _port("mlp", 2, p0)
    feed_k = {k: torch.from_numpy(v) for k, v in jstack(_feeds()).items()}
    base = _captured_step.signature(tr, feed_k)
    tr.strategy = tpt.DistStrategy(accum_steps=4)
    assert _captured_step.signature(tr, feed_k) != base
