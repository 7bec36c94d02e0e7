"""BERT pretraining in the port against ``paddle_tpu`` on the CPU: a small
BERT (vocab 100, d_model 32, d_inner 64, 4 heads, 2 layers, max_len 32,
seq 16, batch 2, 5 masked positions, pad ids 0 in the inputs) is
initialised in ``paddle_tpu``, its params jittered from a numpy seed and
carried across with ``params_from_jax``; the port runs the flash
kernels' plain versions, the JAX package its kernels in interpret mode.

Tolerances: f32 — the losses rel 1e-5, every grad within 1e-5·max|g| of
its param (the same f32 arithmetic summed in another order), except a
key projection's bias, whose grad is 0 in exact arithmetic and is held
within 1e-5 of the model's largest grad. Two AdamW steps' losses rel
1e-5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as jpt
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework import amp_guard as jamp
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch as tpt
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import amp_guard as tamp
from paddle_tpu_torch.framework import params_from_jax
from paddle_tpu_torch.models import bert as tbert

CPU = "cpu"
SMALL = dict(vocab_size=100, max_len=32, d_model=32, d_inner=64, num_heads=4,
             num_layers=2, dropout=0.0, ce_chunk=32)
B, S, M = 2, 16, 5
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _feeds(n=1, seed=0):
    rng = np.random.RandomState(seed)
    feeds = []
    for _ in range(n):
        ids = rng.randint(3, 100, (B, S)).astype(np.int32)
        ids[1, -5:] = 0  # padding: the key bias masks it
        feeds.append({
            "input_ids": ids,
            "token_type_ids": (np.arange(S)[None, :] >= S // 2).repeat(B, 0).astype(np.int32),
            "mlm_positions": rng.randint(0, S - 5, (B, M)).astype(np.int32),
            "mlm_labels": rng.randint(0, 100, (B, M, 1)).astype(np.int64),
            "nsp_label": rng.randint(0, 2, (B, 1)).astype(np.int64)})
    return feeds


def _jittered(params, seed=1, scale=0.1):
    rng = np.random.RandomState(seed)
    out = {}
    for k in sorted(params):
        a = np.asarray(params[k])
        noisy = a.astype(np.float32) + scale * rng.randn(*a.shape).astype(np.float32)
        out[k] = np.asarray(jnp.asarray(noisy, a.dtype))
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def jax_params():
    prog = jpt.build(jbert.make_pretrain_model(jbert.base_config(**SMALL, fuse_qkv=True)))
    params, _ = prog.init(jax.random.PRNGKey(0), **_feeds()[0])
    return _jittered(params)


@pytest.mark.parametrize("fused_ce", [True, False])
def test_f32_losses_and_every_grad_match_jax(jax_params, fused_ce):
    cfg = dict(SMALL, fuse_qkv=True, use_flash=True, fused_ce=fused_ce)
    feed = _feeds()[0]
    jprog = jpt.build(jbert.make_pretrain_model(jbert.base_config(**cfg)))
    _, state = jprog.init(jax.random.PRNGKey(0), **feed)
    jp = {k: jnp.asarray(v) for k, v in jax_params.items()}
    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        lambda p: (lambda o: (o["loss"], o))(
            jprog.apply(p, state, **feed, training=True)[0]), has_aux=True))(jp)

    prog = tpt.build(tbert.make_pretrain_model(tbert.base_config(**cfg)))
    tparams, _ = prog.init(0, place=CPU, **feed)
    assert sorted(tparams) == sorted(jax_params)
    tp = params_from_jax(jax_params, device=CPU)
    for v in tp.values():
        v.requires_grad_(True)
    out, _ = prog.apply(tp, {}, **feed, training=True, rng=0, place=CPU)
    out["loss"].backward()
    for k in ("loss", "mlm_loss", "nsp_loss"):
        np.testing.assert_allclose(float(out[k]), float(jout[k]), rtol=TOL["float32"],
                                   err_msg=k)
    top = max(float(np.abs(_np(g)).max()) for g in jgrads.values())
    for k, g in jgrads.items():
        g = _np(g)
        scale = top if k.endswith("k_proj/b") else float(np.abs(g).max())
        err = float(np.abs(_np(tp[k].grad) - g).max()) / max(scale, 1e-30)
        assert err <= TOL["float32"], (k, err)


def test_param_dtypes_in_a_bf16_config():
    """The tables, ``pos_table``, the layer norms and the MLM head in
    ``dtype``; the attention, FFN and fc weights in f32."""
    cfg = dict(SMALL, fuse_qkv=True, dtype="bfloat16")
    feed = _feeds()[0]
    with jamp("bfloat16"):
        want, _ = jpt.build(jbert.make_pretrain_model(jbert.base_config(**cfg))).init(
            jax.random.PRNGKey(0), **feed)
    with tamp("bfloat16"):
        got, _ = tpt.build(tbert.make_pretrain_model(tbert.base_config(**cfg))).init(
            0, place=CPU, **feed)
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert tuple(got[k].shape) == a.shape, k
        assert str(got[k].dtype).replace("torch.", "") == str(a.dtype), k
    for k in ("word/embedding_0/w", "pos/pos_table_0/w", "mlm_out_0/w", "mlm_out_0/b",
              "layer_norm_0/scale"):
        assert got[k].dtype == torch.bfloat16, k
    assert got["encoder/mha_0/qkv_proj/w"].dtype == torch.float32
    assert got["pooler/w"].dtype == torch.float32


def test_two_adamw_steps_match_jax(jax_params):
    cfg = dict(SMALL, fuse_qkv=True, fused_ce=True)
    feeds = _feeds(2, seed=3)
    jtrainer = jpt.Trainer(jpt.build(jbert.make_pretrain_model(jbert.base_config(**cfg))),
                           jopt.AdamW(1e-4, weight_decay=0.01), loss_name="loss",
                           fetch_list=["loss"])
    jtrainer.startup(sample_feed=feeds[0])
    jtrainer.scope.params = {k: jnp.asarray(v) for k, v in jax_params.items()}
    jlosses = [float(jtrainer.step(f)["loss"]) for f in feeds]
    trainer = tpt.Trainer(tpt.build(tbert.make_pretrain_model(tbert.base_config(**cfg))),
                          topt.AdamW(1e-4, weight_decay=0.01), fetch_list=["loss"],
                          place=CPU)
    trainer.startup(sample_feed=feeds[0], params=params_from_jax(jax_params, device=CPU))
    losses = [float(trainer.step(f)["loss"]) for f in feeds]
    np.testing.assert_allclose(losses, jlosses, rtol=TOL["float32"])


def test_dropout_trains_and_eval_is_deterministic(jax_params):
    """At ``BertConfig``'s dropout 0.1 a step draws masks; eval draws
    none (two evals agree bit for bit) and takes the flash path."""
    cfg = tbert.base_config(**dict(SMALL, fuse_qkv=True, use_flash=True, dropout=0.1))
    feed = _feeds()[0]
    trainer = tpt.Trainer(tpt.build(tbert.make_pretrain_model(cfg)),
                          topt.AdamW(1e-4, weight_decay=0.01), place=CPU)
    trainer.startup(sample_feed=feed, params=params_from_jax(jax_params, device=CPU))
    e1, e2 = trainer.eval(feed), trainer.eval(feed)
    assert torch.equal(e1["loss"], e2["loss"])
    step = trainer.step(feed)
    assert torch.isfinite(step["loss"]) and float(step["loss"]) != float(e1["loss"])
