"""The stacked Transformer (``TransformerConfig(stacked=True)``,
``layers/stacked.py``'s ``encoder_stack_params``, ``decoder_stack_params``
and ``make_decoder_block``) against ``paddle_tpu`` on the CPU: a small
encoder-decoder (vocab 100, d_model 32, d_inner 64, 4 heads, 2+2 layers,
batch 2, source length 12 and target length 8, so the cross attention is
not square; pad ids 0 in the sources and the labels) is initialised in
``paddle_tpu``, its params jittered from a numpy seed and carried across
with ``params_from_jax``. Where the JAX model reaches its flash kernels
(``use_flash``) they run in interpret mode; the port runs their plain
versions (``place="cpu"``).

Tolerances, as tests/test_torch_transformer.py states them: f32 — the
loss rel 1e-5, every grad within 1e-5·max|g| of its param (the same f32
arithmetic summed in another order); a block's output within 1e-5 of its
largest value. Three Adam(1e-3) steps' losses rel 1e-5. Dropout is held
by its effect (training moves the loss off the eval loss) and by
replays: a remat recompute and a captured step draw the same masks, bit
for bit.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as jpt
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework import amp_guard as jamp
from paddle_tpu.layers import stacked as jS
from paddle_tpu.models import transformer as jtr

import paddle_tpu_torch as tpt
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.data import stack_batches
from paddle_tpu_torch.framework import amp_guard as tamp
from paddle_tpu_torch.framework import params_from_jax
from paddle_tpu_torch.layers import stacked as tS
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.ops import flash_attention as tfa

CPU = "cpu"
SMALL = dict(src_vocab=100, trg_vocab=100, max_len=16, d_model=32, d_inner=64,
             num_heads=4, num_encoder_layers=2, num_decoder_layers=2, dropout=0.0,
             ce_chunk=32, stacked=True)
B, S, T = 2, 12, 8
TOL = 1e-5


def _feeds(n=1, seed=0):
    rng = np.random.RandomState(seed)
    feeds = []
    for _ in range(n):
        src = rng.randint(3, 100, (B, S)).astype(np.int32)
        src[0, -3:] = 0  # padding: the key bias masks it, in both attentions
        trg = rng.randint(3, 100, (B, T)).astype(np.int32)
        labels = rng.randint(3, 100, (B, T)).astype(np.int32)
        labels[1, -2:] = 0  # padding: out of the loss and the count
        feeds.append({"src_ids": src, "trg_ids": trg, "labels": labels})
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


_PARAMS = {}


def _jax_params(dtype="float32"):
    if dtype not in _PARAMS:
        with jamp(dtype):
            prog = jpt.build(jtr.make_model(jtr.base_config(**SMALL, dtype=dtype)))
            params, _ = prog.init(jax.random.PRNGKey(0), **_feeds()[0])
        _PARAMS[dtype] = _jittered(params)
    return _PARAMS[dtype]


def _check_grads(tgrads, jgrads):
    assert sorted(tgrads) == sorted(jgrads)
    for k, g in jgrads.items():
        g = _np(g)
        assert tgrads[k] is not None, k
        err = float(np.abs(_np(tgrads[k]) - g).max()) / max(float(np.abs(g).max()), 1e-30)
        assert err <= TOL, (k, err)


@pytest.mark.parametrize("use_flash,fused_ce", [(False, False), (False, True),
                                                (True, False), (True, True)])
def test_stacked_f32_loss_and_every_grad_match_jax(use_flash, fused_ce):
    cfg = dict(SMALL, use_flash=use_flash, fused_ce=fused_ce)
    params = _jax_params()
    feed = _feeds()[0]
    jprog = jpt.build(jtr.make_model(jtr.base_config(**cfg)))
    _, state = jprog.init(jax.random.PRNGKey(0), **feed)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(
        lambda p: (lambda o: (o["loss"], o))(
            jprog.apply(p, state, **feed, training=True)[0]), has_aux=True))(jp)
    prog = tpt.build(ttr.make_model(ttr.base_config(**cfg)))
    tp = params_from_jax(params, device=CPU)
    for v in tp.values():
        v.requires_grad_(True)
    out, _ = prog.apply(tp, {}, **feed, training=True, rng=0, place=CPU)
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"]), float(jloss), rtol=TOL)
    assert float(out["token_count"]) == float(jout["token_count"]) == B * T - 2
    _check_grads({k: v.grad for k, v in tp.items()}, jgrads)


def test_stacked_param_names_shapes_and_dtypes_are_program_init_s():
    """The stacks sit under ``encoder/encoder_stack`` and
    ``decoder/decoder_stack``, in f32 in a bf16 config (the embeddings,
    layer norms and ``logits_proj`` follow the config, as unstacked)."""
    feed = _feeds()[0]
    params = _jax_params("bfloat16")
    with tamp("bfloat16"):
        tparams, _ = tpt.build(ttr.make_model(ttr.base_config(**SMALL, dtype="bfloat16"))) \
            .init(0, place=CPU, **feed)
    assert sorted(tparams) == sorted(params)
    for k, a in params.items():
        assert tuple(tparams[k].shape) == a.shape, k
        assert str(tparams[k].dtype).replace("torch.", "") == str(a.dtype), k
    L, d = SMALL["num_decoder_layers"], SMALL["d_model"]
    assert params["decoder/decoder_stack/xkv/w"].shape == (L, d, 2, d)
    assert params["decoder/decoder_stack/xkv/b"].shape == (L, 2, d)
    assert params["encoder/encoder_stack/qkv/w"].dtype == np.float32
    assert "encoder/encoder_stack/xq/w" not in params


@pytest.mark.parametrize("use_flash", [False, True])
def test_decoder_block_matches_jax(use_flash):
    """``make_decoder_block`` alone on one layer's params: self-attention,
    the cross attention over a longer source with padded keys, the FFN."""
    r = np.random.RandomState(7)
    d, h = 32, 4
    shapes = dict(tS.encoder_stack_shapes(1, d, 64), **{
        "lnx/scale": (1, d), "lnx/bias": (1, d), "xq/w": (1, d, d), "xq/b": (1, d),
        "xkv/w": (1, d, 2, d), "xkv/b": (1, 2, d), "xout/w": (1, d, d), "xout/b": (1, d)})
    shapes = {k: v[1:] for k, v in shapes.items()}
    lp = {k: (0.2 * r.randn(*s)).astype(np.float32) for k, s in sorted(shapes.items())}
    for k in ("ln1/scale", "ln2/scale", "lnx/scale"):
        lp[k] += 1.0
    x = r.randn(B, T, d).astype(np.float32)
    enc = r.randn(B, S, d).astype(np.float32)
    bias = np.zeros((B, S), np.float32)
    bias[1, -4:] = -1e9
    want = jS.make_decoder_block(h, use_flash=use_flash)(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in lp.items()},
        {"enc": jnp.asarray(enc), "enc_bias": jnp.asarray(bias)})
    got = tS.make_decoder_block(h, use_flash=use_flash)(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in lp.items()},
        {"enc": torch.from_numpy(enc), "enc_bias": torch.from_numpy(bias)})
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * np.abs(want).max())


def test_stacked_three_adam_steps_match_jax():
    cfg = dict(SMALL, use_flash=True, fused_ce=True)
    feeds = _feeds(3, seed=4)
    params = _jax_params()
    jtrainer = jpt.Trainer(jpt.build(jtr.make_model(jtr.base_config(**cfg))),
                           jopt.Adam(1e-3), loss_name="loss", fetch_list=["loss"])
    jtrainer.startup(sample_feed=feeds[0])
    jtrainer.scope.params = {k: jnp.asarray(v) for k, v in params.items()}
    jlosses = [float(jtrainer.step(f)["loss"]) for f in feeds]
    trainer = tpt.Trainer(tpt.build(ttr.make_model(ttr.base_config(**cfg))),
                          topt.Adam(1e-3), fetch_list=["loss"], place=CPU)
    trainer.startup(sample_feed=feeds[0], params=params_from_jax(params, device=CPU))
    losses = [float(trainer.step(f)["loss"]) for f in feeds]
    np.testing.assert_allclose(losses, jlosses, rtol=TOL)


def test_stacked_flash_calls_at_dropout_0(monkeypatch):
    """At dropout 0 (``transformer_long``'s setting) every attention of
    the stacked model takes the flash path: per layer the encoder's
    self-attention under the source's key bias, the decoder's causal
    self-attention, and the cross attention — [T] queries over [S] keys,
    non-causal, under the key bias — which the unrolled decoder runs
    dense."""
    calls = []
    plain = tfa.flash_attention_reference
    monkeypatch.setattr(tfa, "flash_attention_reference",
                        lambda q, k, v, causal=False, key_bias=None, *a: calls.append(
                            (q.shape[2], k.shape[2], causal, key_bias is not None))
                        or plain(q, k, v, causal, key_bias, *a))
    feed = _feeds()[0]
    cfg = ttr.base_config(**dict(SMALL, use_flash=True, fused_ce=True))
    trainer = tpt.Trainer(tpt.build(ttr.make_model(cfg)), topt.Adam(1e-3), place=CPU)
    trainer.startup(sample_feed=feed, params=params_from_jax(_jax_params(), device=CPU))
    calls.clear()
    trainer.step(feed)
    L = SMALL["num_encoder_layers"]
    assert calls == [(S, S, False, True)] * L + [(T, T, True, False), (T, S, False, True)] * L


def test_stacked_dropout_trains_and_replays_its_masks():
    """At dropout 0.1: training draws masks (the loss moves off the eval
    loss), a per-layer recompute draws its forward's masks (the grads
    with and without remat bit-equal), and K steps of ``run_steps`` (the
    body a card captures) equal K ``step()`` calls bit for bit."""
    feeds = _feeds(3, seed=2)
    params = params_from_jax(_jax_params(), device=CPU)

    def make(remat=False):
        cfg = ttr.base_config(**dict(SMALL, dropout=0.1, remat=remat, use_flash=True))
        tr = tpt.Trainer(tpt.build(ttr.make_model(cfg)), topt.Adam(1e-3),
                         fetch_list=["loss"], place=CPU)
        return tr.startup(sample_feed=feeds[0], params=params)

    grads, losses = {}, {}
    for remat in (False, True):
        tr = make(remat)
        losses[remat] = float(tr.step(feeds[0])["loss"])
        grads[remat] = {k: p.grad.clone() for k, p in tr.scope.params.items()}
    assert losses[True] == losses[False] and np.isfinite(losses[False])
    assert all(torch.equal(grads[True][k], grads[False][k]) for k in grads[False])
    assert float(make().eval(feeds[0])["loss"]) != losses[False]
    seq, fused = make(), make()
    want = torch.stack([seq.step(f)["loss"] for f in feeds])
    got = fused.run_steps(stack_batches(feeds))["loss"]
    assert torch.equal(got, want)
    for k, p in seq.scope.params.items():
        assert torch.equal(p, fused.scope.params[k]), k
