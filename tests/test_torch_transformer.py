"""The Transformer slice of the port against ``paddle_tpu`` on the CPU: a
small encoder-decoder (vocab 100, d_model 32, d_inner 64, 4 heads, 2+2
layers, seq 12, batch 2, pad ids 0 in the sources and the labels) is
initialised in ``paddle_tpu``, its params jittered from a numpy seed (so
norms and biases are not constants) and carried across with
``params_from_jax``. Where the JAX model reaches its flash kernels
(``use_flash``) they run in interpret mode; the port runs their plain
versions (``place="cpu"``).

Tolerances: f32 — the loss rel 1e-5, every grad within 1e-5·max|g| of
its param (the same f32 arithmetic summed in another order); a key
projection's bias has a grad of 0 in exact arithmetic (a row's softmax
is invariant to it), so it is held within 1e-5 of the model's largest
grad. bf16 compute and config — the loss rel 2e-2 (both round every op's
output to bf16). Three Adam(1e-3) steps' losses rel 1e-5. The flash eval
against the dense eval within 1e-5. Greedy ids exactly.
"""

import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as jpt
from paddle_tpu import optimizer as jopt
from paddle_tpu.core import flops as jflops
from paddle_tpu.framework import amp_guard as jamp
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import transformer as jtr

import paddle_tpu_torch as tpt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import flops as tflops
from paddle_tpu_torch.core.errors import EnforceError
from paddle_tpu_torch.framework import amp_guard as tamp
from paddle_tpu_torch.framework import params_from_jax
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.ops import flash_attention as tfa

CPU = "cpu"
SMALL = dict(src_vocab=100, trg_vocab=100, max_len=16, d_model=32, d_inner=64,
             num_heads=4, num_encoder_layers=2, num_decoder_layers=2, dropout=0.0,
             ce_chunk=32)
B, S = 2, 12
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _feeds(n=1, seed=0):
    rng = np.random.RandomState(seed)
    feeds = []
    for _ in range(n):
        src = rng.randint(3, 100, (B, S)).astype(np.int32)
        src[0, -3:] = 0  # padding: the key bias masks it
        trg = rng.randint(3, 100, (B, S)).astype(np.int32)
        labels = rng.randint(3, 100, (B, S)).astype(np.int32)
        labels[1, -4:] = 0  # padding: out of the loss and the count
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


def _jax_params(fuse_qkv, dtype="float32"):
    """Jittered JAX-initialised params of the small model (one init per
    layout and dtype)."""
    key = (fuse_qkv, dtype)
    if key not in _PARAMS:
        with jamp(dtype):
            prog = jpt.build(jtr.make_model(jtr.base_config(
                **SMALL, fuse_qkv=fuse_qkv, dtype=dtype)))
            params, _ = prog.init(jax.random.PRNGKey(0), **_feeds()[0])
        _PARAMS[key] = _jittered(params)
    return _PARAMS[key]


def _port_loss_and_grads(cfg, params, feed, dtype="float32", training=True):
    prog = tpt.build(ttr.make_model(cfg))
    tp = params_from_jax(params, device=CPU)
    for v in tp.values():
        v.requires_grad_(True)
    with tamp(dtype):
        out, _ = prog.apply(tp, {}, **feed, training=training, rng=0, place=CPU)
    out["loss"].backward()
    return out, {k: v.grad for k, v in tp.items()}


def _check_grads(tgrads, jgrads, tol):
    assert sorted(tgrads) == sorted(jgrads)
    top = max(float(np.abs(_np(g)).max()) for g in jgrads.values())
    for k, g in jgrads.items():
        g = _np(g)
        assert tgrads[k] is not None, k
        scale = top if k.endswith("k_proj/b") else float(np.abs(g).max())
        err = float(np.abs(_np(tgrads[k]) - g).max()) / max(scale, 1e-30)
        assert err <= tol, (k, err)


@pytest.mark.parametrize("fuse_qkv,use_flash,fused_ce",
                         list(itertools.product([False, True], repeat=3)))
def test_f32_loss_and_every_grad_match_jax(fuse_qkv, use_flash, fused_ce):
    cfg = dict(SMALL, fuse_qkv=fuse_qkv, use_flash=use_flash, fused_ce=fused_ce)
    params = _jax_params(fuse_qkv)
    feed = _feeds()[0]
    jprog = jpt.build(jtr.make_model(jtr.base_config(**cfg)))
    _, state = jprog.init(jax.random.PRNGKey(0), **feed)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(
        lambda p: (lambda o: (o["loss"], o))(
            jprog.apply(p, state, **feed, training=True)[0]), has_aux=True))(jp)
    out, grads = _port_loss_and_grads(ttr.base_config(**cfg), params, feed)
    np.testing.assert_allclose(float(out["loss"]), float(jloss), rtol=TOL["float32"])
    assert float(out["token_count"]) == float(jout["token_count"]) == B * S - 4
    assert ("logits" in out) == (not fused_ce)
    _check_grads(grads, jgrads, TOL["float32"])


@pytest.mark.parametrize("fuse_qkv", [False, True])
def test_param_names_shapes_and_dtypes_are_program_init_s(fuse_qkv):
    """In a bf16 config the embedding tables, the layer norms (created in
    their input's dtype) and ``logits_proj`` are bf16; the attention and
    FFN weights stay f32."""
    feed = _feeds()[0]
    cfg = dict(SMALL, fuse_qkv=fuse_qkv, dtype="bfloat16")
    params = _jax_params(fuse_qkv, "bfloat16")
    with tamp("bfloat16"):
        tparams, _ = tpt.build(ttr.make_model(ttr.base_config(**cfg))).init(
            0, place=CPU, **feed)
    assert sorted(tparams) == sorted(params)
    for k, a in params.items():
        assert tuple(tparams[k].shape) == a.shape, k
        assert str(tparams[k].dtype).replace("torch.", "") == str(a.dtype), k
    assert params["src/embedding_0/w"].dtype == params["logits_proj_0/w"].dtype \
        == params["encoder/layer_norm_0/scale"].dtype == jnp.bfloat16
    proj = "qkv_proj" if fuse_qkv else "q_proj"
    assert params[f"encoder/mha_0/{proj}/w"].dtype == np.float32
    assert ("decoder/mha_3/kv_proj/w" in params) == fuse_qkv


def test_bf16_loss_matches_jax():
    cfg = dict(SMALL, fuse_qkv=True, use_flash=True, fused_ce=True, dtype="bfloat16")
    params = _jax_params(True, "bfloat16")
    feed = _feeds()[0]
    with jamp("bfloat16"):
        jprog = jpt.build(jtr.make_model(jtr.base_config(**cfg)))
        _, state = jprog.init(jax.random.PRNGKey(0), **feed)
        jout, _ = jprog.apply({k: jnp.asarray(v) for k, v in params.items()}, state,
                              **feed, training=True)
    out, grads = _port_loss_and_grads(ttr.base_config(**cfg), params, feed, "bfloat16")
    np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]),
                               rtol=TOL["bfloat16"])
    assert grads["src/embedding_0/w"].dtype == torch.bfloat16
    assert all(torch.isfinite(g.float()).all() for g in grads.values())


def test_three_adam_steps_match_jax():
    cfg = dict(SMALL, fuse_qkv=True, fused_ce=True)
    feeds = _feeds(1, seed=4) * 3
    params = _jax_params(True)
    jtrainer = jpt.Trainer(jpt.build(jtr.make_model(jtr.base_config(**cfg))),
                           jopt.Adam(1e-3), loss_name="loss", fetch_list=["loss"])
    jtrainer.startup(sample_feed=feeds[0])
    jtrainer.scope.params = {k: jnp.asarray(v) for k, v in params.items()}
    jlosses = [float(jtrainer.step(f)["loss"]) for f in feeds]
    trainer = tpt.Trainer(tpt.build(ttr.make_model(ttr.base_config(**cfg))),
                          topt.Adam(1e-3), fetch_list=["loss"], place=CPU)
    trainer.startup(sample_feed=feeds[0], params=params_from_jax(params, device=CPU))
    losses = [float(trainer.step(f)["loss"]) for f in feeds]
    np.testing.assert_allclose(losses, jlosses, rtol=TOL["float32"])
    assert losses[-1] < losses[0]


def test_eval_with_flash_matches_the_dense_eval(monkeypatch):
    """``Trainer.eval`` of a ``use_flash`` model (at dropout 0.1: eval
    takes the kernel) against the dense model on the same params; the
    flash path runs 2 encoder attentions with the padding key bias and 2
    causal decoder self-attentions, the cross-attention stays dense."""
    calls = []
    plain = tfa.flash_attention_reference
    monkeypatch.setattr(tfa, "flash_attention_reference",
                        lambda q, k, v, causal=False, key_bias=None, *a: calls.append(
                            (causal, key_bias is not None)) or plain(q, k, v, causal,
                                                                     key_bias, *a))
    params = params_from_jax(_jax_params(True), device=CPU)
    feed = _feeds()[0]
    outs = {}
    for use_flash in (True, False):
        cfg = ttr.base_config(**dict(SMALL, fuse_qkv=True, use_flash=use_flash,
                                     dropout=0.1))
        trainer = tpt.Trainer(tpt.build(ttr.make_model(cfg)), topt.Adam(1e-3),
                              place=CPU)
        trainer.startup(sample_feed=feed, params=params)
        calls.clear()
        outs[use_flash] = trainer.eval(feed)
        assert calls == ([(False, True)] * 2 + [(True, False)] * 2 if use_flash else [])
    np.testing.assert_allclose(float(outs[True]["loss"]), float(outs[False]["loss"]),
                               rtol=TOL["float32"])
    np.testing.assert_allclose(_np(outs[True]["logits"]), _np(outs[False]["logits"]),
                               rtol=0, atol=TOL["float32"] * float(
                                   np.abs(_np(outs[False]["logits"])).max()))


def test_dropout_trains_and_remat_replays_its_masks():
    """At dropout 0.1 training draws masks (the loss moves off the eval
    loss) and a per-layer recompute draws its forward's masks: the grads
    with and without remat are equal, bit for bit."""
    params = params_from_jax(_jax_params(False), device=CPU)
    feed = _feeds()[0]
    grads, losses = {}, {}
    for remat in (False, True):
        cfg = ttr.base_config(**dict(SMALL, dropout=0.1, remat=remat))
        trainer = tpt.Trainer(tpt.build(ttr.make_model(cfg)), topt.Adam(1e-3),
                              place=CPU)
        trainer.startup(sample_feed=feed, params=params)
        losses[remat] = float(trainer.step(feed)["loss"])
        grads[remat] = {k: p.grad.clone() for k, p in trainer.scope.params.items()}
    assert losses[True] == losses[False]
    for k in grads[False]:
        assert torch.equal(grads[True][k], grads[False][k]), k
    trainer.global_step = 0
    assert abs(float(trainer.eval(feed)["loss"]) - losses[False]) > 1e-4


def test_bf16_checkpoint_keeps_each_param_dtype(tmp_path):
    """``save_trainer``/``load_trainer`` of a bf16 Transformer: the bf16
    tables, norms and ``logits_proj`` and the f32 attention weights come
    back in their own dtypes, bit for bit, with the f32 Adam moments."""
    cfg = ttr.base_config(**dict(SMALL, fuse_qkv=True, fused_ce=True, dtype="bfloat16"))
    feed = _feeds()[0]

    def trainer():
        tr = tpt.Trainer(tpt.build(ttr.make_model(cfg)), topt.Adam(1e-3), place=CPU)
        return tr.startup(sample_feed=feed)

    with tamp("bfloat16"):
        saved = trainer()
        saved.step(feed)
        tio.save_trainer(str(tmp_path / "ckpt"), saved)
        loaded = trainer()
        tio.load_trainer(str(tmp_path / "ckpt"), loaded)
    dtypes = {str(p.dtype) for p in loaded.scope.params.values()}
    assert dtypes == {"torch.bfloat16", "torch.float32"}
    for k, p in saved.scope.params.items():
        q = loaded.scope.params[k]
        assert q.dtype == p.dtype and torch.equal(q.detach(), p.detach()), k
    m1 = loaded.scope.opt_state["accums"]["src/embedding_0/w"]["moment1"]
    assert m1.dtype == torch.float32
    assert torch.equal(m1, saved.scope.opt_state["accums"]["src/embedding_0/w"]["moment1"])


def test_stacked_config_is_not_ported():
    """The stacked form trains (tests/test_torch_stacked_transformer.py)
    but has no incremental decoder, as in the JAX package
    (transformer.py:177-179): ``make_decoder`` refuses it."""
    with pytest.raises(EnforceError, match="per-layer param layout only"):
        ttr.make_decoder(ttr.base_config(**SMALL, stacked=True), 4)
    assert callable(ttr.make_model(ttr.base_config(**SMALL, stacked=True)))


# -- make_decoder --------------------------------------------------------------


def _src(seed=3):
    src = np.random.RandomState(seed).randint(3, 100, (3, 9)).astype(np.int32)
    src[1, -2:] = 0
    return src


@pytest.mark.parametrize("fuse_qkv", [False, True])
def test_greedy_decoder_ids_match_jax(fuse_qkv):
    """The decoder serves ``make_model``'s params (the names are shared):
    the same greedy ids as the JAX decoder, f32."""
    cfg = dict(SMALL, fuse_qkv=fuse_qkv, use_flash=True)
    params = _jax_params(fuse_qkv)
    src = _src()
    jprog = jpt.build(jtr.make_decoder(jtr.base_config(**cfg), max_len=8))
    jparams, state = jprog.init(jax.random.PRNGKey(0), src)
    assert sorted(jparams) == sorted(params)
    want, _ = jprog.apply({k: jnp.asarray(v) for k, v in params.items()}, state, src)
    prog = tpt.build(ttr.make_decoder(ttr.base_config(**cfg), max_len=8))
    tparams, _ = prog.init(0, place=CPU, src_ids=src)
    assert sorted(tparams) == sorted(params)
    got, _ = prog.apply(params_from_jax(params, device=CPU), {}, src_ids=src, place=CPU)
    assert got["ids"].dtype == torch.int32 and got["ids"].shape == (3, 8)
    np.testing.assert_array_equal(got["ids"].numpy(), np.asarray(want["ids"]))


@pytest.mark.parametrize("fuse_qkv,alpha", [(False, 0.0), (True, 0.6)])
def test_beam_search_decoder_is_not_ported(fuse_qkv, alpha):
    """Beam search in the decoder (it raised NotYetPorted before it was
    ported, hence the name): ``make_decoder(beam_size=2)`` gives the JAX
    decoder's ids exactly and its scores within 1e-5, f32 at dropout 0,
    with and without the length penalty."""
    cfg = dict(SMALL, fuse_qkv=fuse_qkv, use_flash=True)
    params = _jax_params(fuse_qkv)
    src = _src()
    jprog = jpt.build(jtr.make_decoder(jtr.base_config(**cfg), max_len=8, beam_size=2,
                                       length_penalty_alpha=alpha))
    _, state = jprog.init(jax.random.PRNGKey(0), src)
    want, _ = jprog.apply({k: jnp.asarray(v) for k, v in params.items()}, state, src)
    prog = tpt.build(ttr.make_decoder(ttr.base_config(**cfg), max_len=8, beam_size=2,
                                      length_penalty_alpha=alpha))
    got, _ = prog.apply(params_from_jax(params, device=CPU), {}, src_ids=src, place=CPU)
    assert got["ids"].dtype == torch.int32 and got["ids"].shape == (3, 2, 8)
    np.testing.assert_array_equal(got["ids"].numpy(), np.asarray(want["ids"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               rtol=1e-5, atol=1e-5)
    assert len(set(np.asarray(want["ids"]).ravel().tolist())) > 2


def test_decoder_artifact_round_trips(tmp_path):
    """``save_inference_model`` of the decoder program with a model's
    params, ``load_inference_model`` on the CPU (rebuilt by its
    ``factory_spec``): the ids of the program run directly."""
    cfg = ttr.base_config(**dict(SMALL, fuse_qkv=True, use_flash=True))
    params = params_from_jax(_jax_params(True), device=CPU)
    src = _src()
    prog = tpt.build(ttr.make_decoder(cfg, max_len=6))
    want, _ = prog.apply(params, {}, src_ids=src, place=CPU)
    art = str(tmp_path / "decoder")
    tio.save_inference_model(art, prog, {k: v.numpy() for k, v in params.items()}, {},
                             {"src_ids": src}, batch_buckets=[1])
    pred = tio.load_inference_model(art, device=CPU)
    np.testing.assert_array_equal(pred.run({"src_ids": src})["ids"].numpy(),
                                  want["ids"].numpy())
    assert pred.run({"src_ids": src[:1]})["ids"].shape == (1, 6)


# -- core/flops ------------------------------------------------------------------


@pytest.mark.parametrize("model,bs,seq,extra", [("transformer", 32, 256, {}),
                                                ("transformer", 4, 4096,
                                                 {"max_len": 4096, "dropout": 0.0}),
                                                ("bert", 32, 128, {"max_len": 512})])
def test_train_flops_equal_the_jax_packages(model, bs, seq, extra):
    """bench.py's configs: bench_transformer, bench_transformer_long and
    bench_bert (20 masked positions)."""
    if model == "transformer":
        got = tflops.transformer_train_flops(bs, seq, ttr.base_config(**extra))
        want = jflops.transformer_train_flops(bs, seq, jtr.base_config(**extra))
    else:
        got = tflops.bert_train_flops(bs, seq, 20, tbert.base_config(**extra))
        want = jflops.bert_train_flops(bs, seq, 20, jbert.base_config(**extra))
    assert got == want > 0
