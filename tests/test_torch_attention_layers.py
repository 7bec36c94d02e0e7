"""The sequence-model layers of the port against ``paddle_tpu`` on the CPU:
``dropout``, the ``LayerHelper`` forms of ``embedding`` and
``layer_norm``, ``matmul`` and ``mul``, ``scores_mxu``'s backward, and
``scaled_dot_product_attention``, ``multi_head_attention`` and ``ffn``
(self, cross, fused, cached), on the same numpy inputs (from a seed)
and the same params (``Program.init`` in ``paddle_tpu``, jittered so
biases and norms are not constants, carried across with
``params_from_jax``). Where the JAX layer reaches its flash kernel
(``use_flash``) it runs in interpret mode, as its own tests run it; the
port runs the kernel's plain version.

Tolerances, on the scale of the reference (``max|a − b| / max|b|``):

- f32 outputs within 1e-5; grads within 1e-5·max|g| of each param (the
  same f32 arithmetic summed in another order). A key projection's bias
  gets a grad of 0 in exact arithmetic (the softmax of a row is
  invariant to it), so both sides hold rounding noise there: it is held
  within 1e-5 of the largest grad of the layer;
- bf16 outputs and grads within 2e-2 (both round every op's output to
  bf16, from f32 values that may differ in the last bits);
- ``scores_mxu``'s bf16 backward within one bf16 ulp of the JAX
  package's custom VJP (2⁻⁷ of max|grad|);
- dropout by its statistics (threefry and Philox cannot draw the same
  bits): the keep rate of 10⁵ draws within 4σ, the scaling exact.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as jpt
from paddle_tpu import layers as jL
from paddle_tpu.framework import amp_guard as jamp
from paddle_tpu.layers import attention as jA
from paddle_tpu.ops import attention_scores as jscores

import paddle_tpu_torch as tpt
from paddle_tpu_torch import layers as tL
from paddle_tpu_torch import nets as tnets
from paddle_tpu_torch.core.errors import EnforceError
from paddle_tpu_torch.framework import amp_guard as tamp
from paddle_tpu_torch.framework import params_from_jax
from paddle_tpu_torch.layers import attention as tA
from paddle_tpu_torch.ops import attention_scores as tscores
from paddle_tpu_torch.ops import flash_attention as tfa

CPU = "cpu"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _cast(x, dtype):
    """x (a torch tensor or a JAX/numpy array) in ``dtype``."""
    if isinstance(x, torch.Tensor):
        return x.to(getattr(torch, dtype))
    return x.astype(dtype)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b), initial=0.0)) / max(float(np.abs(b).max()), 1e-30)


def _jittered(params, seed=1, scale=0.1):
    rng = np.random.RandomState(seed)
    out = {}
    for k in sorted(params):
        a = np.asarray(params[k])
        noisy = a.astype(np.float32) + scale * rng.randn(*a.shape).astype(np.float32)
        out[k] = np.asarray(jnp.asarray(noisy, a.dtype))
    return out


def _cts(outs, seed=7):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*np.shape(outs[k])).astype(np.float32) for k in sorted(outs)}


def _pair(jfn, tfn, feed, dtype="float32", training=False, grads=True):
    """Build both programs under compute dtype ``dtype``, init in
    ``paddle_tpu``, jitter and carry the params, run both on ``feed``.
    Returns (params, JAX outputs, port outputs, JAX grads, port grads),
    the grads of ``Σ out·ct`` (``ct`` random, seeded) over the params."""
    with jamp(dtype):
        jprog = jpt.build(jfn)
        params, state = jprog.init(jax.random.PRNGKey(0), **feed)
        params = _jittered(params)
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        jout, _ = jprog.apply(jp, state, **feed, training=training)
        cts = _cts(jout)

        def objective(p):
            out, _ = jprog.apply(p, state, **feed, training=training)
            return sum(jnp.sum(out[k].astype(jnp.float32) * cts[k]) for k in cts)

        jgrads = jax.grad(objective)(jp) if grads else {}
    tprog = tpt.build(tfn)
    tp = params_from_jax(params, device=CPU)
    for v in tp.values():
        v.requires_grad_(grads)
    tstate = params_from_jax({k: np.asarray(v) for k, v in state.items()}, device=CPU)
    with tamp(dtype):
        tout, _ = tprog.apply(tp, tstate, **feed, training=training, place=CPU)
    tgrads = {}
    if grads:
        sum((tout[k].float() * torch.from_numpy(cts[k])).sum() for k in cts).backward()
        tgrads = {k: v.grad for k, v in tp.items()}
    return params, jout, tout, jgrads, tgrads


def _check_grads(tgrads, jgrads, tol):
    assert sorted(tgrads) == sorted(jgrads)
    top = max(float(np.abs(_np(g)).max()) for g in jgrads.values())
    for k, g in jgrads.items():
        g = _np(g)
        assert tgrads[k] is not None, k
        scale = top if k.endswith("k_proj/b") else float(np.abs(g).max())
        err = float(np.abs(_np(tgrads[k]) - g).max()) / max(scale, 1e-30)
        assert err <= tol, (k, err)


# -- F3: the routing rule reads in_training() ---------------------------------


def test_flash_routing_reads_the_programs_training_mode(monkeypatch):
    """Inside a training program, attention with ``use_flash=True`` and
    dropout 0.1 takes the dense path (with dropout), as the JAX package's
    rule ``use_flash and (dropout_rate == 0 or not in_training())`` does;
    at eval the same program takes the flash kernel (here its plain
    version). The caller passes no ``training``."""
    calls = []
    plain = tfa.flash_attention_reference
    monkeypatch.setattr(tfa, "flash_attention_reference",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    q = np.random.RandomState(0).randn(2, 2, 8, 16).astype(np.float32)

    def net(q):
        return {"o": tA.scaled_dot_product_attention(q, q, q, use_flash=True,
                                                     dropout_rate=0.1)}

    prog = tpt.build(net)
    train, _ = prog.apply({}, {}, q=q, training=True, rng=3, place=CPU)
    assert calls == []
    evald, _ = prog.apply({}, {}, q=q, training=False, place=CPU)
    assert calls == [1]
    # the dropped probabilities moved the training output off the eval one
    assert _rel(train["o"], evald["o"]) > 1e-3
    # the same rule in the JAX package: dense with dropout in training
    jprog = jpt.build(lambda q: {"o": jA.scaled_dot_product_attention(
        q, q, q, use_flash=True, dropout_rate=0.1)})
    jtrain, _ = jprog.apply({}, {}, q=q, training=True, rng=jax.random.PRNGKey(3))
    jeval, _ = jprog.apply({}, {}, q=q, training=False)
    assert _rel(jtrain["o"], jeval["o"]) > 1e-3
    assert _rel(evald["o"], jeval["o"]) <= TOL["float32"]


# -- dropout ------------------------------------------------------------------


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_keep_rate_within_four_sigma(p):
    n = 100_000
    x = torch.ones(n)
    kept = int((tL.dropout(x, p, is_test=False, seed=11) != 0).sum())
    sigma = np.sqrt(n * p * (1 - p))
    assert abs(kept - n * (1 - p)) <= 4 * sigma, (kept, n * (1 - p), sigma)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_dropout_scaling_is_exact(impl, dtype):
    """Kept elements are x (downgrade_in_infer) or x / (1 − p)
    (upscale_in_train, the JAX package's division in x's dtype, bit for
    bit), dropped ones 0; at inference x·(1 − p) or x."""
    p = 0.3
    xn = np.random.RandomState(2).randn(4096).astype(np.float32) + 3.0
    jx = jnp.asarray(xn, dtype)
    x = torch.from_numpy(xn).to(getattr(torch, dtype))
    y = tL.dropout(x, p, is_test=False, seed=5, dropout_implementation=impl)
    keep = y != 0
    assert 0 < int(keep.sum()) < x.numel()
    want = jx / (1.0 - p) if impl == "upscale_in_train" else jx
    np.testing.assert_array_equal(_np(y)[keep.numpy()], _np(want)[keep.numpy()])
    inf = tL.dropout(x, p, is_test=True, dropout_implementation=impl)
    want_inf = jx * (1.0 - p) if impl == "downgrade_in_infer" else jx
    np.testing.assert_array_equal(_np(inf), _np(want_inf))
    assert inf.dtype == x.dtype == y.dtype
    jinf = jL.dropout(jx, p, is_test=True, dropout_implementation=impl)
    np.testing.assert_array_equal(_np(inf), _np(jinf))


def test_dropout_is_test_overrides_and_seed_reproduces():
    x = np.ones((64, 64), np.float32)

    def net(x):
        return {"train": tL.dropout(x, 0.5), "test": tL.dropout(x, 0.5, is_test=True),
                "forced": tL.dropout(x, 0.5, is_test=False, seed=9),
                "again": tL.dropout(x, 0.5, is_test=False, seed=9),
                "other": tL.dropout(x, 0.5, is_test=False, seed=10)}

    prog = tpt.build(net)
    out, _ = prog.apply({}, {}, x=x, training=True, rng=1, place=CPU)
    assert (out["train"] == 0).any()
    assert torch.equal(out["test"], torch.full((64, 64), 0.5))
    assert torch.equal(out["forced"], out["again"])
    assert not torch.equal(out["forced"], out["other"])
    # outside training is_test=False still drops; inference scales
    out, _ = prog.apply({}, {}, x=x, training=False, place=CPU)
    assert torch.equal(out["train"], torch.full((64, 64), 0.5))
    assert (out["forced"] == 0).any()


def test_dropout_masks_follow_the_program_rng():
    """The same rng gives the same masks, another rng other masks, and
    two dropouts in one run draw two masks (the per-run counter)."""
    x = np.ones((32, 32), np.float32)
    prog = tpt.build(lambda x: {"a": tL.dropout(x, 0.5), "b": tL.dropout(x, 0.5)})

    def run(rng):
        return prog.apply({}, {}, x=x, training=True, rng=rng, place=CPU)[0]

    one, same, other = run(4), run(4), run(5)
    assert torch.equal(one["a"], same["a"]) and torch.equal(one["b"], same["b"])
    assert not torch.equal(one["a"], one["b"])
    assert not torch.equal(one["a"], other["a"])
    with pytest.raises(EnforceError, match="needs an RNG"):
        prog.apply({}, {}, x=x, training=True, place=CPU)


def test_trainer_steps_draw_their_masks_from_the_step():
    """``Trainer.step`` derives each step's rng from the seed flag and its
    global step: two trainers at the same step draw the same masks, the
    next step draws others (SGD at rate 0 keeps the params, so only the
    masks move the loss)."""
    from paddle_tpu_torch import optimizer as topt

    x = np.random.RandomState(3).rand(16, 32).astype(np.float32) + 0.5

    def net(x):
        return {"loss": tL.mean(tL.fc(tL.dropout(x, 0.5), 8))}

    def trainer():
        return tpt.Trainer(tpt.build(net), topt.SGD(0.0), place=CPU).startup(0, {"x": x})

    a, b = trainer(), trainer()
    first = [float(t.step({"x": x})["loss"]) for t in (a, b)]
    second = float(a.step({"x": x})["loss"])
    assert first[0] == first[1] and second != first[0]
    assert float(a.eval({"x": x})["loss"]) == float(b.eval({"x": x})["loss"])


def test_nets_dropout_cases_run_against_jax_at_inference():
    """``img_conv_group``'s dropout after the batch norm and the attention
    dropout of ``nets.scaled_dot_product_attention``: at inference the
    outputs are the JAX package's (downgrade_in_infer scales by 1 − p),
    in training both draw masks."""
    from paddle_tpu import nets as jnets
    rng = np.random.RandomState(0)
    feed = {"image": rng.randn(2, 3, 8, 8).astype(np.float32),
            "q": rng.randn(2, 4, 8).astype(np.float32)}

    def make(nets):
        def net(image, q):
            return {"y": nets.img_conv_group(image, [4], 2, conv_with_batchnorm=True,
                                             conv_batchnorm_drop_rate=0.5),
                    "a": nets.scaled_dot_product_attention(q, q, q, num_heads=2,
                                                           dropout_rate=0.1)}
        return net

    _, jout, tout, _, _ = _pair(make(jnets), make(tnets), feed, grads=False)
    for k in jout:
        assert _rel(tout[k], jout[k]) <= TOL["float32"], k
    prog = tpt.build(make(tnets))
    params, state = prog.init(0, place=CPU, **feed)
    out, _ = prog.apply(params, state, training=True, rng=2, place=CPU, **feed)
    assert (out["y"] == 0).any() and torch.isfinite(out["a"]).all()


# -- embedding, layer_norm, matmul, mul ------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padding_idx", [None, 3, -1])
def test_embedding_matches_jax(dtype, padding_idx):
    """The table ``embedding_0/w`` in ``dtype``, the index rule (negative
    ids count from the end, ids outside the table give NaN rows), the
    trailing id dim of 1 dropped, the padding rows zeroed."""
    ids = np.array([[[0], [5], [-1], [49]], [[50], [3], [-50], [3]]], np.int32)

    def make(L):
        return lambda ids: {"e": L.embedding(ids, size=[50, 8], dtype=dtype,
                                             padding_idx=padding_idx)}

    params, jout, tout, _, _ = _pair(make(jL), make(tL), {"ids": ids}, dtype, grads=False)
    assert sorted(params) == ["embedding_0/w"] and params["embedding_0/w"].dtype == dtype
    assert str(tout["e"].dtype).replace("torch.", "") == str(jout["e"].dtype)
    np.testing.assert_array_equal(_np(tout["e"]), _np(jout["e"]))


def test_embedding_sparse_and_distributed_are_not_ported():
    """Ported since the DeepFM slice, as markers: ``is_distributed`` is
    recorded in the table's ``ParamInfo``, and the lookup stays the dense
    one (the parity with the JAX layer is in test_torch_deepfm.py)."""
    ids = np.array([[0, 4, 2], [1, 1, 3]], np.int32)
    plain = tpt.build(lambda ids: {"e": tL.embedding(ids, size=[5, 4])})
    params, _ = plain.init(0, place=CPU, ids=ids)
    want = plain.apply(params, {}, ids=ids, place=CPU)[0]["e"]
    for kw in ({"is_sparse": True}, {"is_distributed": True}):
        prog = tpt.build(lambda ids: {"e": tL.embedding(ids, size=[5, 4], **kw)})
        prog.init(0, place=CPU, ids=ids)
        info = prog.param_info["embedding_0/w"]
        assert info.is_distributed == kw.get("is_distributed", False)
        assert torch.equal(prog.apply(params, {}, ids=ids, place=CPU)[0]["e"], want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis,scale,shift,act", [(2, True, True, None),
                                                  (1, True, True, "relu"),
                                                  (2, False, True, None),
                                                  (2, True, False, None)])
def test_layer_norm_matches_jax(dtype, axis, scale, shift, act):
    """Params in the input's dtype, shaped as the normalised dims; f32
    statistics and affine map; output in the input's dtype; grads."""
    x = np.random.RandomState(3).randn(2, 5, 6).astype(np.float32) * 3 + 1

    def make(L):
        return lambda x: {"n": L.layer_norm(_cast(x, dtype), scale=scale, shift=shift,
                                            begin_norm_axis=axis, act=act)}

    params, jout, tout, jg, tg = _pair(make(jL), make(tL), {"x": x}, dtype)
    want = {"layer_norm_0/scale": scale, "layer_norm_0/bias": shift}
    assert sorted(params) == sorted(k for k, v in want.items() if v)
    for k, a in params.items():
        assert a.dtype == dtype and a.shape == x.shape[axis:], k
    assert str(tout["n"].dtype).replace("torch.", "") == str(jout["n"].dtype)
    tol = TOL[dtype] if dtype == "bfloat16" else 1e-6
    assert _rel(tout["n"], jout["n"]) <= tol
    if jg:
        _check_grads(tg, jg, TOL[dtype])


@pytest.mark.parametrize("tx,ty,alpha", [(False, False, 1.0), (True, False, 0.5),
                                         (False, True, 2.0), (True, True, 1.0)])
def test_matmul_and_mul_match_jax(tx, ty, alpha):
    rng = np.random.RandomState(4)
    a = rng.randn(3, 4, 5).astype(np.float32)
    b = rng.randn(3, 5, 6).astype(np.float32)
    a2 = np.swapaxes(a, -1, -2).copy() if tx else a
    b2 = np.swapaxes(b, -1, -2).copy() if ty else b
    got = tL.matmul(torch.from_numpy(a2), torch.from_numpy(b2), tx, ty, alpha)
    want = jL.matmul(jnp.asarray(a2), jnp.asarray(b2), tx, ty, alpha)
    assert _rel(got, want) <= TOL["float32"]
    for xs, ys, xd, yd in (((2, 3, 4, 5), (20, 7), 2, 1), ((2, 3, 4), (12, 5), 1, 1),
                           ((6, 4), (4, 2, 3), 1, 1)):
        x, y = rng.randn(*xs).astype(np.float32), rng.randn(*ys).astype(np.float32)
        got = tL.mul(torch.from_numpy(x), torch.from_numpy(y), xd, yd)
        want = jL.mul(jnp.asarray(x), jnp.asarray(y), xd, yd)
        assert got.shape == want.shape
        assert _rel(got, want) <= TOL["float32"]


# -- scores_mxu's backward --------------------------------------------------------


def test_scores_mxu_bf16_backward_matches_the_custom_vjp():
    """dq and dk of Σ scores·ct in bf16: the scaled cotangent rounded to
    bf16 before both products, as the JAX package's ``_scores_bwd``. The
    grads of autograd through the f32 forward round once, at the end,
    and land farther from the reference's."""
    rng = np.random.RandomState(5)
    qn, kn = (rng.randn(2, 3, 16, 32).astype(np.float32) for _ in range(2))
    ct = rng.randn(2, 3, 16, 16).astype(np.float32)
    scale = 32 ** -0.5
    jq, jk = jnp.asarray(qn, jnp.bfloat16), jnp.asarray(kn, jnp.bfloat16)
    jdq, jdk = jax.grad(lambda q, k: jnp.sum(jscores.scores_mxu(q, k, scale) * ct),
                        argnums=(0, 1))(jq, jk)
    q = torch.from_numpy(qn).bfloat16().requires_grad_(True)
    k = torch.from_numpy(kn).bfloat16().requires_grad_(True)
    s = tscores.scores_mxu(q, k, scale)
    assert s.dtype == torch.float32
    assert _rel(s, jscores.scores_mxu(jq, jk, scale)) <= 1e-6
    (s * torch.from_numpy(ct)).sum().backward()
    assert q.grad.dtype == k.grad.dtype == torch.bfloat16
    ulp = 2.0 ** -7
    assert _rel(q.grad, jdq) <= ulp and _rel(k.grad, jdk) <= ulp
    # autograd of the f32 forward: the f32 cotangent times the widened operands
    q32 = q.detach().float().requires_grad_(True)
    k32 = k.detach().float().requires_grad_(True)
    ((q32 @ k32.transpose(-1, -2)) * scale * torch.from_numpy(ct)).sum().backward()

    def l2(a, b):
        return np.linalg.norm(_np(a) - _np(b)) / np.linalg.norm(_np(b))

    assert l2(q.grad, jdq) < l2(q32.grad.bfloat16(), jdq)
    assert l2(k.grad, jdk) < l2(k32.grad.bfloat16(), jdk)


@pytest.mark.parametrize("sq,sk,causal,mask", [(8, 8, True, False), (5, 8, True, True),
                                               (8, 8, False, True)])
def test_dense_attention_matches_jax(sq, sk, causal, mask):
    """The dense path: f32 scores, the additive -1e9 masks, the causal
    mask aligned bottom-right (``tril(k=sk-sq)``), which
    ``F.scaled_dot_product_attention(is_causal=True)`` does not give at
    sq≠sk."""
    rng = np.random.RandomState(6)
    feed = {"q": rng.randn(2, 2, sq, 16).astype(np.float32),
            "kv": rng.randn(2, 2, sk, 16).astype(np.float32),
            "m": np.where(rng.rand(2, 1, 1, sk) < 0.25, -1e9, 0.0).astype(np.float32)}

    def make(A):
        return lambda q, kv, m: {"o": A.scaled_dot_product_attention(
            q, kv, kv, attn_mask=m if mask else None, causal=causal)}

    _, jout, tout, _, _ = _pair(make(jA), make(tA), feed, grads=False)
    assert _rel(tout["o"], jout["o"]) <= TOL["float32"]


# -- multi_head_attention and ffn ------------------------------------------------


def _mha_feed(kind, seed=8):
    rng = np.random.RandomState(seed)
    feed = {"x": rng.randn(2, 6, 32).astype(np.float32)}
    if kind == "cross":
        feed["enc"] = rng.randn(2, 9, 32).astype(np.float32)
        feed["m"] = np.where(rng.rand(2, 1, 1, 9) < 0.3, -1e9, 0.0).astype(np.float32)
    if kind == "cache":
        feed["x"] = feed["x"][:, :1]
        feed["ck"] = rng.randn(2, 4, 7, 8).astype(np.float32)
        feed["cv"] = rng.randn(2, 4, 7, 8).astype(np.float32)
    return feed


def _mha_net(A, kind, fuse, use_flash=None, causal=False, dtype="float32"):
    def cast(t):
        return _cast(t, dtype)

    if kind == "self":
        def net(x):
            return {"o": A.multi_head_attention(cast(x), num_heads=4, causal=causal,
                                                use_flash=use_flash, fuse_qkv=fuse)}
    elif kind == "cross":
        def net(x, enc, m):
            return {"o": A.multi_head_attention(cast(x), keys=cast(enc), num_heads=4,
                                                attn_mask=m, use_flash=use_flash,
                                                fuse_qkv=fuse)}
    else:
        def net(x, ck, cv):
            index = 3 if isinstance(x, torch.Tensor) else jnp.asarray(3, jnp.int32)
            o, c = A.multi_head_attention(
                cast(x), num_heads=4, fuse_qkv=fuse,
                cache={"k": cast(ck), "v": cast(cv), "index": index})
            assert int(c["index"]) == 4
            return {"o": o, "k": c["k"], "v": c["v"]}
    return net


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("kind", ["self", "cross", "cache"])
def test_multi_head_attention_matches_jax(kind, fuse):
    """Outputs, the new cache and every param's grad; the param names are
    the JAX package's (``mha_0/qkv_proj/w`` ...)."""
    feed = _mha_feed(kind)
    params, jout, tout, jg, tg = _pair(_mha_net(jA, kind, fuse), _mha_net(tA, kind, fuse),
                                       feed)
    names = {("self", True): ["qkv_proj"], ("cross", True): ["kv_proj", "q_proj"],
             ("cache", True): ["qkv_proj"]}.get((kind, fuse),
                                                ["k_proj", "q_proj", "v_proj"])
    assert sorted(params) == sorted(f"mha_0/{n}/{s}" for n in names + ["out_proj"]
                                    for s in "bw")
    for k in jout:
        assert _rel(tout[k], jout[k]) <= TOL["float32"], k
    _check_grads(tg, jg, TOL["float32"])


@pytest.mark.parametrize("kind,causal", [("self", True), ("cross", False)])
def test_multi_head_attention_flash_and_bf16_match_jax(kind, causal):
    """``use_flash`` at eval (the port's plain flash version against the
    JAX kernel in interpret mode), f32, and the same layer in bf16."""
    feed = _mha_feed(kind)
    _, jout, tout, _, _ = _pair(_mha_net(jA, kind, True, True, causal),
                                _mha_net(tA, kind, True, True, causal), feed, grads=False)
    assert _rel(tout["o"], jout["o"]) <= TOL["float32"]
    _, jout, tout, jg, tg = _pair(_mha_net(jA, kind, True, True, causal, "bfloat16"),
                                  _mha_net(tA, kind, True, True, causal, "bfloat16"),
                                  feed, dtype="bfloat16")
    assert tout["o"].dtype == torch.bfloat16
    assert _rel(tout["o"], jout["o"]) <= TOL["bfloat16"]
    for k, g in jg.items():
        if not k.endswith("k_proj/b"):
            assert _rel(tg[k], g) <= 2 * TOL["bfloat16"], k


@pytest.mark.parametrize("dtype,d_model,heads", [("float32", 64, 2), ("bfloat16", 128, 2)])
def test_fused_projection_heads_are_strided_views(dtype, d_model, heads):
    """The fused qkv projection hands attention strided head views of one
    product, and the flash wrapper passes those views to the kernel as
    they are (on the tensor-core route too: bf16 at head dim 64), so they
    reach it without a copy."""
    seen = {}
    real = tA.scaled_dot_product_attention

    def spy(q, k, v, **kw):
        seen["qkv"] = (q, k, v)
        return real(q, k, v, **kw)

    x = np.random.RandomState(9).randn(2, 6, d_model).astype(np.float32)

    def net(x):
        return {"o": tA.multi_head_attention(_cast(x, dtype), num_heads=heads,
                                             fuse_qkv=True, use_flash=True)}

    prog = tpt.build(net)
    params, _ = prog.init(0, place=CPU, x=x)
    tA.scaled_dot_product_attention = spy
    try:
        with tamp(dtype):
            prog.apply(params, {}, x=x, place=CPU)
    finally:
        tA.scaled_dot_product_attention = real
    q, k, v = seen["qkv"]
    hd = d_model // heads
    assert q.shape == (2, heads, 6, hd) and not q.is_contiguous()
    assert q.stride() == (6 * 3 * d_model, hd, 3 * d_model, 1)
    assert q.dtype == getattr(torch, dtype)
    got = tfa._kernel_layout(q, k, v, None, None, None)
    assert all(a is w for a, w in zip(got[:3], (q, k, v)))


def test_multi_head_attention_enforces_the_fused_sources():
    x = np.ones((1, 3, 8), np.float32)
    self_bad = tpt.build(lambda x: tA.multi_head_attention(x, None, x * 2, num_heads=2,
                                                           fuse_qkv=True))
    with pytest.raises(EnforceError, match="same source"):
        self_bad.init(0, place=CPU, x=x)
    cross_bad = tpt.build(lambda x: tA.multi_head_attention(x, x * 2, x * 3, num_heads=2,
                                                            fuse_qkv=True))
    with pytest.raises(EnforceError, match="values to be keys"):
        cross_bad.init(0, place=CPU, x=x)


@pytest.mark.parametrize("dtype,act", [("float32", "relu"), ("float32", "gelu"),
                                       ("bfloat16", "relu")])
def test_ffn_matches_jax(dtype, act):
    x = np.random.RandomState(10).randn(2, 5, 16).astype(np.float32)

    def make(A):
        def net(x):
            return {"y": A.ffn(_cast(x, dtype), 24, activation=act)}
        return net

    params, jout, tout, jg, tg = _pair(make(jA), make(tA), {"x": x}, dtype)
    assert sorted(params) == [f"ffn_0/{n}/{s}" for n in ("ffn_in", "ffn_out")
                              for s in "bw"]
    assert all(a.dtype == np.float32 for a in params.values())
    assert _rel(tout["y"], jout["y"]) <= TOL[dtype]
    _check_grads(tg, jg, TOL[dtype] * (2 if dtype == "bfloat16" else 1))


def test_ffn_dropout_draws_in_training_only():
    x = np.ones((4, 8, 16), np.float32)
    prog = tpt.build(lambda x: {"y": tA.ffn(x, 32, dropout_rate=0.5)})
    params, _ = prog.init(0, place=CPU, x=x)
    a = prog.apply(params, {}, x=x, training=True, rng=1, place=CPU)[0]["y"]
    b = prog.apply(params, {}, x=x, training=True, rng=2, place=CPU)[0]["y"]
    e1 = prog.apply(params, {}, x=x, training=False, place=CPU)[0]["y"]
    e2 = prog.apply(params, {}, x=x, training=False, place=CPU)[0]["y"]
    assert not torch.equal(a, b) and torch.equal(e1, e2)
