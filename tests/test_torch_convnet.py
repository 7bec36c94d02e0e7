"""The conv-net slice of the port (ResNet-50's layers) against
``paddle_tpu`` on the CPU, on the same numpy inputs and the same params
(``params_from_jax``).

Tolerances, each the largest error of its comparison over the cases, on
the scale of the reference (``max|a − b| / max|b|``):

- f32 layer outputs and moving stats within 1e-5, grads within 1e-4 (the
  same products summed in another order by XLA's and oneDNN's CPU convs);
- bf16 layer outputs within 2e-2 and grads within 4e-2: both round
  every op's output to bf16 (8 bits of mantissa, 2**-8 = 3.9e-3 a
  rounding), XLA may keep an elementwise chain in f32 where PyTorch
  rounds after each op, and a rounding that lands differently moves a
  conv's sum by a few ulps of its inputs;
- pooling of a tied bf16 max window: the grads bit for bit (both route
  the cotangent to the first maximal cell);
- the narrow ResNet's loss and grads within 1e-4 (f32) and 6e-2 (bf16,
  grads by relative L2 over all params: ten layers of the above);
- the full depth-50 forward (batch 8, 24x24 images, 7 classes) within
  1e-4 of max|logits| in eval mode; in training within 1e-3, the moving
  stats within 1e-3: the last stage's batch statistics cover 8 values a
  channel, and E[x²] − E[x]² in f32 loses the bits of a spread that is
  small against the mean (at batch 2 the two packages' logits differ by
  half their scale, at batch 4 by 9e-4, at 8 by 2.6e-4);
- Momentum within 1e-6 of the param (the same f32 arithmetic), bf16
  params bit for bit;
- initializers by their statistics within 3% (the random streams differ:
  threefry against the CPU's Mersenne Twister).

The JAX side runs ``Program.apply`` eagerly (no jitted step), so no test
pays a ResNet compile.
"""


import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as jpt
from paddle_tpu import initializer as jinit
from paddle_tpu import layers as jL
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework import amp_guard as jamp
from paddle_tpu.framework import layout_mode as jlayout
from paddle_tpu.framework import name_scope as jscope
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.models import resnet as jresnet

import paddle_tpu_torch as tpt
from paddle_tpu_torch import data as tdata
from paddle_tpu_torch import initializer as tinit
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import layers as tL
from paddle_tpu_torch import nets as tnets
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import quantize as tquant
from paddle_tpu_torch.framework import amp_guard as tamp
from paddle_tpu_torch.framework import layout_mode as tlayout
from paddle_tpu_torch.framework import name_scope as tscope
from paddle_tpu_torch.framework import params_from_jax
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.models import resnet as tresnet

CPU = tpt.CPUPlace()
FMTS = ["NCHW", "NHWC"]
DTYPES = ["float32", "bfloat16"]
OUT_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 4e-2}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.nanmax(np.abs(np.where(np.isfinite(b), b, 0)))), 1e-30)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(np.isinf(a) & (a > 0), np.isinf(b) & (b > 0))
    np.testing.assert_array_equal(np.isinf(a) & (a < 0), np.isinf(b) & (b < 0))
    fin = np.isfinite(b)
    return float(np.max(np.abs(a[fin] - b[fin]), initial=0.0)) / scale


def _image(shape, fmt, seed=0, shift=0.0):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) + shift
    return x if fmt == "NCHW" else np.ascontiguousarray(x.transpose(0, 2, 3, 1))


def _carry(tree):
    return params_from_jax({k: np.asarray(v) for k, v in tree.items()}, device="cpu")


def _run_pair(jfn, tfn, feed, fmt, dtype, training=True, state_fn=None, wrt_input=True):
    """Build ``jfn`` and ``tfn`` under layout ``fmt`` and compute dtype
    ``dtype``, init in paddle_tpu and carry the params across, then run
    both on ``feed``: the outputs, the new state and the grads of
    ``sum(y · ct)`` (``ct`` random, seeded) with respect to the params and
    (``wrt_input``) the image. ``state_fn`` rewrites the initial state."""
    with jlayout(fmt):
        jprog = jpt.build(jfn)
    with tlayout(fmt):
        tprog = tpt.build(tfn)
    with jamp(dtype):
        params, state = jprog.init(jax.random.PRNGKey(0), **feed)
    if state_fn is not None:
        state = state_fn(state)
    with tamp(dtype):
        tp0, _ = tprog.init(0, place=CPU, **feed)
    assert {k: tuple(v.shape) for k, v in tp0.items()} == \
        {k: tuple(v.shape) for k, v in params.items()}
    assert {k: v.dtype for k, v in tp0.items()} == \
        {k: v.dtype for k, v in _carry(params).items()}

    with jamp(dtype):
        y0 = jprog.apply(params, state, training=training, **feed)[0]["y"]
    ct = np.random.RandomState(7).randint(-3, 4, y0.shape).astype(np.float32)

    def jloss(p, image):
        out, ns = jprog.apply(p, state, training=training, **dict(feed, image=image))
        return jnp.sum(out["y"].astype(jnp.float32) * ct), (out, ns)

    with jamp(dtype):
        (_, (jout, jstate)), (jgp, jgx) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(feed["image"]))

    tparams = {k: v.requires_grad_(v.is_floating_point()) for k, v in _carry(params).items()}
    tx = torch.from_numpy(feed["image"]).requires_grad_(wrt_input)
    with tamp(dtype):
        tout, tstate = tprog.apply(tparams, _carry(state), training=training, place=CPU,
                                   **dict(feed, image=tx))
    (tout["y"].float() * torch.from_numpy(ct)).sum().backward()
    tgp = {k: v.grad for k, v in tparams.items()}
    return (jout, jstate, jgp, jgx), (tout, tstate, tgp, tx.grad)


def _check_pair(j, t, dtype, grads=True, wrt_input=True):
    (jout, jstate, jgp, jgx), (tout, tstate, tgp, tgx) = j, t
    assert _rel(tout["y"], jout["y"]) <= OUT_TOL[dtype]
    assert sorted(tstate) == sorted(jstate)
    for k in jstate:
        assert _rel(tstate[k], jstate[k]) <= OUT_TOL["float32"], k
    if not grads:
        return
    for k in jgp:
        assert _rel(tgp[k], jgp[k]) <= GRAD_TOL[dtype], k
    if wrt_input:
        assert _rel(tgx, jgx) <= GRAD_TOL[dtype]


# -- conv2d --------------------------------------------------------------------

CONV_CASES = {
    "k3_stride2_pad1": dict(num_filters=6, filter_size=3, stride=2, padding=1),
    "groups2_dilation2_bias_relu": dict(num_filters=6, filter_size=3, padding=2,
                                        dilation=2, groups=2, act="relu"),
    "k1_no_bias": dict(num_filters=8, filter_size=1, bias_attr=False),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_matches_jax(case, fmt, dtype):
    kw = CONV_CASES[case]
    feed = {"image": _image((2, 4, 9, 9), fmt)}
    j, t = _run_pair(lambda image: {"y": jL.conv2d(image, name="c", **kw)},
                     lambda image: {"y": tL.conv2d(image, name="c", **kw)},
                     feed, fmt, dtype)
    assert t[0]["y"].dtype == getattr(torch, dtype)  # no f32 output under bf16
    _check_pair(j, t, dtype)


def test_conv2d_weight_is_oihw_and_msra_normal():
    def net(image):
        return {"y": tL.conv2d(image, 64, 3, name="c")}

    for fmt in FMTS:
        with tlayout(fmt):
            prog = tpt.build(net)
        params, _ = prog.init(3, place=CPU, image=_image((1, 32, 5, 5), fmt))
        w = params["c/w"]
        assert tuple(w.shape) == (64, 32, 3, 3) and w.dtype == torch.float32
        assert abs(w.std().item() / np.sqrt(2.0 / (32 * 9)) - 1) < 0.03
        assert torch.count_nonzero(params["c/b"]) == 0


def test_int8_serving_conv_and_fc_raise():
    """Under ``int8_serving()`` conv2d and fc no longer raise: they take
    the int8 route (the route counts move) and give the JAX layers' int8
    outputs bit for bit; the switch is off again after the block."""
    from paddle_tpu import quantize as jquant

    x = _image((1, 3, 5, 5), "NCHW")
    v = np.random.RandomState(1).randn(2, 4).astype(np.float32)
    nets = {"conv": (lambda image: {"y": jL.conv2d(image, 4, 3)},
                     lambda image: {"y": tL.conv2d(image, 4, 3)}, {"image": x}),
            "fc": (lambda v: {"y": jL.fc(v, 3)}, lambda v: {"y": tL.fc(v, 3)}, {"v": v})}
    for kind, (jfn, tfn, feed) in nets.items():
        jprog, tprog = jpt.build(jfn), tpt.build(tfn)
        jparams, jstate = jprog.init(jax.random.PRNGKey(0), **feed)
        with jquant.int8_serving():
            want, _ = jprog.apply(jparams, jstate, **feed)
        tquant.reset_int8_route_counts()
        with tquant.int8_serving():
            got, _ = tprog.apply(_carry(jparams), {}, place=CPU,
                                 **{k: torch.from_numpy(a) for k, a in feed.items()})
        np.testing.assert_array_equal(_np(got["y"]), np.asarray(want["y"]))
        assert tquant.int8_route_counts() == {"matmul": int(kind == "fc"),
                                              "conv": int(kind == "conv")}
    assert not tquant.in_int8_serving()


# -- pool2d --------------------------------------------------------------------

# 9x9 images: with ceil_mode and (2, 2, pad 1) the last window starts in the
# right padding, which PyTorch's ceil_mode drops and the JAX package keeps
POOL_CASES = {
    "max_k3_s2_p1": dict(pool_size=3, pool_type="max", pool_stride=2, pool_padding=1),
    "avg_exclusive_p1": dict(pool_size=3, pool_type="avg", pool_stride=2, pool_padding=1),
    "avg_inclusive_p1": dict(pool_size=3, pool_type="avg", pool_stride=2, pool_padding=1,
                             exclusive=False),
    "avg_unpadded": dict(pool_size=2, pool_type="avg", pool_stride=2),
    "max_ceil_window_in_padding": dict(pool_size=2, pool_type="max", pool_stride=2,
                                       pool_padding=1, ceil_mode=True),
    "avg_ceil_window_in_padding": dict(pool_size=2, pool_type="avg", pool_stride=2,
                                       pool_padding=1, ceil_mode=True),
    "avg_ceil_inclusive": dict(pool_size=3, pool_type="avg", pool_stride=2, ceil_mode=True,
                               exclusive=False),
    "max_ceil_unpadded": dict(pool_size=3, pool_type="max", pool_stride=2, ceil_mode=True),
    "max_pad_over_half_window": dict(pool_size=2, pool_type="max", pool_stride=1,
                                     pool_padding=2),
    "global_avg": dict(pool_type="avg", global_pooling=True),
    "global_max": dict(pool_type="max", global_pooling=True),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool2d_matches_jax(case, fmt, dtype):
    kw = POOL_CASES[case]
    feed = {"image": _image((2, 3, 9, 9), fmt)}
    # the image goes in at the compute dtype (pool2d casts nothing)
    j, t = _run_pair(lambda image: {"y": jL.pool2d(jL.cast(image, dtype), **kw)},
                     lambda image: {"y": tL.pool2d(tL.cast(image, dtype), **kw)},
                     feed, fmt, dtype)
    _check_pair(j, t, dtype)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("window", [(2, 2, 0), (3, 2, 1)])
def test_pool2d_tied_bf16_max_routes_the_grad_alike(fmt, window):
    size, stride, pad = window
    x = np.random.RandomState(1).randint(0, 3, (2, 3, 8, 8)).astype(np.float32)
    feed = {"image": x if fmt == "NCHW" else np.ascontiguousarray(x.transpose(0, 2, 3, 1))}
    kw = dict(pool_size=size, pool_type="max", pool_stride=stride, pool_padding=pad)
    j, t = _run_pair(lambda image: {"y": jL.pool2d(jL.cast(image, "bfloat16"), **kw)},
                     lambda image: {"y": tL.pool2d(tL.cast(image, "bfloat16"), **kw)},
                     feed, fmt, "bfloat16")
    np.testing.assert_array_equal(_np(t[0]["y"]), _np(j[0]["y"]))
    np.testing.assert_array_equal(_np(t[3]), _np(j[3]))


# -- batch_norm ----------------------------------------------------------------

BN_CASES = {
    # (training, layer kwargs)
    "train": (True, dict(act="relu")),
    "eval_follows_the_run": (False, dict()),
    "is_test_in_training": (True, dict(is_test=True)),
    "use_global_stats": (True, dict(use_global_stats=True, momentum=0.8)),
}


def _bn_state(state):
    rng = np.random.RandomState(5)
    return {k: jnp.asarray(rng.rand(*v.shape).astype(np.float32) + 0.5) for k, v in
            state.items()}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm_matches_jax(case, fmt, dtype):
    training, kw = BN_CASES[case]
    # an uncentred input, so E[x²] − E[x]² cancels
    feed = {"image": _image((3, 4, 5, 5), fmt, shift=3.0)}
    j, t = _run_pair(lambda image: {"y": jL.batch_norm(jL.cast(image, dtype), name="bn",
                                                        **kw)},
                     lambda image: {"y": tL.batch_norm(tL.cast(image, dtype), name="bn",
                                                        **kw)},
                     feed, fmt, dtype, training=training, state_fn=_bn_state)
    tparams_dtype = {str(v.dtype) for v in t[2].values()}
    assert tparams_dtype == {f"torch.{dtype}"}  # scale and bias in x's dtype
    _check_pair(j, t, dtype)
    moved = not np.array_equal(_np(t[1]["bn/moving_mean"]), _np(_bn_state(j[1])["bn/moving_mean"]))
    assert moved == (case == "train")


# -- initializers --------------------------------------------------------------


def _draw(init, shape, seed=0):
    return init(tinit.param_generator(seed, "w"), shape, torch.float32)


def test_msra_and_truncated_normal_statistics():
    shape = (128, 64, 3, 3)
    fan_in = 64 * 9
    w = _draw(tinit.MSRA(uniform=False), shape)
    assert abs(w.mean().item()) < 0.01 * np.sqrt(2.0 / fan_in)
    assert abs(w.std().item() / np.sqrt(2.0 / fan_in) - 1) < 0.03
    u = _draw(tinit.MSRA(uniform=True, fan_in=100), shape)
    limit = np.sqrt(6.0 / 100)
    assert u.abs().max().item() <= limit and u.abs().max().item() > 0.99 * limit
    assert abs(u.std().item() / (limit / np.sqrt(3)) - 1) < 0.03
    t = _draw(tinit.TruncatedNormal(loc=1.0, scale=2.0), (200_000,))
    # a standard normal truncated at ±2 has std 0.87962
    assert t.min().item() >= -3.0 and t.max().item() <= 5.0
    assert abs(t.mean().item() - 1.0) < 0.02 and abs(t.std().item() / (2 * 0.87962) - 1) < 0.03
    j = np.asarray(jinit.TruncatedNormal(1.0, 2.0)(jax.random.PRNGKey(0), (200_000,),
                                                   jnp.float32))
    assert abs(float(j.std()) / t.std().item() - 1) < 0.03


@pytest.mark.parametrize("shape", [(2, 3, 4, 4), (1, 1, 3, 5)])
def test_bilinear_and_numpy_initializers_equal_jax(shape):
    want = np.asarray(jinit.Bilinear()(None, shape, jnp.float32))
    np.testing.assert_array_equal(_draw(tinit.Bilinear(), shape).numpy(), want)
    v = np.random.RandomState(0).randn(*shape).astype(np.float32)
    got = tinit.NumpyArrayInitializer(v)(tinit.param_generator(0, "w"), shape, "bfloat16")
    want = np.asarray(jinit.NumpyArrayInitializer(v)(None, shape, jnp.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
    with pytest.raises(ValueError):
        tinit.NumpyArrayInitializer(v)(None, (3,), "float32")
    for alias in ("TruncatedNormalInitializer", "MSRAInitializer", "BilinearInitializer",
                  "ConstantInitializer", "XavierInitializer"):
        assert getattr(tinit, alias) is getattr(tinit, alias.replace("Initializer", ""))


# -- Momentum ------------------------------------------------------------------


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_matches_jax_step_for_step(nesterov):
    rng = np.random.RandomState(0)
    p = {"w": rng.randn(5, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32),
         "s": rng.randn(4).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jp["s"] = jp["s"].astype(jnp.bfloat16)  # a bf16 param (batch norm under amp)
    tp = _carry(jp)
    jo, to = jopt.Momentum(0.1, 0.9, use_nesterov=nesterov), topt.Momentum(
        0.1, 0.9, use_nesterov=nesterov)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(4):
        g = {k: rng.randn(*v.shape).astype(np.float32) for k, v in p.items()}
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for k in p:
            assert _rel(tp[k], jp[k]) <= 1e-6, (step, k)
            assert _rel(ts["accums"][k]["velocity"], js["accums"][k]["velocity"]) <= 1e-6
        np.testing.assert_array_equal(_np(tp["s"]), _np(jp["s"]))
        assert tp["s"].dtype == torch.bfloat16
        assert ts["accums"]["s"]["velocity"].dtype == torch.float32


# -- ResNet --------------------------------------------------------------------


def _narrow_resnet(R, L, scope):
    """conv_bn_layer and bottleneck_block stacks at 4-8 filters: a stem, a
    max pool, a block whose channels change (projection shortcut), a
    strided block, global average pooling and an fc."""
    def net(image, label):
        x = R.conv_bn_layer(image, 4, 3, stride=2, act="relu")
        x = L.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1, pool_type="max")
        with scope("stage0"):
            x = R.bottleneck_block(x, 4, stride=1)
            x = R.bottleneck_block(x, 4, stride=1)
        with scope("stage1"):
            x = R.bottleneck_block(x, 8, stride=2)
        x = L.pool2d(x, pool_type="avg", global_pooling=True)
        logits = L.fc(L.flatten(x, axis=1), 5)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        return {"y": loss, "loss": loss, "logits": logits}
    return net


NARROW_LOSS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
NARROW_GRAD_L2 = {"float32": 1e-4, "bfloat16": 6e-2}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fmt", FMTS)
def test_narrow_resnet_forward_and_grads_match_jax(fmt, dtype):
    feed = {"image": _image((2, 3, 16, 16), fmt),
            "label": np.array([[1], [3]], np.int64)}
    j, t = _run_pair(_narrow_resnet(jresnet, jL, jscope), _narrow_resnet(tresnet, tL, tscope),
                     feed, fmt, dtype)
    (jout, jstate, jgp, _), (tout, tstate, tgp, _) = j, t
    assert abs(tout["y"].item() - float(jout["y"])) / abs(float(jout["y"])) \
        <= NARROW_LOSS_TOL[dtype]
    assert _rel(tout["logits"], jout["logits"]) <= NARROW_LOSS_TOL[dtype] * 10
    for k in jstate:
        assert _rel(tstate[k], jstate[k]) <= OUT_TOL[dtype], k
    num = sum(float(np.sum((_np(tgp[k]) - _np(jgp[k])) ** 2)) for k in jgp)
    den = sum(float(np.sum(_np(jgp[k]) ** 2)) for k in jgp)
    assert np.sqrt(num / den) <= NARROW_GRAD_L2[dtype]


@pytest.fixture(scope="module")
def resnet50_pair():
    """ResNet-50 (7 classes, 24x24 images, batch 8) initialised by
    paddle_tpu, and the port's program built from the same factory."""
    fn = jresnet.make_model(depth=50, class_num=7, image_size=24)
    jprog = jpt.build(fn)
    feed = {"image": _image((8, 3, 24, 24), "NCHW"),
            "label": np.arange(8, dtype=np.int64).reshape(8, 1) % 7}
    params, state = jprog.init(jax.random.PRNGKey(0), **feed)
    tprog = tpt.build(tresnet.make_model(depth=50, class_num=7, image_size=24))
    tp0, ts0 = tprog.init(0, place=CPU, **feed)
    return jprog, tprog, params, state, feed, tp0, ts0


@pytest.mark.parametrize("training", [False, True])
def test_resnet50_forward_matches_jax(resnet50_pair, training):
    jprog, tprog, params, state, feed, tp0, ts0 = resnet50_pair
    assert {k: tuple(v.shape) for k, v in tp0.items()} == \
        {k: tuple(v.shape) for k, v in params.items()}
    assert sorted(ts0) == sorted(state) and len(tp0) == 161
    jout, jstate = jprog.apply(params, state, training=training, **feed)
    with torch.no_grad():
        tout, tstate = tprog.apply(_carry(params), _carry(state), training=training,
                                   place=CPU, **feed)
    tol = 1e-3 if training else 1e-4
    assert _rel(tout["logits"], jout["logits"]) <= tol
    assert abs(float(tout["loss"]) - float(jout["loss"])) <= tol * abs(float(jout["loss"]))
    for k in jstate:
        assert _rel(tstate[k], jstate[k]) <= tol, k
    moved = any(not np.array_equal(_np(tstate[k]), _np(state[k])) for k in state)
    assert moved == training


# -- the e2e and layout analogs --------------------------------------------------


def _mnist_feed(batch_size=16):
    reader = tdata.batch(tdata.shuffle(tdata.datasets.mnist("train"), 512, seed=0),
                         batch_size)
    feed = tdata.DataFeeder(["image", "label"], dtypes=["float32", "int64"]).feed(
        next(iter(reader())))
    feed["label"] = feed["label"].reshape(-1, 1)
    return feed


def test_mnist_conv_net_two_momentum_steps():
    """tests/test_e2e_mnist.py:64-71 on the port: two Momentum steps of
    conv_net on one batch, the loss falls."""
    sample = _mnist_feed()
    trainer = tpt.Trainer(tpt.build(tmnist.conv_net), topt.Momentum(0.01, 0.9),
                          loss_name="loss", place=CPU)
    trainer.startup(sample_feed=sample)
    out0 = trainer.step(sample)
    out1 = trainer.step(sample)
    assert float(out1["loss"]) < float(out0["loss"])


def test_mnist_conv_net_steps_match_jax():
    """conv_net under Momentum(0.01, 0.9) from carried params: 3 steps'
    losses within 1e-5 relative, the params and moving stats after them
    within 1e-4 of the param's scale."""
    feed = _mnist_feed()
    jt = jpt.Trainer(jpt.build(jmnist.conv_net), jopt.Momentum(0.01, 0.9), loss_name="loss")
    jt.startup(sample_feed=feed)
    tt = tpt.Trainer(tpt.build(tmnist.conv_net), topt.Momentum(0.01, 0.9), loss_name="loss",
                     place=CPU)
    tt.startup(sample_feed=feed, params=_carry(jt.scope.params))
    for _ in range(3):
        jl, tl = float(jt.step(feed)["loss"]), float(tt.step(feed)["loss"])
        assert abs(tl - jl) <= 1e-5 * abs(jl)
    for k, v in jt.scope.params.items():
        assert _rel(tt.scope.params[k], v) <= 1e-4, k
    for k, v in jt.scope.state.items():
        assert _rel(tt.scope.state[k], v) <= 1e-4, k


def _small_convnet(image, label):
    h = tL.conv2d(image, 6, 3, padding=1, bias_attr=False, name="c0")
    h = tL.batch_norm(h, act="relu", name="bn")
    h = tL.pool2d(h, 2, "avg", 2)
    logits = tL.fc(tL.to_chw_order(h), 5, name="fc")
    return {"loss": tL.mean(tL.softmax_with_cross_entropy(logits, label)), "logits": logits}


def _narrow_port_resnet(image, label):
    return _narrow_resnet(tresnet, tL, tscope)(image, label)


@pytest.mark.parametrize("model", [_small_convnet, _narrow_port_resnet])
@pytest.mark.parametrize("training", [False, True])
def test_nhwc_matches_nchw(model, training):
    """tests/test_layout_mode.py:39-78 on the port: the same weights give
    the same outputs (1e-5 of max|logits|), moving stats and grads (1e-4
    of the largest) in both layouts; the weight shapes do not fork."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 16, 16).astype(np.float32)
    feed_c = {"image": x, "label": rng.randint(0, 5, (2, 1)).astype(np.int64)}
    feed_h = dict(feed_c, image=np.ascontiguousarray(x.transpose(0, 2, 3, 1)))
    prog_c = tpt.build(model)
    with tlayout("NHWC"):
        prog_h = tpt.build(model)
    params, state = prog_c.init(0, place=CPU, **feed_c)
    params_h, state_h = prog_h.init(0, place=CPU, **feed_h)
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in params_h.items()}, "weight layout must not fork"
    outs, grads = [], []
    for prog, feed in ((prog_c, feed_c), (prog_h, feed_h)):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        out, ns = prog.apply(p, state, training=training, place=CPU, **feed)
        out["loss"].backward()
        outs.append((out, ns))
        grads.append({k: v.grad for k, v in p.items()})
    (oc, sc), (oh, sh) = outs
    assert _rel(oh["logits"], oc["logits"]) <= 1e-5
    for k in sc:
        assert _rel(sh[k], sc[k]) <= 1e-5, k
    # on the scale of the largest grad: a batch norm's bias that feeds
    # another batch norm has a grad of 0 up to rounding
    scale = max(float(g.abs().max()) for g in grads[0].values())
    for k in grads[0]:
        assert float((grads[1][k] - grads[0][k]).abs().max()) <= 1e-4 * scale, k


def _export_net(image):
    h = tL.conv2d(image, 4, 3, padding=1, bias_attr=False, name="c")
    h = tL.batch_norm(h, act="relu", name="bn")
    return {"y": tL.fc(tL.to_chw_order(h), 3, name="out")}


def test_nhwc_model_exports_and_serves(tmp_path):
    """tests/test_layout_mode.py:105 on the port: an NHWC-built program
    exports with its layout, and the loaded Predictor gives the NCHW
    export's outputs on the transposed input (1e-5)."""
    x = np.random.RandomState(0).randn(2, 3, 6, 6).astype(np.float32)
    xh = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    m_c = tpt.build(_export_net)
    with tlayout("NHWC"):
        m_h = tpt.build(_export_net)
    p, s = m_c.init(0, place=CPU, image=x)
    _, s_h = m_h.init(0, place=CPU, image=xh)
    d_c, d_h = str(tmp_path / "nchw"), str(tmp_path / "nhwc")
    tio.save_inference_model(d_c, m_c, p, s, {"image": x})
    tio.save_inference_model(d_h, m_h, p, s_h, {"image": xh})
    assert tio.read_artifact_meta(d_h)["meta"]["layout"] == "NHWC"
    out_c = tio.load_inference_model(d_c, device="cpu").run({"image": x})
    out_h = tio.load_inference_model(d_h, device="cpu").run({"image": xh})
    assert _rel(out_h["y"], out_c["y"]) <= 1e-5


def test_resnet_artifact_rebuilds_from_its_factory(tmp_path):
    """A ResNet program (a function made by ``make_model``) exports by its
    factory and arguments; the NHWC artifact serves the moving stats'
    outputs, equal to ``trainer.eval``'s."""
    fn = tresnet.make_model(depth=50, class_num=7, image_size=16)
    with tlayout("NHWC"):
        prog = tpt.build(fn)
    rng = np.random.RandomState(0)
    feed = {"image": rng.randn(2, 16, 16, 3).astype(np.float32),
            "label": rng.randint(0, 7, (2, 1)).astype(np.int64)}
    tr = tpt.Trainer(prog, topt.Momentum(0.1, 0.9), place=CPU).startup(0, feed)
    tr.step(feed)
    d = str(tmp_path / "resnet")
    tio.save_inference_model(d, prog, tr.scope.params, tr.scope.state, feed,
                             batch_buckets=[1])
    meta = tio.read_artifact_meta(d)["meta"]
    assert meta["program_factory"] == "paddle_tpu_torch.models.resnet:make_model"
    assert meta["program_kwargs"]["class_num"] == 7 and meta["layout"] == "NHWC"
    got = tio.load_inference_model(d, device="cpu").run(feed)
    want = tr.eval(feed)
    assert _rel(got["logits"], want["logits"]) <= 1e-6


# -- nets ----------------------------------------------------------------------


def test_nets_match_jax():
    from paddle_tpu import nets as jnets

    rng = np.random.RandomState(0)
    img = rng.randn(2, 3, 12, 12).astype(np.float32)
    seq = rng.randn(2, 7, 6).astype(np.float32)
    lengths = np.array([7, 4], np.int64)
    qkv = rng.randn(2, 5, 8).astype(np.float32)

    def make(N, L):
        def net(image, seq, lengths, qkv):
            a = N.simple_img_conv_pool(image, 4, 3, pool_size=2, pool_stride=2, act="relu")
            b = N.img_conv_group(image, [4, 6], pool_size=2, pool_stride=2,
                                 conv_with_batchnorm=True)
            c = N.sequence_conv_pool(seq, lengths, 5, 3)
            d = N.sequence_conv_pool(seq, lengths, 5, 3, pool_type="avg")
            e = N.glu(qkv)
            f = N.scaled_dot_product_attention(qkv, qkv, qkv, num_heads=2)
            return {"a": a, "b": b, "c": c, "d": d, "e": e, "f": f}
        return net

    feed = {"image": img, "seq": seq, "lengths": lengths, "qkv": qkv}
    jprog = jpt.build(make(jnets, jL))
    params, state = jprog.init(jax.random.PRNGKey(0), **feed)
    jout, _ = jprog.apply(params, state, training=True, **feed)
    tout, _ = tpt.build(make(tnets, tL)).apply(_carry(params), _carry(state), training=True,
                                              place=CPU, **feed)
    for k in jout:
        assert _rel(tout[k], jout[k]) <= 1e-5, k


def test_nets_dropout_raises_not_yet_ported():
    """Dropout in ``nets`` is ported now (``layers.dropout``): the two cases
    that raised run. ``img_conv_group`` drops after its batch norm in
    training and scales by 1 − p at inference (downgrade_in_infer);
    ``scaled_dot_product_attention`` drops attention probabilities in
    training only."""
    x = np.random.RandomState(0).rand(2, 3, 8, 8).astype(np.float32)
    prog = tpt.build(lambda image: {"y": tnets.img_conv_group(
        image, [4], 2, conv_with_batchnorm=True, conv_batchnorm_drop_rate=0.5)})
    params, state = prog.init(0, place=CPU, image=x)
    train, _ = prog.apply(params, state, training=True, rng=1, place=CPU, image=x)
    infer, _ = prog.apply(params, state, training=False, place=CPU, image=x)
    assert train["y"].shape == infer["y"].shape == (2, 4, 7, 7)
    assert not torch.equal(train["y"], infer["y"])
    q = np.random.RandomState(1).randn(1, 4, 8).astype(np.float32)
    prog = tpt.build(lambda q: {"y": tnets.scaled_dot_product_attention(
        q, q, q, num_heads=2, dropout_rate=0.1)})
    params, state = prog.init(0, place=CPU, q=q)
    train = prog.apply(params, state, training=True, rng=1, place=CPU, q=q)[0]["y"]
    infer = prog.apply(params, state, training=False, place=CPU, q=q)[0]["y"]
    assert train.shape == infer.shape == (1, 4, 8) and not torch.equal(train, infer)
