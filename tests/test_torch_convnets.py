"""The image zoo of the port (``models/vgg.py``: VGG-16;
``models/convnets.py``: AlexNet, GoogLeNet v1, SE-ResNeXt-50) against
``paddle_tpu`` on the CPU, on the same numpy inputs and the same params,
in f32, NHWC and NCHW, and the ported FLOP counts against the JAX
package's.

Each net is built once per layout in each package (5 classes). Its params
come from the port's ``Program.init`` and go to the JAX program as numpy
arrays; their names, shapes and dtypes are held against the JAX
program's ``init`` (evaluated abstractly: the JAX initialisers would
compile for minutes). Dropout becomes the identity in both packages for
the train-mode comparisons (the random streams differ), through
``monkeypatch``; the JAX side runs jitted. Sizes: VGG-16 32x32 and
AlexNet and GoogLeNet 64x64 at batch 2; SE-ResNeXt-50 64x64 at batch 4
(at batch 2 and 32x32 its last batch norms see 2 values a channel and the
two packages' training losses part by 30%).

Tolerances, each the largest error of its comparison, on the scale of the
reference (``max|a - b| / max|b|``):

- eval logits within 1e-5 (read: 5e-7 to 4e-6);
- train-mode loss within 1e-4 relative, logits and moving stats within
  5e-4 (read: up to 4e-5, 1.2e-4 and 5e-5);
- AlexNet's and GoogLeNet's grads within 1e-5 per param (read: 3e-6);
- VGG-16's and SE-ResNeXt-50's grads by relative L2 over all params,
  within 1e-2 and 5e-2 (read: 2.6e-3 and 2.3e-2). Their f32 grads at init
  are ill-conditioned: backprop through 15 and 53 training-mode batch
  norms amplifies rounding, and each package lands 1e-3 to 2e-2 away from
  a float64 run of the same program (read: VGG port 2.5e-3, JAX 1.5e-3;
  SE-ResNeXt port 8.1e-3, JAX 2.3e-2). ``test_f32_grads_part_as_far_as_
  each_package_from_float64`` holds that on every run;
- NHWC logits against NCHW logits within 1e-5; one Momentum(0.01, 0.9)
  step's move of every param as the grads.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as jpt
from paddle_tpu import layers as jL
from paddle_tpu import optimizer as jopt
from paddle_tpu.core import flops as jflops
from paddle_tpu.framework import layout_mode as jlayout
from paddle_tpu.models import convnets as jconv
from paddle_tpu.models import vgg as jvgg

import paddle_tpu_torch as tpt
from paddle_tpu_torch import layers as tL
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import flops as tflops
from paddle_tpu_torch.framework import amp_guard as tamp
from paddle_tpu_torch.framework import layout_mode as tlayout
from paddle_tpu_torch.framework import params_from_jax
from paddle_tpu_torch.models import convnets as tconv
from paddle_tpu_torch.models import vgg as tvgg

CPU = tpt.CPUPlace()
CLASSES = 5
# net: (factory of (vgg module, convnets module), image size, batch)
NETS = {
    "vgg16": (lambda v, c: v.make_model(depth=16, class_num=CLASSES), 32, 2),
    "alexnet": (lambda v, c: c.make_alexnet(class_num=CLASSES), 64, 2),
    "googlenet": (lambda v, c: c.make_googlenet(class_num=CLASSES), 64, 2),
    "se_resnext50": (lambda v, c: c.make_se_resnext(depth=50, class_num=CLASSES), 64, 4),
}
FMTS = ["NHWC", "NCHW"]
EVAL_TOL, LOSS_TOL, OUT_TOL = 1e-5, 1e-4, 5e-4
GRAD_TOL = {"alexnet": 1e-5, "googlenet": 1e-5}   # per param
GRAD_L2 = {"vgg16": 1e-2, "se_resnext50": 5e-2}    # over all params
LR, MOMENTUM = 0.01, 0.9


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-30)


def _rel_l2(a, b):
    num = sum(float(np.sum((_np(a[k]) - _np(b[k])) ** 2)) for k in b)
    return float(np.sqrt(num / sum(float(np.sum(_np(b[k]) ** 2)) for k in b)))


def _feed(net, fmt):
    _, size, batch = NETS[net]
    image = np.random.RandomState(0).randn(batch, 3, size, size).astype(np.float32)
    if fmt == "NHWC":
        image = np.ascontiguousarray(image.transpose(0, 2, 3, 1))
    label = (np.arange(batch) % CLASSES).reshape(batch, 1).astype(np.int64)
    return {"image": image, "label": label}


def _identity(x, *args, **kwargs):
    return x


_PAIRS = {}


def _pair(net, fmt):
    """Both packages' programs at ``fmt`` on the same params and feed: the
    eval logits, and (dropout the identity) the train-mode outputs, new
    state and grads. Built once per net and layout."""
    key = (net, fmt)
    if key in _PAIRS:
        return _PAIRS[key]
    make, _, _ = NETS[net]
    with jlayout(fmt):
        jprog = jpt.build(make(jvgg, jconv))
    with tlayout(fmt):
        tprog = tpt.build(make(tvgg, tconv))
    feed = _feed(net, fmt)
    tp, ts = tprog.init(0, place=CPU, **feed)
    params = {k: v.numpy() for k, v in tp.items()}
    state = {k: v.numpy() for k, v in ts.items()}
    jshapes = jax.eval_shape(lambda: jprog.init(jax.random.PRNGKey(0), **feed))
    out = {"jprog": jprog, "tprog": tprog, "feed": feed, "params": params, "state": state,
           "jax_specs": tuple({k: (tuple(v.shape), np.dtype(v.dtype)) for k, v in t.items()}
                              for t in jshapes)}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    out["jax_eval"] = np.asarray(jax.jit(
        lambda p: jprog.apply(p, state, training=False, **feed)[0]["logits"])(jparams))
    with torch.no_grad():
        out["port_eval"] = tprog.apply(params_from_jax(params, device="cpu"),
                                       params_from_jax(state, device="cpu"), training=False,
                                       place=CPU, **feed)[0]["logits"]

    def jloss(p):
        o, ns = jprog.apply(p, state, training=True, **feed)
        return o["loss"], (o, ns)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jL, "dropout", _identity)
        mp.setattr(tL, "dropout", _identity)
        (_, (jo, jns)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
        tparams = {k: v.requires_grad_(True) for k, v in
                   params_from_jax(params, device="cpu").items()}
        to, tns = tprog.apply(tparams, params_from_jax(state, device="cpu"), training=True,
                              place=CPU, **feed)
        to["loss"].backward()
    out["jax_train"] = ({k: np.asarray(v) for k, v in jo.items()},
                        {k: np.asarray(v) for k, v in jns.items()},
                        {k: np.asarray(v) for k, v in jg.items()})
    out["port_train"] = (to, tns, {k: v.grad for k, v in tparams.items()})
    _PAIRS[key] = out
    return out


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("net", sorted(NETS))
def test_params_carry_the_jax_packages_names_shapes_and_dtypes(net, fmt):
    p = _pair(net, fmt)
    jparams, jstate = p["jax_specs"]
    for got, want in ((p["params"], jparams), (p["state"], jstate)):
        assert {k: (v.shape, v.dtype) for k, v in got.items()} == want
    carried = params_from_jax(p["params"], device="cpu")
    assert all(np.array_equal(carried[k].numpy(), v) for k, v in p["params"].items())


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("net", sorted(NETS))
def test_eval_logits_match_jax(net, fmt):
    p = _pair(net, fmt)
    assert _rel(p["port_eval"], p["jax_eval"]) <= EVAL_TOL


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("net", sorted(NETS))
def test_train_loss_state_and_every_grad_match_jax(net, fmt):
    p = _pair(net, fmt)
    (jo, jns, jg), (to, tns, tg) = p["jax_train"], p["port_train"]
    assert abs(float(to["loss"]) - float(jo["loss"])) <= LOSS_TOL * abs(float(jo["loss"]))
    assert _rel(to["logits"], jo["logits"]) <= OUT_TOL
    assert float(to["acc"]) == float(jo["acc"])
    assert sorted(tns) == sorted(jns)
    for k in jns:
        assert _rel(tns[k], jns[k]) <= OUT_TOL, k
    assert sorted(tg) == sorted(jg) and all(tg[k] is not None for k in jg)
    if net in GRAD_TOL:
        for k in jg:
            assert _rel(tg[k], jg[k]) <= GRAD_TOL[net], k
    else:
        assert _rel_l2(tg, jg) <= GRAD_L2[net]


@pytest.mark.parametrize("net", sorted(GRAD_L2))
def test_f32_grads_part_as_far_as_each_package_from_float64(net, monkeypatch):
    """The gap to the reference's grads in the batch-normed nets is f32
    rounding amplified: the port's f32 grads lie no further from the
    reference's than twice the sum of each package's distance from a
    float64 run of the port's program (the same formula in float64)."""
    p = _pair(net, "NHWC")
    (_, _, jg), (_, _, tg) = p["jax_train"], p["port_train"]
    monkeypatch.setattr(tL, "dropout", _identity)
    # batch norm, layer norm and the loss compute in f32 by .float(): keep f64
    f32 = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float",
                        lambda t: t if t.dtype == torch.float64 else f32(t))
    params = {k: torch.from_numpy(v.astype(np.float64)).requires_grad_(True)
              for k, v in p["params"].items()}
    state = {k: torch.from_numpy(v.astype(np.float64)) for k, v in p["state"].items()}
    feed = dict(p["feed"], image=p["feed"]["image"].astype(np.float64))
    with tamp("float64"):
        out, _ = p["tprog"].apply(params, state, training=True, place=CPU, **feed)
    assert out["logits"].dtype == torch.float64
    out["loss"].backward()
    exact = {k: v.grad for k, v in params.items()}
    port_err, jax_err = _rel_l2(tg, exact), _rel_l2(jg, exact)
    assert _rel_l2(tg, jg) <= 2 * (port_err + jax_err)
    assert port_err <= GRAD_L2[net]


@pytest.mark.parametrize("net", sorted(NETS))
def test_nhwc_logits_equal_nchw_logits(net):
    """The same params give the same eval logits in both layouts (conv
    weights are OIHW in both; AlexNet and VGG flatten in CHW order)."""
    nhwc, nchw = _pair(net, "NHWC"), _pair(net, "NCHW")
    assert _rel(nhwc["port_eval"], nchw["port_eval"]) <= EVAL_TOL


@pytest.mark.parametrize("net", sorted(NETS))
def test_one_momentum_step_moves_params_as_jax(net, monkeypatch):
    """A ``Trainer`` step with Momentum(0.01, 0.9) (bench.py's
    ``_bench_convnet`` optimizer) from the carried params, against the
    JAX package's Momentum update on its own grads: each param's move."""
    p = _pair(net, "NHWC")
    monkeypatch.setattr(tL, "dropout", _identity)
    trainer = tpt.Trainer(p["tprog"], topt.Momentum(LR, MOMENTUM), place=CPU)
    trainer.startup(0, p["feed"], params=params_from_jax(p["params"], device="cpu"))
    assert all(np.array_equal(_np(trainer.scope.state[k]), v) for k, v in p["state"].items())
    trainer.step(p["feed"])
    jo = jopt.Momentum(LR, MOMENTUM)
    jparams = {k: jnp.asarray(v) for k, v in p["params"].items()}
    jgrads = {k: jnp.asarray(v) for k, v in p["jax_train"][2].items()}
    jnew, _ = jax.jit(jo.update)(jgrads, jo.init(jparams), jparams)
    moved = {k: (_np(trainer.scope.params[k]) - v) / LR for k, v in p["params"].items()}
    want = {k: (np.asarray(jnew[k]) - v) / LR for k, v in p["params"].items()}
    if net in GRAD_TOL:
        for k in want:
            assert _rel(moved[k], want[k]) <= 10 * GRAD_TOL[net], k
    else:
        assert _rel_l2(moved, want) <= GRAD_L2[net]


FLOPS = {
    "vgg_fwd_flops": lambda f, s: f.vgg_fwd_flops(16, s),
    "alexnet_fwd_flops": lambda f, s: f.alexnet_fwd_flops(s),
    "googlenet_fwd_flops": lambda f, s: f.googlenet_fwd_flops(s),
    "se_resnext_fwd_flops": lambda f, s: f.se_resnext_fwd_flops(50, s),
    "resnet_fwd_flops": lambda f, s: f.resnet_fwd_flops(50, s),
}


@pytest.mark.parametrize("size", [224, 128])
@pytest.mark.parametrize("name", sorted(FLOPS))
def test_flops_equal_the_jax_packages(name, size):
    got, want = FLOPS[name](tflops, size), FLOPS[name](jflops, size)
    assert got == want > 0
    assert tflops.convnet_train_flops(got, 64) == jflops.convnet_train_flops(want, 64)


@pytest.mark.parametrize("net", sorted(NETS))
def test_a_zoo_net_exports_and_serves_its_eval_logits(net, tmp_path):
    """Each net carries ``factory_spec``: ``save_inference_model`` records
    its factory and arguments, and ``load_inference_model`` rebuilds it in
    the layout it was built in and serves the program's eval logits."""
    from paddle_tpu_torch import io as tio
    p = _pair(net, "NHWC")
    art = str(tmp_path / net)
    tio.save_inference_model(art, p["tprog"], p["params"], p["state"], p["feed"])
    pred = tio.load_inference_model(art, device="cpu")
    assert torch.equal(pred.run(p["feed"])["logits"], p["port_eval"])
