"""Int8 serving through the port's layers and inference artifacts, held
against ``paddle_tpu``'s on the same params (initialised in the JAX
package, carried by ``params_from_jax``) and the same numpy feeds.

- The conv net of ``models.mnist`` saved under ``quantize.int8_serving()``
  by each package, loaded with no switch set and run through
  ``Predictor.run``: the port's logits within 1e-2 of max|logits| of the
  JAX package's, with the same argmax (the int8 products agree bit for
  bit; batch norm's and the pools' f32 ops may round an ulp apart, which
  can move one quantization level of the next layer's input). Every conv
  and the fc of a served call take the int8 route: 2 convs and 1 fc.
- An artifact saved without the switch serves float: the port's logits
  are the float program's bit for bit and no int8 route runs; an artifact
  that does not record the switch at all (written before it was
  recorded) loads as float too.
- An NHWC program of conv2d (stride 2) and fc under the switch: bit for
  bit the JAX layers' int8 outputs (the NHWC filter passed as HWIO, as
  the JAX layer passes it).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import io as jio
from paddle_tpu import layers as jL
from paddle_tpu import quantize as jq
from paddle_tpu.framework import layout_mode as jlayout
from paddle_tpu.models import mnist as jmnist

import paddle_tpu_torch as tpt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import layers as tL
from paddle_tpu_torch import quantize as tq
from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch.framework import layout_mode as tlayout
from paddle_tpu_torch.framework import params_from_jax
from paddle_tpu_torch.models import mnist as tmnist

TOL = 1e-2
CPU = tpt.CPUPlace()


def _feed(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"image": rng.randn(n, 784).astype(np.float32),
            "label": rng.randint(0, 10, (n, 1)).astype(np.int64)}


def _np(v):
    return v.detach().float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.fixture(scope="module")
def conv_net_params():
    params, state = jpt.build(jmnist.conv_net).init(jax.random.PRNGKey(0), **_feed(4))
    return ({k: np.asarray(v) for k, v in params.items()},
            {k: np.asarray(v) for k, v in state.items()})


def _export_both(tmp, params, state, int8):
    """Each package's artifact of the conv net at buckets [4, 8]."""
    feed = _feed(4)
    jd, td = str(tmp / "jax"), str(tmp / "port")
    with jq.int8_serving(int8):
        jio.save_inference_model(jd, jpt.build(jmnist.conv_net), params, state, feed,
                                 batch_buckets=[8])
    with tq.int8_serving(int8):
        tio.save_inference_model(td, tpt.build(tmnist.conv_net),
                                 params_from_jax(params, device="cpu"),
                                 params_from_jax(state, device="cpu"), feed,
                                 batch_buckets=[8])
    return jd, td


def test_conv_net_artifact_saved_under_int8_serves_int8_as_jax(conv_net_params, tmp_path):
    params, state = conv_net_params
    jd, td = _export_both(tmp_path, params, state, int8=True)
    assert tio.read_artifact_meta(td)["meta"]["int8_serving"] is True
    jpred = jio.load_inference_model(jd)
    tpred = tio.load_inference_model(td, device="cpu")
    assert not tq.in_int8_serving()
    for seed, n in ((1, 4), (2, 8)):
        feed = _feed(n, seed)
        want = _np(jpred.run(feed)["logits"])
        tq.reset_int8_route_counts()
        got = _np(tpred.run(feed)["logits"])
        assert tq.int8_route_counts() == {"matmul": 1, "conv": 2}
        err = np.max(np.abs(got - want)) / np.max(np.abs(want))
        assert err <= TOL, err
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    # the served int8 logits are not the float program's: the switch took
    f32, _ = tpt.build(tmnist.conv_net).apply(
        params_from_jax(params, device="cpu"), params_from_jax(state, device="cpu"),
        place=CPU, **{k: torch.from_numpy(v) for k, v in _feed(8, 2).items()})
    assert not np.array_equal(got, _np(f32["logits"]))


def test_artifact_saved_without_the_switch_serves_float(conv_net_params, tmp_path):
    params, state = conv_net_params
    jd, td = _export_both(tmp_path, params, state, int8=False)
    assert tio.read_artifact_meta(td)["meta"]["int8_serving"] is False
    feed = _feed(8, 3)
    tparams, tstate = params_from_jax(params, device="cpu"), params_from_jax(state, device="cpu")
    with torch.inference_mode():
        f32, _ = tpt.build(tmnist.conv_net).apply(
            tparams, tstate, place=CPU, **{k: torch.from_numpy(v) for k, v in feed.items()})
    tq.reset_int8_route_counts()
    got = _np(tio.load_inference_model(td, device="cpu").run(feed)["logits"])
    assert tq.int8_route_counts() == {"matmul": 0, "conv": 0}
    np.testing.assert_array_equal(got, _np(f32["logits"]))
    want = _np(jio.load_inference_model(jd).run(feed)["logits"])
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))

    # an artifact written before the switch was recorded: meta.json without
    # the key (its manifest entry rewritten to match) loads as float
    path = os.path.join(td, "meta.json")
    with open(path) as f:
        meta = json.load(f)
    del meta["int8_serving"]
    with open(path, "w") as f:
        json.dump(meta, f)
    man = tres.read_manifest(td)
    tres.write_manifest(td, meta=man["meta"], arrays=man.get("arrays"))
    tq.reset_int8_route_counts()
    old = _np(tio.load_inference_model(td, device="cpu").run(feed)["logits"])
    assert tq.int8_route_counts() == {"matmul": 0, "conv": 0}
    np.testing.assert_array_equal(old, got)


def _nhwc_net(image):
    return {"y": jL.fc(jL.conv2d(image, 6, 3, stride=2, padding=1, act="relu"), 5)}


def _nhwc_net_port(image):
    return {"y": tL.fc(tL.conv2d(image, 6, 3, stride=2, padding=1, act="relu"), 5)}


def test_nhwc_conv_and_fc_under_int8_equal_jax():
    x = np.random.RandomState(4).randn(2, 9, 9, 4).astype(np.float32)
    with jlayout("NHWC"):
        jprog = jpt.build(_nhwc_net)
    with tlayout("NHWC"):
        tprog = tpt.build(_nhwc_net_port)
    params, state = jprog.init(jax.random.PRNGKey(1), image=x)
    with jq.int8_serving():
        want, _ = jprog.apply(params, state, image=x)
    tq.reset_int8_route_counts()
    with tq.int8_serving():
        got, _ = tprog.apply(params_from_jax({k: np.asarray(v) for k, v in params.items()},
                                             device="cpu"), {}, place=CPU,
                             image=torch.from_numpy(x))
    assert tq.int8_route_counts() == {"matmul": 1, "conv": 1}
    np.testing.assert_array_equal(_np(got["y"]), np.asarray(want["y"]))
