"""The decode-serving slice of the port against the JAX package: a small
GPT (vocab 97, d 32, 4 heads, 2 layers, max_len 32, use_flash=True) is
built and initialised in ``paddle_tpu``, its params are carried across
with ``params_from_jax``, and the two run on the same numpy inputs.

Tolerance: blocks in f32 atol = rtol = 1e-5 (the same f32 arithmetic,
summed in another order); token ids exactly. Both generators are ``build``
programs; the port's runs with ``place="cpu"``."""

import json
import os
from dataclasses import asdict as dataclasses_asdict

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import io as jio
from paddle_tpu.layers import stacked as jS
from paddle_tpu.models import gpt as jgpt

from paddle_tpu_torch import io as tio
from paddle_tpu_torch.fleet import decode as tdecode
from paddle_tpu_torch.layers import stacked as tS
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import flash_attention as tfa

TOL = 1e-5
CPU = "cpu"
MAX_NEW = 6
SMALL = dict(vocab_size=97, max_len=32, d_model=32, d_inner=64, num_heads=4,
             num_layers=2, use_flash=True)


def _cfg(**kw):
    return jgpt.base_config(**{**SMALL, **kw})


def _tcfg(**kw):
    return tgpt.base_config(**{**SMALL, **kw})


def _prompts(b=4, p=8, seed=0):
    return np.random.RandomState(seed).randint(3, 97, (b, p)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX program and its params: a fresh init, then every param
    jittered from a numpy seed so biases and norms are not constants and
    the greedy ids do not collapse onto one token."""
    prog = pt.build(jgpt.make_generator(_cfg(), max_new_tokens=MAX_NEW))
    params, state = prog.init(jax.random.PRNGKey(0), _prompts())
    rng = np.random.RandomState(1)
    params = {k: np.asarray(v) + 0.3 * rng.randn(*v.shape).astype(np.float32)
              for k, v in params.items()}
    return prog, params, state


def _jax_ids(jax_side, prompts):
    prog, params, state = jax_side
    out, _ = prog.apply(jax.tree.map(jnp.asarray, params), state, prompts)
    return np.asarray(out["ids"])


def _port_generator(jax_side, **cfg):
    """The port's ``build(make_generator(...))`` program with the JAX
    params carried across."""
    prog = ptt.build(tgpt.make_generator(_tcfg(**cfg), MAX_NEW))
    return prog, tgpt.params_from_jax(jax_side[1], device=CPU)


def _port_ids(prog, params, prompts):
    out, _ = prog.apply(params, {}, prompt_ids=prompts, place=CPU)
    return out["ids"]


def _layer(params, i):
    pre = "gpt/encoder_stack/"
    return {k[len(pre):]: v[i] for k, v in params.items() if k.startswith(pre)}


def test_param_names_and_layouts_are_the_jax_ones(jax_side):
    """``build(make_generator(...)).init`` creates the JAX program's params:
    the same names, shapes and dtypes."""
    prog = ptt.build(tgpt.make_generator(_tcfg(), MAX_NEW))
    params, state = prog.init(0, prompt_ids=_prompts(), place=CPU)
    assert sorted(params) == sorted(jax_side[1]) and state == {}
    for name, a in jax_side[1].items():
        assert tuple(params[name].shape) == a.shape, name
        assert str(params[name].dtype).split(".")[-1] == a.dtype.name, name


@pytest.mark.parametrize("layer", [0, 1])
def test_prefill_block_matches_jax(jax_side, layer):
    lp = _layer(jax_side[1], layer)
    x = np.random.RandomState(2).randn(2, 12, 32).astype(np.float32)
    want, (wk, wv) = jS.prefill_block(jnp.asarray(x), jax.tree.map(jnp.asarray, lp),
                                      4, use_flash=True)
    got, (gk, gv) = tS.prefill_block(torch.from_numpy(x),
                                     {k: torch.from_numpy(v) for k, v in lp.items()},
                                     4, use_flash=True)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("index", [0, 5, 11])
def test_decode_block_matches_jax(jax_side, index):
    lp = _layer(jax_side[1], 1)
    rng = np.random.RandomState(3 + index)
    x = rng.randn(3, 1, 32).astype(np.float32)
    kc, vc = (rng.randn(3, 4, 12, 8).astype(np.float32) for _ in range(2))
    want = jS.decode_block(jnp.asarray(x), jax.tree.map(jnp.asarray, lp),
                           jnp.asarray(kc), jnp.asarray(vc), index, 4)
    # the port updates the caches in place: hand it copies
    got = tS.decode_block(torch.from_numpy(x),
                          {k: torch.from_numpy(v) for k, v in lp.items()},
                          torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()),
                          index, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("b,p", [(4, 8), (1, 5), (3, 26)])
def test_generator_ids_equal_jax(jax_side, b, p):
    prompts = _prompts(b, p, seed=b + p)
    want = _jax_ids(jax_side, prompts)
    prog, params = _port_generator(jax_side)
    launches = tfa.flash_fwd_launches
    got = _port_ids(prog, params, torch.from_numpy(prompts))
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, MAX_NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(want.ravel().tolist())) > 2   # the test decodes, not repeats
    assert tfa.flash_fwd_launches == launches   # CPU: the plain version


@pytest.mark.parametrize("training_only", [{"dropout": 0.1}, {"remat": True},
                                           {"fused_ce": False, "ce_chunk": 16}])
def test_generator_ignores_training_only_fields_as_jax_does(jax_side, training_only):
    """dropout/remat/fused_ce/ce_chunk belong to the training program; a
    generator built from a config that sets them serves the same ids in
    both packages."""
    prompts = _prompts(2, 8, seed=21)
    jprog = pt.build(jgpt.make_generator(_cfg(**training_only), max_new_tokens=MAX_NEW))
    want, _ = jprog.apply(jax.tree.map(jnp.asarray, jax_side[1]), jax_side[2], prompts)
    got = _port_ids(*_port_generator(jax_side, **training_only), prompts).numpy()
    np.testing.assert_array_equal(got, np.asarray(want["ids"]))
    np.testing.assert_array_equal(got, _jax_ids(jax_side, prompts))


def test_npz_encoding_matches_jax_flatten():
    rng = np.random.RandomState(4)
    import ml_dtypes
    tree = {"w": rng.randn(3, 4).astype(np.float32),
            "h": rng.randn(5).astype(ml_dtypes.bfloat16),
            "odd@bfloat16": np.arange(4, dtype=np.uint16),
            "tag@raw": np.arange(3, dtype=np.int32),
            "nested": {"i": np.arange(2, dtype=np.int32)}}
    want = jio._flatten(tree)
    ported = {k: (torch.from_numpy(v.view(np.uint16).view(np.int16)).view(torch.bfloat16)
                  if v.dtype.name == "bfloat16" else torch.from_numpy(v))
              if not isinstance(v, dict) else
              {kk: torch.from_numpy(vv) for kk, vv in v.items()}
              for k, v in tree.items()}
    got = tio._flatten(ported)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    back = tio._unflatten(got)
    assert back["h"].dtype == torch.bfloat16
    assert sorted(back) == sorted(tree)
    np.testing.assert_array_equal(back["odd@bfloat16"].numpy(), tree["odd@bfloat16"])


@pytest.fixture(scope="module")
def artifact(jax_side, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_decoder") / "decoder")
    tdecode.export_decoder(d, _tcfg(), MAX_NEW, _prompts(4, 8),
                           params=tgpt.params_from_jax(jax_side[1], device=CPU),
                           batch_buckets=[1, 4], device=CPU)
    return d


def test_save_load_inference_model_round_trip(jax_side, artifact):
    assert sorted(os.listdir(artifact)) == ["manifest.json", "meta.json", "params.npz",
                                            "state.npz"]
    with open(os.path.join(artifact, "meta.json")) as f:
        meta = json.load(f)
    assert meta["program_factory"] == "paddle_tpu_torch.models.gpt:make_generator"
    assert meta["program_kwargs"]["cfg"] == dataclasses_asdict(_tcfg())
    assert meta["compute_dtype"] == "float32"
    assert meta["feed_names"] == ["prompt_ids"]
    assert meta["batch_size"] == 4 and meta["batch_buckets"] == [1, 4]
    assert meta["batched_feeds"] == ["prompt_ids"]
    assert meta["program_kwargs"]["max_new_tokens"] == MAX_NEW
    with np.load(os.path.join(artifact, "params.npz")) as z:
        assert sorted(z.files) == sorted(jax_side[1])
        for k in z.files:
            np.testing.assert_array_equal(z[k], jax_side[1][k])
    pred = tio.load_inference_model(artifact, device=CPU)
    assert pred.batch_buckets == [1, 4]
    prompts = _prompts(4, 8, seed=11)
    np.testing.assert_array_equal(pred.run({"prompt_ids": prompts})["ids"].numpy(),
                                  _jax_ids(jax_side, prompts))
    # overwriting commits atomically and leaves no temp siblings behind
    tdecode.export_decoder(artifact, _tcfg(), MAX_NEW, _prompts(4, 8),
                           params=pred.program.params,
                           batch_buckets=[1, 4], device=CPU)
    parent = os.path.dirname(artifact)
    assert [n for n in os.listdir(parent) if ".tmp." in n] == []


BAD_FEEDS = {
    "missing": ({}, "prompt_ids.*missing"),
    "extra": ({"prompt_ids": _prompts(4, 8), "extra_key": np.zeros(3)},
              "extra_key.*not a feed"),
    "shape": ({"prompt_ids": _prompts(4, 7)}, "prompt_ids.*shape"),
    "dtype": ({"prompt_ids": _prompts(4, 8).astype(np.float32)},
              "prompt_ids.*dtype"),
    "off_bucket": ({"prompt_ids": _prompts(3, 8)}, "not a precompiled bucket"),
    "empty": ({"prompt_ids": _prompts(4, 8)[:0]}, "empty batch"),
    "scalar": ({"prompt_ids": np.int32(5)}, "must be batched"),
}


@pytest.mark.parametrize("case", sorted(BAD_FEEDS))
def test_validate_feed_rejects_bad_feeds(artifact, case):
    pred = tio.load_inference_model(artifact, device=CPU)
    feed, match = BAD_FEEDS[case]
    with pytest.raises(tio.InvalidRequest, match=match) as ei:
        pred.run(feed)
    assert ei.value.field in ("prompt_ids", "extra_key")


def test_validate_feed_accepts_int64_and_pads_in_server(artifact):
    pred = tio.load_inference_model(artifact, device=CPU)
    prompts = _prompts(4, 8, seed=12)
    assert pred.validate_feed({"prompt_ids": prompts.astype(np.int64)}) == (4, 4)
    assert pred.validate_feed({"prompt_ids": prompts[:3]},
                              allow_padding=True) == (3, 4)
    with pytest.raises(tio.InvalidRequest, match="exceeds the largest"):
        pred.validate_feed({"prompt_ids": _prompts(5, 8)}, allow_padding=True)
    np.testing.assert_array_equal(
        pred.run({"prompt_ids": prompts.astype(np.int64)})["ids"].numpy(),
        pred.run({"prompt_ids": prompts})["ids"].numpy())


def test_decode_server_coalesces_and_matches_sequential(jax_side, artifact):
    """The port's analogue of the JAX package's served decode test:
    single-prompt requests coalesced by the batching scheduler return
    the ids each prompt gets from a sequential ``Predictor.run``, and
    the JAX program's ids."""
    pred = tio.load_inference_model(artifact, device=CPU)
    prompts = _prompts(4, 8, seed=13)
    sequential = [pred.run({"prompt_ids": prompts[i:i + 1]})["ids"].numpy()
                  for i in range(4)]
    srv = tdecode.decode_server(artifact, max_wait_ms=200.0, workers=1,
                                device=CPU)
    try:
        pends = [srv.submit({"prompt_ids": prompts[i:i + 1]}) for i in range(4)]
        outs = [p.result(timeout=120)["ids"].numpy() for p in pends]
        rep = srv.report()
    finally:
        srv.close(drain=True, timeout=60)
    want = _jax_ids(jax_side, prompts)
    for i in range(4):
        np.testing.assert_array_equal(outs[i], sequential[i])
        np.testing.assert_array_equal(outs[i], want[i:i + 1])
    assert rep["coalesced_requests"] >= 2
    assert rep["completed"] == 4 and rep["errors"] == 0
    assert srv.health()["state"] == "stopped"


def test_decode_server_warms_each_bucket_once(artifact, monkeypatch):
    calls = []
    call = tgpt._GenerateProgram.__call__

    def counted(self, prompt_ids):
        calls.append(int(prompt_ids.shape[0]))
        return call(self, prompt_ids)

    monkeypatch.setattr(tgpt._GenerateProgram, "__call__", counted)
    srv = tdecode.decode_server(artifact, workers=1, device=CPU)
    srv.close(drain=True, timeout=60)
    assert sorted(calls) == [1, 4]


def test_fresh_init_has_the_jax_fans_and_limits():
    """Torch and JAX draw different random streams, so a fresh init is
    held to the JAX one by its statistics: the same shapes, constants
    where JAX has constants, and uniform draws inside the same Xavier
    limit (per layer for the stacked weights) with the variance of a
    uniform on it (limit**2 / 3, within 10%)."""
    cfg = _cfg(vocab_size=500, d_model=64, d_inner=256)
    prog = pt.build(jgpt.make_generator(cfg, max_new_tokens=2))
    jparams, _ = prog.init(jax.random.PRNGKey(0), _prompts(2, 4))
    tcfg = _tcfg(vocab_size=500, d_model=64, d_inner=256)

    def port_init(seed):
        prog = ptt.build(tgpt.make_generator(tcfg, 2))
        return prog.init(seed, prompt_ids=_prompts(2, 4), place=CPU)[0]

    tparams = port_init(0)
    assert sorted(tparams) == sorted(jparams)
    for name, j in jparams.items():
        j = np.asarray(j)
        t = tparams[name].numpy()
        assert t.shape == j.shape and t.dtype == j.dtype, name
        if j.std() == 0:
            np.testing.assert_array_equal(t, j)
            continue
        limit = np.abs(j).max()
        assert np.abs(t).max() <= limit * 1.01, name
        np.testing.assert_allclose(t.var(), j.var(), rtol=0.1, err_msg=name)
    # a seed makes the same weights twice, another seed other weights
    again, other = port_init(0), port_init(1)
    w = "gpt/encoder_stack/qkv/w"
    assert torch.equal(again[w], tparams[w]) and not torch.equal(other[w], tparams[w])


# -- the serving core on a stand-in program (no JAX side) ----------------------

import sys  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

from paddle_tpu_torch import serving as tserving  # noqa: E402
from paddle_tpu_torch.fleet import BatchPolicy  # noqa: E402


class _Doubler:
    """A program with the generator's calling convention: feeds in as
    tensors, a dict of tensors out (optionally slow, to fill the queue)."""

    device = torch.device(CPU)

    def __init__(self, delay=0.0):
        self.delay = delay

    def __call__(self, x):
        if self.delay:
            time.sleep(self.delay)
        return {"y": x * 2}


def _doubler_predictor(delay=0.0, buckets=(1, 4, 8)):
    return tio.Predictor(_Doubler(delay), ["x"],
                         {"x": {"shape": [8, 3], "dtype": "float32"}},
                         batch_size=8, batched_feeds=["x"], batch_buckets=buckets)


def test_server_stress_many_workers_keeps_every_count():
    """More worker threads than cores, a short switch interval and
    concurrent submitters: every request gets its own rows back, and no
    counter update is lost."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    n_threads, per_thread = 8, 25
    errors, results = [], {}
    srv = tserving.PredictorServer(_doubler_predictor(), workers=16,
                                   queue_size=n_threads * per_thread,
                                   batch_policy=BatchPolicy(max_wait_ms=1.0))

    def client(t):
        try:
            for i in range(per_thread):
                x = np.full((1 + (i % 3), 3), t * 1000 + i, np.float32)
                results[(t, i)] = (x, srv.submit({"x": x}))
        except Exception as e:  # noqa: BLE001 - surfaced by the assert below
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
        for x, pend in results.values():
            np.testing.assert_array_equal(pend.result(timeout=60)["y"].numpy(), 2 * x)
        rep = srv.report()
    finally:
        srv.close(drain=True, timeout=60)
        sys.setswitchinterval(old)
    assert errors == []
    n = n_threads * per_thread
    assert rep["submitted"] == n and rep["completed"] == n
    assert rep["latency_ms"]["count"] == n and rep["errors"] == 0


def _wait_busy(srv):
    deadline = time.monotonic() + 30
    while srv.health()["workers_busy"] == 0:
        assert time.monotonic() < deadline, "the worker never took a request"
        time.sleep(0.005)


def test_server_overload_deadline_and_close_are_typed():
    srv = tserving.PredictorServer(_doubler_predictor(delay=0.5), workers=1,
                                   queue_size=2, warmup=False)
    x = np.ones((1, 3), np.float32)
    try:
        busy = srv.submit({"x": x})
        _wait_busy(srv)
        late = srv.submit({"x": x}, deadline=0.01)  # expires while queued
        queued = srv.submit({"x": x})
        with pytest.raises(tserving.ServerOverloaded) as ei:
            srv.submit({"x": x})
        assert ei.value.capacity == 2
        with pytest.raises(tserving.InvalidRequest, match="x.*non-finite"):
            srv.submit({"x": np.full((1, 3), np.nan, np.float32)})
        np.testing.assert_array_equal(busy.result(timeout=10)["y"].numpy(), 2 * x)
        with pytest.raises(tserving.DeadlineExceeded):
            late.result(timeout=10)
        queued.result(timeout=10)
        rep = srv.report()
        assert rep["rejected_overload"] == 1 and rep["rejected_invalid"] == 1
        assert rep["timeouts"] == 1
    finally:
        srv.close(drain=False)
    with pytest.raises(tserving.ServerClosed):
        srv.submit({"x": x})


def test_server_close_without_drain_fails_queued_requests():
    srv = tserving.PredictorServer(_doubler_predictor(delay=0.5), workers=1,
                                   queue_size=8, warmup=False)
    x = np.ones((1, 3), np.float32)
    first = srv.submit({"x": x})
    _wait_busy(srv)
    rest = [srv.submit({"x": x}) for _ in range(3)]
    srv.close(drain=False)
    first.result(timeout=10)  # already dispatched: it finishes
    for p in rest:
        with pytest.raises(tserving.ServerClosed):
            p.result(timeout=10)
    assert srv.health()["state"] == "stopped"
