"""The GPT generator's decode from static buffers (``_captured_decode``)
on the CPU, where the step the card captures and replays runs as a plain
call: beam search and both cache dtypes against ``paddle_tpu``'s
``make_generator``, the static-buffer body against the plain loop
(``eager_decode``), the device-index decode blocks
against their int-index form, and the lifecycle of the captured steps
(reused across calls and across params dicts, which never read each
other's copies, serialised across threads, carried through an inference
artifact).

A small GPT (vocab 97, d 32, 4 heads, 2 layers, max_len 32) is built and
initialised in ``paddle_tpu``, its params jittered from a numpy seed and
carried across with ``params_from_jax``. Tolerances: token ids exactly;
beam scores within 1e-5 of the JAX package's (sums of f32 log-probs from
blocks summed in another order); the static-buffer body against the
plain loop, and a tensor index against an int one, bit for bit (the same
operations on the same values)."""

import gc
import threading
import weakref

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as pt
from paddle_tpu.models import gpt as jgpt

import paddle_tpu_torch as ptt
from paddle_tpu_torch import _captured_decode
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.layers import stacked as tS
from paddle_tpu_torch.models import gpt as tgpt

CPU = "cpu"
MAX_NEW = 6
SMALL = dict(vocab_size=97, max_len=32, d_model=32, d_inner=64, num_heads=4,
             num_layers=2, use_flash=True)
SCORE_TOL = 1e-5


def _prompts(b=3, p=8, seed=0):
    return np.random.RandomState(seed).randint(3, 97, (b, p)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_params():
    prog = pt.build(jgpt.make_generator(jgpt.base_config(**SMALL), max_new_tokens=MAX_NEW))
    params, _ = prog.init(jax.random.PRNGKey(0), _prompts())
    rng = np.random.RandomState(1)
    return {k: np.asarray(v) + 0.3 * rng.randn(*v.shape).astype(np.float32)
            for k, v in params.items()}


class _Gen:
    """``build(make_generator(...))`` with its params: a call applies the
    program (the static-buffer decode), :meth:`eager` runs it under
    ``eager_decode`` (the plain loop), both under ``amp_guard(compute)``."""

    def __init__(self, prog, params, compute="float32"):
        self.prog, self.params, self.compute = prog, params, compute

    @property
    def fn(self):
        return self.prog.fn

    def __call__(self, prompts, params=None):
        with ptt.amp_guard(self.compute):
            out, _ = self.prog.apply(self.params if params is None else params, {},
                                     prompt_ids=prompts, place=CPU)
        return out

    def eager(self, prompts, params=None):
        with _captured_decode.eager_decode():
            return self(prompts, params)


def _gen(jax_params, kv="compute", beam=1, alpha=0.0, new=MAX_NEW, compute="float32"):
    prog = ptt.build(tgpt.make_generator(tgpt.base_config(**SMALL, kv_cache_dtype=kv), new,
                                         beam_size=beam, length_penalty_alpha=alpha))
    return _Gen(prog, tgpt.params_from_jax(jax_params, device=CPU), compute)


def _jax_out(jax_params, prompts, kv="compute", beam=1, alpha=0.0):
    prog = pt.build(jgpt.make_generator(jgpt.base_config(**SMALL, kv_cache_dtype=kv),
                                        max_new_tokens=MAX_NEW, beam_size=beam,
                                        length_penalty_alpha=alpha))
    _, state = prog.init(jax.random.PRNGKey(0), prompts)
    out, _ = prog.apply(jax.tree.map(jnp.asarray, jax_params), state, prompts)
    return {k: np.asarray(v) for k, v in out.items()}


def _equal(a, b):
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("kv", ["compute", "int8"])
@pytest.mark.parametrize("alpha", [0.0, 0.7])
def test_beam_generator_matches_jax(jax_params, kv, alpha):
    prompts = _prompts(3, 8, seed=4)
    want = _jax_out(jax_params, prompts, kv, beam=3, alpha=alpha)
    got = _gen(jax_params, kv, beam=3, alpha=alpha)(torch.from_numpy(prompts))
    assert got["ids"].dtype == torch.int32 and tuple(got["ids"].shape) == (3, 3, MAX_NEW)
    assert got["scores"].dtype == torch.float32 and tuple(got["scores"].shape) == (3, 3)
    np.testing.assert_array_equal(got["ids"].numpy(), want["ids"])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"], rtol=0, atol=SCORE_TOL)
    assert (np.diff(got["scores"].numpy(), axis=1) <= 0).all()   # best first


@pytest.mark.parametrize("kv,beam", [("compute", 1), ("compute", 4), ("int8", 1)])
def test_build_program_matches_jax(jax_params, kv, beam):
    """``build(make_generator(...))`` with the JAX params gives the JAX
    program's ids (and its beam scores within 1e-5, relative), greedy,
    beam 4 and over the int8 cache."""
    prompts = _prompts(2, 8, seed=11)
    want = _jax_out(jax_params, prompts, kv, beam=beam)
    got = _gen(jax_params, kv, beam=beam)(torch.from_numpy(prompts))
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["ids"].numpy(), want["ids"])
    if beam > 1:
        np.testing.assert_allclose(got["scores"].numpy(), want["scores"], rtol=1e-5, atol=0)


@pytest.mark.parametrize("kv,beam", [("compute", 1), ("compute", 4), ("int8", 1),
                                     ("int8", 2)])
def test_static_buffer_body_equals_the_plain_loop(jax_params, kv, beam):
    """The body the card captures, run on the CPU, gives the plain loop's
    ids and scores bit for bit, call after call (every call resets the
    buffers it reads)."""
    gen = _gen(jax_params, kv, beam)
    for seed in (5, 6, 5):
        prompts = torch.from_numpy(_prompts(3, 7, seed=seed))
        assert _equal(gen(prompts), gen.eager(prompts))
    assert list(gen.fn._decoders) == [(3, 7)]
    dec = gen.fn._decoders[(3, 7)]
    assert dec.graph is None and not dec.on_card and dec.captures == 0
    assert dec.signature == (3 * beam, 7, MAX_NEW, beam, kv)
    # the buffers hold the last call's state: index past the last cached token
    assert int(dec.index) == 7 + MAX_NEW - 1 and int(dec.step) == MAX_NEW


def test_greedy_matches_jax_call_after_call(jax_params):
    gen = _gen(jax_params)
    for b, p, seed in ((3, 8, 0), (1, 5, 1), (3, 8, 2), (2, 26, 3)):
        prompts = _prompts(b, p, seed)
        np.testing.assert_array_equal(gen(torch.from_numpy(prompts))["ids"].numpy(),
                                      _jax_out(jax_params, prompts)["ids"])
    assert sorted(gen.fn._decoders) == [(1, 5), (2, 26), (3, 8)]


def test_one_new_token_runs_no_step(jax_params):
    gen = _gen(jax_params, beam=2, new=1)
    prompts = torch.from_numpy(_prompts(2, 4))
    assert _equal(gen(prompts), gen.eager(prompts))


@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_tensor_index_equals_int_index_at_every_position(jax_params, kv):
    """decode_block and decode_block_q8 with a 0-dim int32 tensor index
    write and mask what the int index does, at every position."""
    gen = _gen(jax_params, kv)
    lp = gen.fn.weights(gen.params).layers[1]
    rng = np.random.RandomState(3)
    T = 12
    x = torch.from_numpy(rng.randn(3, 1, 32).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(3, 4, T, 8).astype(np.float32)) for _ in range(2))
    caches = (k, v) if kv == "compute" else tS.quantize_kv(k) + tS.quantize_kv(v)
    block = tS.decode_block if kv == "compute" else tS.decode_block_q8
    for index in range(T):
        by_int = block(x, lp, *(c.clone() for c in caches), index, 4)
        by_tensor = block(x, lp, *(c.clone() for c in caches),
                          torch.tensor(index, dtype=torch.int32), 4)
        for a, b in zip(by_int, by_tensor):
            assert torch.equal(a, b), index


def test_decode_step_reads_its_index_on_the_device(jax_params, monkeypatch):
    """No host read of the index in a step: a tensor that refuses to be
    read back still decodes."""
    gen = _gen(jax_params, "int8")
    prompts = torch.from_numpy(_prompts(2, 6))
    want = gen.eager(prompts)

    def refuse(*a, **k):
        raise AssertionError("the index was read back to the host")

    for name in ("item", "tolist", "__int__", "__index__", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    got = gen(prompts)
    monkeypatch.undo()
    assert _equal(got, want)


@pytest.mark.parametrize("other", ["jittered", "fresh_init"])
def test_params_dicts_alternate_with_no_stale_copies(jax_params, other):
    """Calls that alternate between two params dicts each decode from
    their own params: every call copies its params into the static
    weights, so no call reads the last one's, and the decodes are kept."""
    gen = _gen(jax_params, beam=2)
    prompts = torch.from_numpy(_prompts(2, 6))
    if other == "jittered":
        params_b = {k: t + 0.05 for k, t in gen.params.items()}
    else:
        params_b = gen.prog.init(3, prompt_ids=prompts, place=CPU)[0]
    want_a, want_b = gen.eager(prompts), gen.eager(prompts, params_b)
    assert not torch.equal(want_a["scores"], want_b["scores"])
    first = None
    for params, want in ((None, want_a), (params_b, want_b), (None, want_a),
                         (params_b, want_b)):
        assert _equal(gen(prompts, params), want)
        dec = gen.fn._decoders[(2, 6)]
        first = first or dec
        assert dec is first and dec.weights is gen.fn._weights


def test_weight_casts_are_refreshed_every_call(jax_params):
    """A bf16-compute generator reads copies of the f32 stack cast to bf16
    once a call; an in-place change of a param reaches the next call."""
    gen = _gen(jax_params, compute="bfloat16")
    prompts = torch.from_numpy(_prompts(2, 6))
    before = gen(prompts)
    assert _equal(before, gen.eager(prompts))
    w = gen.fn._weights
    assert w.layers[0]["ffn_in/w"].dtype == torch.bfloat16
    assert w.layers[0]["ffn_in/b"].dtype == torch.float32
    with torch.no_grad():
        gen.params["gpt/encoder_stack/ffn_in/w"].mul_(-1.0)
        gen.params["lm_head_0/w"].mul_(1.5)
    after = gen(prompts)
    assert gen.fn._weights is w   # copied into, not rebuilt
    assert _equal(after, gen.eager(prompts))
    assert not torch.equal(after["ids"], before["ids"])
    # another compute dtype is another set of copies, and new decodes
    gen.compute = "float32"
    assert _equal(gen(prompts), gen.eager(prompts))
    assert gen.fn._weights is not w and w.layers[0]["ffn_in/w"].dtype == torch.bfloat16


def test_signatures_are_bounded_and_share_one_set_of_weights(jax_params):
    """Calls at many prompt lengths keep at most ``max_signatures`` sets of
    static buffers alive, the least recently called dropped first, and
    every set reads the generator's one set of weight casts: what a
    generator holds does not grow with the number of prompt lengths."""
    gen = _gen(jax_params, beam=2, compute="bfloat16")
    limit = gen.fn.max_signatures
    lengths = list(range(1, limit + 6))
    refs = {}
    for p in lengths:
        gen(torch.from_numpy(_prompts(2, p, seed=p)))
        refs[p] = weakref.ref(gen.fn._decoders[(2, p)])
    kept = lengths[-limit:]
    assert list(gen.fn._decoders) == [(2, p) for p in kept]
    # a call at the oldest kept length makes it the newest; a new length
    # then drops the next oldest
    gen(torch.from_numpy(_prompts(2, kept[0], seed=kept[0])))
    fresh = lengths[-1] + 1
    gen(torch.from_numpy(_prompts(2, fresh, seed=fresh)))
    refs[fresh] = weakref.ref(gen.fn._decoders[(2, fresh)])
    kept = kept[2:] + [kept[0], fresh]
    assert list(gen.fn._decoders) == [(2, p) for p in kept]
    gc.collect()
    assert sorted(p for p, r in refs.items() if r() is not None) == sorted(kept)
    weights = gen.fn._weights
    for dec in gen.fn._decoders.values():
        assert dec.weights is weights
    # a dropped signature is built again and decodes as before
    prompts = torch.from_numpy(_prompts(2, lengths[0], seed=lengths[0]))
    assert _equal(gen(prompts), gen.eager(prompts))
    assert len(gen.fn._decoders) == limit


def test_a_predictor_keeps_every_buckets_decode(jax_params, tmp_path, monkeypatch):
    """A served artifact with more buckets than ``max_signatures`` keeps
    each bucket's decode: the warm-up builds them and requests reuse them."""
    monkeypatch.setattr(tgpt._GenerateProgram, "max_signatures", 2)
    from paddle_tpu_torch.fleet import decode as tdecode

    d = str(tmp_path / "decoder")
    prompts = _prompts(4, 8, seed=8)
    tdecode.export_decoder(d, tgpt.base_config(**SMALL), MAX_NEW, prompts,
                           params=tgpt.params_from_jax(jax_params, device=CPU),
                           batch_buckets=[1, 2, 4], device=CPU)
    pred = tio.load_inference_model(d, device=CPU)
    assert pred.program.max_signatures == 3
    built = dict(pred.program.program.fn._decoders)
    assert sorted(built) == [(1, 8), (2, 8), (4, 8)]
    for b in (1, 4, 2):
        np.testing.assert_array_equal(
            pred.run({"prompt_ids": prompts[:b]})["ids"].numpy(),
            _jax_out(jax_params, prompts[:b])["ids"])
    assert all(pred.program.program.fn._decoders[k] is built[k] for k in built)


def test_concurrent_calls_are_serialised(jax_params):
    gen = _gen(jax_params, "int8", beam=2)
    prompts = [torch.from_numpy(_prompts(2, 6, seed=s)) for s in range(4)]
    want = [gen.eager(p) for p in prompts]
    results, errors = {}, []

    def client(i):
        try:
            for _ in range(3):
                results.setdefault(i, []).append(gen(prompts[i]))
        except Exception as e:  # noqa: BLE001 - surfaced by the assert below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    assert errors == []
    for i in range(4):
        assert all(_equal(r, want[i]) for r in results[i])


def test_factory_spec_carries_beam_and_an_old_artifact_asks_for_reexport(jax_params,
                                                                         tmp_path):
    gen = _gen(jax_params, "int8", beam=3, alpha=0.5)
    spec = gen.fn.factory_spec
    assert spec["factory"] == "paddle_tpu_torch.models.gpt:make_generator"
    kw = spec["kwargs"]
    assert kw["beam_size"] == 3 and kw["length_penalty_alpha"] == 0.5
    assert kw["cfg"]["kv_cache_dtype"] == "int8"
    again = tgpt.make_generator(**kw)
    assert (again.beam_size, again.length_penalty_alpha, again.cfg) == (3, 0.5, gen.fn.cfg)
    # a beam artifact serves ids and scores, each batched on dim 0
    prompts = _prompts(3, 8, seed=9)
    art = str(tmp_path / "beam")
    tio.save_inference_model(art, gen.prog, gen.params, {}, {"prompt_ids": prompts},
                             batch_buckets=[1])
    pred = tio.load_inference_model(art, device=CPU)
    out = pred.run({"prompt_ids": prompts})
    want = _jax_out(jax_params, prompts, "int8", beam=3, alpha=0.5)
    np.testing.assert_array_equal(out["ids"].numpy(), want["ids"])
    np.testing.assert_allclose(out["scores"].numpy(), want["scores"], rtol=0, atol=SCORE_TOL)
    assert tuple(pred.run({"prompt_ids": prompts[:1]})["scores"].shape) == (1, 3)
    # only a build Program exports; an artifact that names the generator's
    # old builder (written before it was a build program) asks to be
    # exported again
    with pytest.raises(ptt.core.errors.EnforceError, match="build Program"):
        tio.save_inference_model(str(tmp_path / "fn"), gen.fn, gen.params, {},
                                 {"prompt_ids": prompts})
    import json
    import os
    meta_path = os.path.join(art, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    for k in ("program_factory", "program_kwargs", "name", "layout"):
        meta.pop(k)
    meta.update(builder="models.gpt.make_generator", config=kw["cfg"], max_new_tokens=MAX_NEW)
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    os.remove(os.path.join(art, "manifest.json"))  # a legacy, unmanifested artifact
    with pytest.raises(tio.ArtifactOutdated, match="re-export"):
        tio.load_inference_model(art, device=CPU)


def test_cache_bytes_and_capture_error_type(jax_params):
    gen = _gen(jax_params, beam=2)
    gen(torch.from_numpy(_prompts(2, 6)))
    dec = gen.fn._decoders[(2, 6)]
    # 2 layers, k and v, [4 rows, 4 heads, 12 positions, 8] f32
    assert dec.cache_bytes() == 2 * 2 * 4 * 4 * 12 * 8 * 4
    assert issubclass(_captured_decode.CaptureError, RuntimeError)


def test_serving_warm_up_builds_each_buckets_decode_once(jax_params, tmp_path):
    """``load_inference_model`` runs every bucket once, which builds (on the
    card: captures) each bucket's decode; a server's warm-up and its
    requests reuse them."""
    from paddle_tpu_torch.fleet import decode as tdecode
    from paddle_tpu_torch.serving import PredictorServer

    d = str(tmp_path / "decoder")
    prompts = _prompts(4, 8, seed=7)
    tdecode.export_decoder(d, tgpt.base_config(**SMALL), MAX_NEW, prompts,
                           params=tgpt.params_from_jax(jax_params, device=CPU),
                           batch_buckets=[1, 4], device=CPU)
    pred = tio.load_inference_model(d, device=CPU)
    built = dict(pred.program.program.fn._decoders)
    assert sorted(built) == [(1, 8), (4, 8)]
    srv = PredictorServer(pred, workers=2, warmup=True)
    try:
        out = srv.run({"prompt_ids": prompts}, timeout=60)["ids"].numpy()
    finally:
        srv.close(drain=True, timeout=60)
    assert pred.program.program.fn._decoders == built
    np.testing.assert_array_equal(out, _jax_out(jax_params, prompts)["ids"])
