"""The Transformer's served decoder from static buffers
(``models/transformer.make_decoder`` over
``_captured_decode.CapturedEncDecDecode``) on the CPU, where the decoder
step the card captures and replays runs as a plain call: greedy and beam
ids and scores against ``paddle_tpu``'s ``make_decoder``, the
static-buffer decode against the plain loop (``_eager_decode``), the
attention cache at a device index against an int index, and the
lifecycle of the static state (a new params dict read by the next call,
the signatures bounded, a ``Predictor`` keeping each bucket's, calls
serialised across threads).

A small encoder-decoder (vocab 100, d_model 64, d_inner 128, 4 heads, 2+2
layers, ``max_len`` 10, flash attention in the encoder) is initialised in
``paddle_tpu``, its params jittered from a numpy seed and carried across
with ``params_from_jax``. Tolerances: token ids exactly; beam scores
within 1e-5 of the JAX package's, relative (sums of ten f32 log-probs of
magnitude ~1, from products summed in another order: 3e-6 read); the
static-buffer decode against the plain
loop, and a tensor index against an int one, bit for bit (the same
operations on the same values)."""

import threading
import weakref

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as jpt
from paddle_tpu.models import transformer as jtr

import paddle_tpu_torch as tpt
from paddle_tpu_torch import _captured_decode
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.framework import params_from_jax
from paddle_tpu_torch.layers import attention as tA
from paddle_tpu_torch.models import transformer as ttr

CPU = "cpu"
MAX_LEN = 10
SMALL = dict(src_vocab=100, trg_vocab=100, max_len=32, d_model=64, d_inner=128,
             num_heads=4, num_encoder_layers=2, num_decoder_layers=2, dropout=0.0,
             use_flash=True)
SCORE_TOL = 1e-5


def _src(b=3, s=9, seed=3):
    src = np.random.RandomState(seed).randint(3, 100, (b, s)).astype(np.int32)
    src[1 % b, -2:] = 0  # padding: the encoder's key bias masks it
    return src


def _cfg(fuse_qkv, **kw):
    return ttr.base_config(**dict(SMALL, fuse_qkv=fuse_qkv, **kw))


@pytest.fixture(scope="module")
def jax_params():
    """{fuse_qkv: jittered params of the JAX-initialised model}."""
    out = {}
    for fuse in (False, True):
        prog = jpt.build(jtr.make_model(jtr.base_config(**SMALL, fuse_qkv=fuse)))
        feed = {k: _src(2, 8, seed) for seed, k in enumerate(("src_ids", "trg_ids",
                                                               "labels"))}
        params, _ = prog.init(jax.random.PRNGKey(0), **feed)
        rng = np.random.RandomState(1)
        out[fuse] = {k: np.asarray(v) + 0.3 * rng.randn(*v.shape).astype(np.float32)
                     for k, v in sorted(params.items())}
    return out


def _params(jax_params, fuse_qkv=True, shift=0.0):
    return {k: v + shift for k, v in
            params_from_jax(jax_params[fuse_qkv], device=CPU).items()}


def _program(fuse_qkv=True, beam=1, alpha=0.0, max_len=MAX_LEN):
    return tpt.build(ttr.make_decoder(_cfg(fuse_qkv), max_len=max_len, beam_size=beam,
                                      length_penalty_alpha=alpha))


def _run(prog, params, src):
    return prog.apply(params, {}, src_ids=src, place=CPU)[0]


def _eager(prog, params, src):
    with ttr._eager_decode():
        return _run(prog, params, src)


def _equal(a, b):
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("beam,alpha", [(1, 0.0), (2, 0.0), (2, 0.6), (4, 0.0),
                                        (4, 0.6)])
@pytest.mark.parametrize("fuse_qkv", [False, True])
def test_decoder_matches_jax(jax_params, fuse_qkv, beam, alpha):
    src = _src()
    jprog = jpt.build(jtr.make_decoder(jtr.base_config(**SMALL, fuse_qkv=fuse_qkv),
                                       max_len=MAX_LEN, beam_size=beam,
                                       length_penalty_alpha=alpha))
    want, _ = jprog.apply({k: jnp.asarray(v) for k, v in jax_params[fuse_qkv].items()},
                          {}, src)
    got = _run(_program(fuse_qkv, beam, alpha), _params(jax_params, fuse_qkv), src)
    shape = (3, MAX_LEN) if beam == 1 else (3, beam, MAX_LEN)
    assert got["ids"].dtype == torch.int32 and tuple(got["ids"].shape) == shape
    np.testing.assert_array_equal(got["ids"].numpy(), np.asarray(want["ids"]))
    if beam > 1:
        np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                                   rtol=SCORE_TOL, atol=0)
    assert len(set(np.asarray(want["ids"]).ravel().tolist())) > 1  # not one token


@pytest.mark.parametrize("beam,alpha,dtype", [(1, 0.0, "float32"), (3, 0.6, "float32"),
                                              (1, 0.0, "bfloat16"), (4, 0.6, "bfloat16")])
def test_static_buffer_decode_equals_the_plain_loop(jax_params, beam, alpha, dtype):
    """The decode the card replays, called plainly, against the plain loop
    over a state each step replaces: the same bits, at f32 and bf16
    compute, call after call on the same buffers."""
    prog = _program(True, beam, alpha)
    params = _params(jax_params)
    with tpt.amp_guard(dtype):
        for seed in (3, 4):
            src = _src(seed=seed)
            got, want = _run(prog, params, src), _eager(prog, params, src)
            assert _equal(got, want), seed
    states = prog.fn._states
    assert len(states) == 1
    dec = next(iter(states.values()))
    assert isinstance(dec, _captured_decode.CapturedEncDecDecode)
    assert dec.signature == (3 * beam, 9, MAX_LEN, beam, torch.float32)
    assert dec.graph is None and dec.replays == 0  # the CPU calls the step
    # 2 layers, k and v, [3·beam rows, 4 heads, MAX_LEN positions, 16] f32
    assert dec.cache_bytes() == 2 * 2 * 3 * beam * 4 * MAX_LEN * 16 * 4


def _mha_program(index_kind):
    def attend(x, k, v, index):
        idx = int(index) if index_kind == "int" else index.to(torch.int32)
        cache = {"k": k, "v": v, "index": idx}
        out, new = tA.multi_head_attention(x, num_heads=4, cache=cache, fuse_qkv=True)
        return {"out": out, "k": new["k"], "v": new["v"], "index": new["index"]}
    return tpt.build(attend)


def test_tensor_index_equals_int_index_at_every_position():
    """multi_head_attention's cache path with a 0-dim int32 tensor index
    writes, masks and advances as the int index does, at every position;
    the advanced index stays a tensor."""
    rng = np.random.RandomState(5)
    T = 7
    x = torch.from_numpy(rng.randn(3, 1, 32).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(3, 4, T, 8).astype(np.float32)) for _ in range(2))
    by_int, by_tensor = _mha_program("int"), _mha_program("tensor")
    params, _ = by_int.init(0, x, k.clone(), v.clone(), torch.tensor(0), place=CPU)
    for index in range(T):
        want = by_int.apply(params, {}, x, k.clone(), v.clone(), torch.tensor(index),
                            place=CPU)[0]
        got = by_tensor.apply(params, {}, x, k.clone(), v.clone(), torch.tensor(index),
                              place=CPU)[0]
        assert isinstance(want["index"], int) and want["index"] == index + 1
        assert got["index"].dtype == torch.int32 and got["index"].ndim == 0
        assert int(got["index"]) == index + 1
        for name in ("out", "k", "v"):
            assert torch.equal(got[name], want[name]), (index, name)


def test_decoder_step_reads_its_index_on_the_device(jax_params, monkeypatch):
    """No host read in a call's decode steps: with every read-back of a
    tensor refused, the static-buffer decode still runs and gives the
    plain loop's ids."""
    prog = _program(True, 2, 0.6)
    params, src = _params(jax_params), _src()
    want = _eager(prog, params, src)
    _run(prog, params, src)  # builds the state (its first step finds the weights)
    dec = next(iter(prog.fn._states.values()))
    enc_out, src_mask = dec.enc_out[::2].clone(), dec.src_mask[::2].clone()

    def refuse(*a, **k):
        raise AssertionError("a tensor was read back to the host")

    for name in ("item", "tolist", "__int__", "__index__", "__bool__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    with torch.inference_mode():
        got = dec.run(enc_out, src_mask)
    monkeypatch.undo()
    assert _equal(got, want)


def test_a_second_params_dict_is_read_by_the_next_call(jax_params):
    """The state's static weights are copies refreshed from each call's
    params: a call with another params dict gives that dict's eager ids,
    from the same buffers (no stale read, no rebuild)."""
    prog = _program(True, 2, 0.0)
    src = _src()
    first, second = _params(jax_params), _params(jax_params, shift=0.05)
    out1 = _run(prog, first, src)
    dec, weights = next(iter(prog.fn._states.values())), prog.fn._weights
    assert all(w.data_ptr() != first[n].data_ptr() for n, w in weights.items())
    assert not any(n.startswith(("src/", "encoder/")) for n in weights)
    out2 = _run(prog, second, src)
    assert _equal(out2, _eager(prog, second, src)) and not _equal(out1, out2)
    assert next(iter(prog.fn._states.values())) is dec and prog.fn._weights is weights
    # the first dict again: its own ids
    assert _equal(_run(prog, first, src), out1)
    # params that do not fit the static copies (another dtype) replace them
    # and drop every state that read them
    wide = {k: v.double() if k.startswith("decoder/") else v for k, v in first.items()}
    assert _equal(_run(prog, wide, src), _eager(prog, wide, src))
    assert prog.fn._weights is not weights
    assert next(iter(prog.fn._states.values())) is not dec
    assert {w.dtype for n, w in prog.fn._weights.items() if n.startswith("decoder/")} \
        == {torch.float64}


def test_signatures_are_bounded_and_share_one_set_of_weights(jax_params):
    """Calls at many source lengths keep at most ``max_signatures`` states,
    the least recently called dropped first with its buffers; every one
    reads the program's one set of static weights."""
    prog = _program(True, 1, 0.0, max_len=4)
    params = _params(jax_params)
    fn = prog.fn
    limit = fn.max_signatures
    lengths = list(range(2, limit + 6))
    refs = {}
    for s in lengths:
        _run(prog, params, _src(2, s, seed=s))
        refs[s] = weakref.ref(fn._states[((2, s), torch.device(CPU), torch.float32,
                                          torch.float32)])
    kept = lengths[-limit:]
    assert [k[0] for k in fn._states] == [(2, s) for s in kept]
    _run(prog, params, _src(2, kept[0], seed=kept[0]))  # now the newest
    fresh = lengths[-1] + 1
    _run(prog, params, _src(2, fresh, seed=fresh))
    kept = kept[2:] + [kept[0], fresh]
    assert [k[0] for k in fn._states] == [(2, s) for s in kept]
    import gc
    gc.collect()
    assert sorted(s for s, r in refs.items() if r() is not None) == sorted(kept[:-1])
    ptrs = {n: w.data_ptr() for n, w in fn._weights.items()}
    src = _src(2, lengths[0], seed=lengths[0])
    assert _equal(_run(prog, params, src), _eager(prog, params, src))
    assert {n: w.data_ptr() for n, w in fn._weights.items()} == ptrs


def test_a_predictor_keeps_every_buckets_state(jax_params, tmp_path, monkeypatch):
    """A served artifact with more buckets than ``max_signatures`` keeps
    each bucket's state: the loader's warm-up builds them, requests reuse
    them, and each gives the plain loop's ids."""
    monkeypatch.setattr(ttr._DecodeProgram, "max_signatures", 2)
    src = _src(4, 9, seed=8)
    d = str(tmp_path / "decoder")
    tio.save_inference_model(d, _program(True), jax_params[True], {}, {"src_ids": src},
                             batch_buckets=[1, 2, 4])
    pred = tio.load_inference_model(d, device=CPU)
    assert pred.program.max_signatures == 3
    built = dict(pred.program.program.fn._states)
    assert sorted(k[0] for k in built) == [(1, 9), (2, 9), (4, 9)]
    prog, params = _program(True), _params(jax_params)
    for b in (1, 4, 2):
        assert torch.equal(pred.run({"src_ids": src[:b]})["ids"],
                           _eager(prog, params, src[:b])["ids"])
    states = pred.program.program.fn._states
    assert sorted(states) == sorted(built) and all(states[k] is built[k] for k in built)


def test_concurrent_calls_are_serialised(jax_params):
    prog = _program(True, 2, 0.6)
    params = _params(jax_params)
    srcs = [_src(seed=s) for s in range(4)]
    want = [_eager(prog, params, s) for s in srcs]
    results, errors = {}, []

    def client(i):
        try:
            for _ in range(3):
                results.setdefault(i, []).append(_run(prog, params, srcs[i]))
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
        assert len(results[i]) == 3 and all(_equal(r, want[i]) for r in results[i])


def test_init_and_training_runs_take_the_plain_loop(jax_params):
    """``Program.init`` creates the decoder's params through the plain loop
    (no static state), and so does a run in training mode."""
    prog = _program(True)
    params, _ = prog.init(0, place=CPU, src_ids=_src())
    assert sorted(params) == sorted(jax_params[True]) and prog.fn._states == {}
    out = prog.apply(_params(jax_params), {}, src_ids=_src(), training=True, rng=0,
                     place=CPU)[0]
    assert prog.fn._states == {} and tuple(out["ids"].shape) == (3, MAX_LEN)
