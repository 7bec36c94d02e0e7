"""The port's int8 KV cache against ``paddle_tpu`` on the CPU, the
counterparts of ``tests/test_int8_kv_cache.py``: ``quantize_kv`` (and
``quantize._quant_dynamic`` under it) bit-equal to the JAX quantizer, the
int8 decode block against the JAX block, the int8 GPT generator's ids
against the JAX generator's, and the batched int8 decode server equal to
sequential decoding (``tests/test_fleet.py``'s served workload).

Tolerances: the quantizer's int8 values and scales bit for bit (the same
f32 operations in the same order, round half to even in both); the decode
block in f32
within 1e-5 (the same f32 arithmetic summed in another order), in bf16
within 2e-2 (both round each product's output to bf16; two bf16 ulps of
values up to 2); token ids exactly."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as pt
from paddle_tpu import quantize as jq
from paddle_tpu.layers import stacked as jS
from paddle_tpu.models import gpt as jgpt

from paddle_tpu_torch import io as tio
from paddle_tpu_torch import quantize as tq
from paddle_tpu_torch.fleet import decode as tdecode
from paddle_tpu_torch.layers import stacked as tS
from paddle_tpu_torch.models import gpt as tgpt

CPU = "cpu"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SMALL = dict(vocab_size=97, max_len=32, d_model=32, d_inner=64, num_heads=4,
             num_layers=2, use_flash=True, kv_cache_dtype="int8")


def _halves():
    """A vector whose abs-max is 127, so x / scale * 127 lands exactly on
    every half between -126.5 and 126.5 (rounded half to even)."""
    x = np.arange(-126.5, 127.0, 1.0, dtype=np.float32)
    return np.concatenate([[127.0], x]).astype(np.float32)[None, None, None, :]


def _inputs():
    rng = np.random.RandomState(0)
    return {
        "gauss": rng.randn(2, 4, 8, 16).astype(np.float32) * 3.0,
        "zeros": np.zeros((1, 2, 3, 16), np.float32),
        "mixed_zero_rows": np.concatenate([np.zeros((1, 1, 2, 16), np.float32),
                                           rng.randn(1, 1, 2, 16).astype(np.float32)], 2),
        "halves": _halves(),
        "tiny": (rng.randn(1, 1, 4, 16) * 1e-9).astype(np.float32),
    }


@pytest.mark.parametrize("case", sorted(_inputs()))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_bit_equal_to_jax(case, dtype):
    x = _inputs()[case]
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    wq, ws = jS.quantize_kv(xj)
    gq, gs = tS.quantize_kv(xt)
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    assert tuple(gs.shape) == x.shape[:-1] + (1,)
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    # the dynamic quantizer under it, over several axes
    wq2, ws2 = jq._quant_dynamic(xj, axes=(1, 3))
    gq2, gs2 = tq._quant_dynamic(xt, axes=(1, 3))
    np.testing.assert_array_equal(gq2.numpy(), np.asarray(wq2))
    np.testing.assert_array_equal(gs2.numpy(), np.asarray(ws2))


def test_halves_round_to_even_and_zeros_dequantize_to_zero():
    q, s = tS.quantize_kv(torch.from_numpy(_halves()))
    vals = q[0, 0, 0, 1:].numpy().astype(np.float32)
    np.testing.assert_array_equal(vals, np.round(np.arange(-126.5, 127.0, 1.0)))
    assert (vals % 2 == 0).all()   # every half went to the even neighbour
    qz, sz = tS.quantize_kv(torch.zeros(1, 1, 2, 8))
    assert float((qz.float() * sz).abs().sum()) == 0.0


def _block_params(d=32, seed=1):
    rng = np.random.RandomState(seed)
    return {
        "ln1/scale": (1 + 0.1 * rng.randn(d)).astype(np.float32),
        "ln1/bias": (0.1 * rng.randn(d)).astype(np.float32),
        "qkv/w": rng.randn(d, 3, d).astype(np.float32) * 0.2,
        "qkv/b": (0.1 * rng.randn(3, d)).astype(np.float32),
        "out/w": rng.randn(d, d).astype(np.float32) * 0.2,
        "out/b": (0.1 * rng.randn(d)).astype(np.float32),
        "ln2/scale": (1 + 0.1 * rng.randn(d)).astype(np.float32),
        "ln2/bias": (0.1 * rng.randn(d)).astype(np.float32),
        "ffn_in/w": rng.randn(d, 2 * d).astype(np.float32) * 0.2,
        "ffn_in/b": (0.1 * rng.randn(2 * d)).astype(np.float32),
        "ffn_out/w": rng.randn(2 * d, d).astype(np.float32) * 0.2,
        "ffn_out/b": (0.1 * rng.randn(d)).astype(np.float32),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("index", [0, 5, 15])
def test_decode_block_q8_matches_jax(dtype, index):
    from paddle_tpu.framework import amp_guard as jamp

    rng = np.random.RandomState(2 + index)
    d, h, rows, T = 32, 4, 2, 16
    p = _block_params()
    x = rng.randn(rows, 1, d).astype(np.float32)
    kq, ks = jS.quantize_kv(jnp.asarray(rng.randn(rows, h, T, d // h).astype(np.float32)))
    vq, vs = jS.quantize_kv(jnp.asarray(rng.randn(rows, h, T, d // h).astype(np.float32)))
    # half the positions unwritten: int8 zeros with zero scales, as a grown cache
    kq, ks, vq, vs = (a.at[:, :, T // 2 + 2:].set(0) for a in (kq, ks, vq, vs))
    with jamp(dtype):
        want = jS.decode_block_q8(jnp.asarray(x), jax.tree.map(jnp.asarray, p), kq, ks, vq,
                                  vs, jnp.asarray(index, jnp.int32), h)
    ct = getattr(torch, dtype)
    got = tS.decode_block_q8(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
                             *(torch.from_numpy(np.array(a)) for a in (kq, ks, vq, vs)),
                             torch.tensor(index, dtype=torch.int32), h, compute_dtype=ct)
    np.testing.assert_allclose(got[0].float().numpy(), np.asarray(want[0], np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])
    # the caches, written at index only: the new k/v come from products
    # summed in another order, so an int8 value may sit one step away
    # where x / scale * 127 lies at a half, and the scales within TOL
    for g, w in zip(got[1:], want[1:]):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        keep = np.arange(T) != index
        np.testing.assert_array_equal(g[:, :, keep], w[:, :, keep])
        if g.dtype == np.int8:
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(g, w, rtol=TOL[dtype], atol=0)


@pytest.fixture(scope="module")
def jax_params():
    prog = pt.build(jgpt.make_generator(jgpt.base_config(**SMALL), max_new_tokens=6))
    params, _ = prog.init(jax.random.PRNGKey(0), np.full((2, 8), 3, np.int32))
    rng = np.random.RandomState(1)
    return {k: np.asarray(v) + 0.3 * rng.randn(*v.shape).astype(np.float32)
            for k, v in params.items()}


def _prompts(b=3, p=8, seed=0):
    return np.random.RandomState(seed).randint(3, 97, (b, p)).astype(np.int32)


@pytest.mark.parametrize("beam", [1, 3])
@pytest.mark.parametrize("b,p", [(3, 8), (1, 5)])
def test_int8_generator_ids_equal_jax(jax_params, beam, b, p):
    prompts = _prompts(b, p, seed=b + p)
    prog = pt.build(jgpt.make_generator(jgpt.base_config(**SMALL), max_new_tokens=6,
                                        beam_size=beam))
    _, state = prog.init(jax.random.PRNGKey(0), prompts)
    want, _ = prog.apply(jax.tree.map(jnp.asarray, jax_params), state, prompts)
    gen = tgpt.make_generator(tgpt.base_config(**SMALL), 6, beam_size=beam, device=CPU)
    got = gen.load_params(tgpt.params_from_jax(jax_params, device=CPU))(
        torch.from_numpy(prompts))
    np.testing.assert_array_equal(got["ids"].numpy(), np.asarray(want["ids"]))
    if beam > 1:
        np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                                   rtol=1e-5, atol=1e-5)
    if b > 1:   # the test decodes, not repeats
        assert len(set(np.asarray(want["ids"]).ravel().tolist())) > 2


def test_int8_cache_is_what_the_generator_holds(jax_params):
    gen = tgpt.make_generator(tgpt.base_config(**SMALL), 6, device=CPU)
    gen.load_params(tgpt.params_from_jax(jax_params, device=CPU))(torch.from_numpy(_prompts()))
    dec = gen._decoders[(3, 8)]
    kinds = [(t.dtype, tuple(t.shape)) for t in dec.caches[0]]
    assert kinds == [(torch.int8, (3, 4, 14, 8)), (torch.float32, (3, 4, 14, 1))] * 2
    # 14 positions: 8 int8 values and one f32 scale per head vector, k and v
    assert dec.cache_bytes() == 2 * 2 * 3 * 4 * 14 * (8 + 4)


def test_batched_int8_decode_server_equals_sequential(jax_params, tmp_path):
    """The JAX package's served int8 workload (``test_fleet.py``): single
    prompts coalesced by the batching scheduler emit exactly the ids each
    gets from a sequential pad-alone decode, and the JAX program's ids."""
    d = str(tmp_path / "decoder")
    prompts = _prompts(4, 8, seed=5)
    tdecode.export_decoder(d, tgpt.base_config(**SMALL), 6, prompts,
                           params=tgpt.params_from_jax(jax_params, device=CPU),
                           batch_buckets=[1, 4], device=CPU)
    pred = tio.load_inference_model(d, device=CPU)
    sequential = [pred.run({"prompt_ids": prompts[i:i + 1]})["ids"].numpy()
                  for i in range(4)]
    srv = tdecode.decode_server(d, max_wait_ms=200.0, workers=1, device=CPU)
    try:
        pends = [srv.submit({"prompt_ids": prompts[i:i + 1]}) for i in range(4)]
        outs = [p.result(timeout=120)["ids"].numpy() for p in pends]
        rep = srv.report()
    finally:
        srv.close(drain=True, timeout=60)
    jprog = pt.build(jgpt.make_generator(jgpt.base_config(**SMALL), max_new_tokens=6))
    _, state = jprog.init(jax.random.PRNGKey(0), prompts)
    want, _ = jprog.apply(jax.tree.map(jnp.asarray, jax_params), state, prompts)
    for i in range(4):
        np.testing.assert_array_equal(outs[i], sequential[i])
        np.testing.assert_array_equal(outs[i], np.asarray(want["ids"])[i:i + 1])
    assert rep["coalesced_requests"] >= 2 and rep["errors"] == 0
