"""The port's flash attention (plain PyTorch version, the one a CPU tensor
takes) against the JAX package's Pallas kernel run in interpret mode on
the CPU, on the same numpy inputs.

Tolerance: f32 atol = rtol = 1e-5 (the two sum the same f32 products in
another order); the bf16 case 2e-2 (one bf16 ulp of the outputs is
2**-8 relative, and the two round p to bf16 at slightly different
values of m)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa

F32_TOL = 1e-5
BF16_TOL = 2e-2


def _inputs(b, h, sq, sk, d, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype(np.float32) for s in (sq, sk, sk)]


def _segments(b, s, n_seg, seed):
    rng = np.random.RandomState(seed)
    cuts = np.sort(rng.randint(0, s, (b, n_seg - 1)), axis=1)
    return (np.arange(s)[None, :, None] >= cuts[:, None, :]).sum(-1).astype(np.int32)


# name: (b, h, sq, sk, d, kwargs builder, JAX-only kwargs)
CASES = {
    "plain": (1, 2, 128, 128, 32, lambda b, sq, sk: {}, {}),
    "causal": (1, 2, 128, 128, 32, lambda b, sq, sk: {"causal": True}, {}),
    "causal_bottom_right_sq_lt_sk": (
        2, 2, 16, 128, 32, lambda b, sq, sk: {"causal": True}, {}),
    "causal_many_k_blocks": (
        1, 2, 128, 128, 32, lambda b, sq, sk: {"causal": True},
        {"block_q": 32, "block_k": 32}),
    "key_bias_padding": (
        2, 2, 128, 128, 32,
        lambda b, sq, sk: {"key_bias": np.where(
            np.arange(sk)[None, :] < 100, 0.0, -1e9).repeat(b, 0)
            .astype(np.float32)}, {}),
    "cross_sk_ne_sq": (2, 2, 64, 96, 32, lambda b, sq, sk: {}, {}),
    "segment_ids": (
        2, 2, 96, 96, 32,
        lambda b, sq, sk: {"segment_ids": _segments(b, sq, 3, 1)}, {}),
    "q_kv_segment_ids": (
        2, 2, 64, 80, 32,
        lambda b, sq, sk: {"segment_ids": _segments(b, sq, 2, 2),
                           "kv_segment_ids": _segments(b, sk, 2, 3)}, {}),
    "causal_segments_bias": (
        2, 2, 100, 100, 32,
        lambda b, sq, sk: {"causal": True,
                           "segment_ids": _segments(b, sq, 3, 4),
                           "key_bias": np.random.RandomState(5)
                           .randn(b, sk).astype(np.float32)}, {}),
    "non_divisible_padded": (
        2, 2, 100, 100, 64, lambda b, sq, sk: {"causal": True},
        {"block_q": 64, "block_k": 64}),
    "non_divisible_cross_bias": (
        1, 2, 50, 70, 32,
        lambda b, sq, sk: {"key_bias": np.random.RandomState(6)
                           .randn(b, sk).astype(np.float32)},
        {"block_q": 32, "block_k": 32}),
    "attn_mask_as_key_bias": (
        2, 2, 64, 64, 32,
        lambda b, sq, sk: {"attn_mask": np.where(
            np.arange(sk)[None, None, None, :] < 40, 0.0, -1e9)
            .repeat(b, 0).astype(np.float32)}, {}),
    # query rows whose segment id appears among no key: no visible key,
    # so o = 0 and lse ≈ -1e30, never NaN
    "fully_masked_rows": (
        1, 2, 64, 64, 32,
        lambda b, sq, sk: {"segment_ids": np.concatenate(
            [np.zeros((b, 32)), np.ones((b, 32))], 1).astype(np.int32),
            "kv_segment_ids": np.zeros((b, sk), np.int32)}, {}),
}


def _to_jax(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def _to_torch(kw):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()}


@pytest.mark.parametrize("return_lse", [False, True], ids=["out", "lse"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_flash_matches_jax_kernel(case, return_lse):
    b, h, sq, sk, d, make_kw, jax_only = CASES[case]
    q, k, v = _inputs(b, h, sq, sk, d)
    kw = make_kw(b, sq, sk)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               return_lse=return_lse, **_to_jax(kw), **jax_only)
    launches = tfa.flash_fwd_launches
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), return_lse=return_lse,
                              **_to_torch(kw))
    # a CPU tensor takes the plain version: the kernel count stays put
    assert tfa.flash_fwd_launches == launches
    want = want if return_lse else (want,)
    got = got if return_lse else (got,)
    for w, g in zip(want, got):
        g = g.numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), atol=F32_TOL, rtol=F32_TOL)
    if case == "fully_masked_rows":
        assert np.abs(got[0].numpy()[:, :, 32:]).max() == 0.0
        if return_lse:
            assert (got[1].numpy()[:, :, 32:] < -1e29).all()


def test_dense_mask_fallback_keeps_bias_and_segments():
    b, h, s, d = 2, 2, 48, 32
    q, k, v = _inputs(b, h, s, s, d, seed=7)
    rng = np.random.RandomState(8)
    mask = (rng.rand(b, h, s, s) < 0.2).astype(np.float32) * -1e9
    bias = rng.randn(b, s).astype(np.float32)
    seg = _segments(b, s, 2, 9)
    kw = {"attn_mask": mask, "key_bias": bias, "segment_ids": seg}
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True, **_to_jax(kw))
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, **_to_torch(kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=F32_TOL, rtol=F32_TOL)


def test_bf16_plain_flash_matches_jax_kernel():
    q, k, v = _inputs(2, 2, 100, 100, 64, seed=10)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = jfa.flash_attention(bf(q), bf(k), bf(v), causal=True,
                               block_q=64, block_k=64)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = tfa.flash_attention(tb(q), tb(k), tb(v), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)


def test_kv_segment_ids_requires_query_ids():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 8, 8, 32))
    with pytest.raises(Exception, match="kv_segment_ids requires"):
        tfa.flash_attention(q, k, v, kv_segment_ids=torch.zeros(1, 8,
                                                                dtype=torch.int32))


def test_kernel_entry_refuses_cpu_tensors():
    """The CUDA entry never computes on the CPU: a CPU tensor there is a
    caller error, not a reason to fall back."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 8, 8, 32))
    with pytest.raises(Exception, match="not a CUDA card"):
        tfa.flash_fwd_cuda(q, k, v, causal=True)


# -- layers/attention.py: the routing into the kernel and its neighbours -----

from paddle_tpu.layers import attention as jattn  # noqa: E402
from paddle_tpu_torch.layers import attention as tattn  # noqa: E402

SDPA_CASES = {
    "dense_causal": {"causal": True},
    "dense_padding_mask": {"mask": True},
    "flash_causal": {"causal": True, "use_flash": True},
    "flash_padding_mask": {"mask": True, "use_flash": True},
    "flash_causal_sq_lt_sk": {"causal": True, "use_flash": True, "sq": 24},
    "dense_causal_sq_lt_sk": {"causal": True, "sq": 24},
}


@pytest.mark.parametrize("case", sorted(SDPA_CASES))
def test_scaled_dot_product_attention_matches_jax(case):
    kw = dict(SDPA_CASES[case])
    sq = kw.pop("sq", 64)
    q, k, v = _inputs(2, 2, sq, 64, 32, seed=11)
    jkw, tkw = {}, {}
    if kw.pop("mask", False):
        ids = np.random.RandomState(12).randint(0, 4, (2, 64))
        jkw["attn_mask"] = jattn.padding_mask(jnp.asarray(ids))
        tkw["attn_mask"] = tattn.padding_mask(torch.from_numpy(ids))
        np.testing.assert_array_equal(tkw["attn_mask"].numpy(),
                                      np.asarray(jkw["attn_mask"]))
    want = jattn.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw, **jkw)
    got = tattn.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("seq,d", [(32, 16), (256, 768)])
def test_positional_encoding_matches_jax(seq, d):
    np.testing.assert_allclose(tattn.positional_encoding(seq, d).numpy(),
                               np.asarray(jattn.positional_encoding(seq, d)),
                               atol=F32_TOL, rtol=F32_TOL)
