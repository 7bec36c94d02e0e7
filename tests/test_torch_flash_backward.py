"""The port's flash-attention backward (the plain versions, which a CPU
tensor takes) against the JAX package's Pallas backward kernels run in
interpret mode on the CPU, on the same numpy inputs and cotangents.

Tolerances: f32 atol = 1e-5·max(1, max|ref|), rtol 1e-5 (the same f32
products, summed in another order over at most 64 terms); bf16 2e-2 of
max|ref| (the two round P and dS to bf16 from f32 values that differ in
the last bits, and each grad once more at the end); bf16 against the
f32 JAX grads 5e-2 of max|ref| (bf16 inputs carry 2⁻⁸ relative error
into every product)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa

F32_TOL = 1e-5
BF16_TOL = 2e-2
BF16_VS_F32_TOL = 5e-2


def _segments(b, s, n_seg, seed):
    rng = np.random.RandomState(seed)
    cuts = np.sort(rng.randint(0, s, (b, n_seg - 1)), axis=1)
    return (np.arange(s)[None, :, None] >= cuts[:, None, :]).sum(-1).astype(np.int32)


# name: (b, h, sq, sk, d, kwargs builder, JAX block sizes)
CASES = {
    "plain": (1, 2, 64, 64, 32, lambda b, sq, sk: {}, {}),
    "causal": (1, 2, 64, 64, 32, lambda b, sq, sk: {"causal": True}, {}),
    "causal_many_blocks": (2, 2, 64, 64, 32, lambda b, sq, sk: {"causal": True},
                           {"block_q": 16, "block_k": 16}),
    "causal_sq_lt_sk": (2, 2, 24, 64, 32, lambda b, sq, sk: {"causal": True}, {}),
    # sq > sk, bottom-right: the first sq - sk query rows see no key
    "causal_sq_gt_sk": (2, 2, 64, 40, 32, lambda b, sq, sk: {"causal": True},
                        {"block_q": 16, "block_k": 16}),
    "cross_sk_ne_sq": (2, 2, 40, 56, 32, lambda b, sq, sk: {}, {}),
    "key_bias": (2, 2, 48, 48, 32,
                 lambda b, sq, sk: {"key_bias": np.random.RandomState(5)
                                    .randn(b, sk).astype(np.float32)}, {}),
    "padding_bias": (2, 2, 48, 48, 32,
                     lambda b, sq, sk: {"key_bias": np.where(
                         np.arange(sk)[None, :] < 40, 0.0, -1e9).repeat(b, 0)
                         .astype(np.float32)}, {}),
    "segment_ids": (2, 2, 48, 48, 32,
                    lambda b, sq, sk: {"segment_ids": _segments(b, sq, 3, 1)}, {}),
    "q_kv_segment_ids": (2, 2, 40, 56, 32,
                         lambda b, sq, sk: {"segment_ids": _segments(b, sq, 2, 2),
                                            "kv_segment_ids": _segments(b, sk, 2, 3)},
                         {}),
    "causal_segments_bias_ragged": (
        2, 2, 50, 50, 32,
        lambda b, sq, sk: {"causal": True, "segment_ids": _segments(b, sq, 3, 4),
                           "key_bias": np.random.RandomState(6)
                           .randn(b, sk).astype(np.float32)},
        {"block_q": 16, "block_k": 16}),
    "ragged_cross_bias": (1, 2, 50, 70, 64,
                          lambda b, sq, sk: {"key_bias": np.random.RandomState(7)
                                             .randn(b, sk).astype(np.float32)},
                          {"block_q": 16, "block_k": 32}),
    # head dim 64 (the tensor-core route's), causal with a key bias and
    # query/key segment ids, sq != sk and sk - sq not a multiple of a block
    "causal_bias_segments_d64_cross": (
        2, 2, 40, 71, 64,
        lambda b, sq, sk: {"causal": True, "segment_ids": _segments(b, sq, 2, 12),
                           "kv_segment_ids": _segments(b, sk, 2, 13),
                           "key_bias": np.random.RandomState(14)
                           .randn(b, sk).astype(np.float32)},
        {"block_q": 16, "block_k": 16}),
    # the second half of the queries has no key of its segment: o = 0,
    # lse ≈ -1e30, and their grads (and their share of dk/dv) are 0
    "fully_masked_rows": (1, 2, 64, 64, 32,
                          lambda b, sq, sk: {"segment_ids": np.concatenate(
                              [np.zeros((b, 32)), np.ones((b, 32))], 1).astype(np.int32),
                              "kv_segment_ids": np.zeros((b, sk), np.int32)}, {}),
}


def _inputs(b, h, sq, sk, d, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) for s in (sq, sk, sk))
    g = rng.randn(b, h, sq, d).astype(np.float32)
    return q, k, v, g


def _jax_grads(q, k, v, g, kw, blocks, dtype=jnp.float32):
    jkw = {key: jnp.asarray(val) for key, val in kw.items() if key != "causal"}
    causal = kw.get("causal", False)
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    out, vjp = jax.vjp(lambda q_, k_, v_: jfa.flash_attention(
        q_, k_, v_, causal=causal, **jkw, **blocks), *args)
    return out, vjp(jnp.asarray(g, dtype))


def _port_grads(q, k, v, g, kw, dtype=torch.float32):
    tkw = {key: (torch.from_numpy(np.asarray(val)) if key != "causal" else val)
           for key, val in kw.items()}
    qt, kt, vt = (torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(qt, kt, vt, **tkw)
    return out, torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g).to(dtype))


def _close(got, want, tol, what):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all(), what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol, err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_grad(case):
    b, h, sq, sk, d, make_kw, blocks = CASES[case]
    q, k, v, g = _inputs(b, h, sq, sk, d)
    kw = make_kw(b, sq, sk)
    _, want = _jax_grads(q, k, v, g, kw, blocks)
    _, got = _port_grads(q, k, v, g, kw)
    for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
        _close(gt, wt, F32_TOL, f"{case}: {name}")
    if case == "fully_masked_rows":
        assert np.abs(got[0].numpy()[:, :, 32:]).max() == 0.0
    if case == "causal_sq_gt_sk":
        assert np.abs(got[0].numpy()[:, :, :sq - sk]).max() == 0.0


@pytest.mark.parametrize("case", ["causal_many_blocks", "causal_segments_bias_ragged",
                                  "causal_sq_gt_sk", "causal_bias_segments_d64_cross"])
def test_bf16_backward_matches_jax(case):
    b, h, sq, sk, d, make_kw, blocks = CASES[case]
    q, k, v, g = _inputs(b, h, sq, sk, d, seed=3)
    kw = make_kw(b, sq, sk)
    # the inputs as bf16 values, so both sides start from the same numbers
    q, k, v, g = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                  for a in (q, k, v, g))
    _, want = _jax_grads(q, k, v, g, kw, blocks, jnp.bfloat16)
    _, want32 = _jax_grads(q, k, v, g, kw, blocks)
    _, got = _port_grads(q, k, v, g, kw, torch.bfloat16)
    for name, gt, wt, w32 in zip(("dq", "dk", "dv"), got, want, want32):
        assert gt.dtype == torch.bfloat16
        _close(gt, wt, BF16_TOL, f"{case}: {name} against JAX bf16")
        _close(gt, w32, BF16_VS_F32_TOL, f"{case}: {name} against JAX f32")


def test_flash_bwd_with_lse_and_delta_from_outside():
    """``_flash_bwd`` called on its own, as ring attention calls it: lse
    and δ come from the caller (here δ scaled, so a δ recomputed from
    ``out`` would not match), and ``out`` is not read."""
    b, h, sq, sk, d = 2, 2, 40, 56, 32
    q, k, v, g = _inputs(b, h, sq, sk, d, seed=4)
    bias = np.random.RandomState(8).randn(b, sk).astype(np.float32)
    seg_q, seg_k = _segments(b, sq, 2, 9), _segments(b, sk, 2, 10)
    J = jnp.asarray
    out, lse = jfa._flash_fwd(J(q), J(k), J(v), J(bias), J(seg_q), J(seg_k), True,
                              16, 16, True)
    delta = 1.5 * np.asarray(jnp.sum(out * J(g), axis=-1))
    junk_out = np.random.RandomState(11).randn(*out.shape).astype(np.float32)
    want = jfa._flash_bwd(J(q), J(k), J(v), J(bias), J(seg_q), J(seg_k), True,
                          J(junk_out), lse, J(g), 16, 16, True, delta=J(delta))
    T = torch.from_numpy
    got = tfa._flash_bwd(T(q), T(k), T(v), T(bias), T(seg_q), T(seg_k), True,
                         T(junk_out), T(np.array(lse)), T(g), delta=T(delta))
    for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
        _close(gt, wt, F32_TOL, name)


def test_cpu_backward_runs_the_plain_backward_not_autograd(monkeypatch):
    """A CPU tensor's gradient comes from the plain backward passes (one
    call each per backward), through the autograd Function, never from
    autograd of the plain forward and never from a kernel."""
    calls = {"dq": 0, "dkv": 0}
    dq_ref, dkv_ref = tfa.flash_bwd_dq_reference, tfa.flash_bwd_dkv_reference

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tfa, "flash_bwd_dq_reference", count("dq", dq_ref))
    monkeypatch.setattr(tfa, "flash_bwd_dkv_reference", count("dkv", dkv_ref))
    q, k, v, g = _inputs(1, 2, 32, 32, 32)
    launches = (tfa.flash_fwd_launches, tfa.flash_bwd_dq_launches,
                tfa.flash_bwd_dkv_launches)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(qt, kt, vt, causal=True)
    assert type(out.grad_fn).__name__ == "_FlashCoreBackward"
    out.backward(torch.from_numpy(g))
    assert calls == {"dq": 1, "dkv": 1}
    assert all(t.grad is not None for t in (qt, kt, vt))
    assert (tfa.flash_fwd_launches, tfa.flash_bwd_dq_launches,
            tfa.flash_bwd_dkv_launches) == launches


def test_return_lse_is_forward_only_as_in_jax():
    q, k, v, _ = _inputs(1, 2, 16, 16, 32)
    qt = torch.from_numpy(q).requires_grad_()
    out, lse = tfa.flash_attention(qt, torch.from_numpy(k), torch.from_numpy(v),
                                   causal=True, return_lse=True)
    assert out.grad_fn is None and lse.grad_fn is None


def test_backward_kernels_refuse_cpu_tensors():
    """The CUDA entries never compute on the CPU: a CPU tensor there is a
    caller error, not a reason to fall back."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(1, 1, 8, 8, 32))
    lse = delta = torch.zeros(1, 1, 8)
    for fn in (tfa.flash_bwd_dq_cuda, tfa.flash_bwd_dkv_cuda, tfa.flash_bwd_cuda):
        with pytest.raises(Exception, match="not a CUDA card"):
            fn(q, k, v, True, None, None, None, g, lse, delta)
