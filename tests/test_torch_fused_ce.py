"""The port's chunked softmax CE against the JAX package's
``chunked_softmax_cross_entropy``: values and grads (hidden, weight,
bias) on the same numpy inputs, with and without a bias, at label
smoothing 0 and 0.1, with vocab 50 in chunks of 16 (four chunks, the
last with a 14-column pad tail).

Tolerances: f32 rtol 1e-5, atol 1e-5·max(1, max|ref|) (the same f32
arithmetic summed in another order); bf16 inputs 2e-2 of max|ref| (the
logit gradient is rounded to bf16 before its products, and the grads to
bf16 at the end, from f32 values that differ in the last bits)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops.fused_ce import chunked_softmax_cross_entropy as jce
from paddle_tpu_torch.core.errors import NotYetPorted
from paddle_tpu_torch.ops.fused_ce import chunked_softmax_cross_entropy as tce

N, D, V, CHUNK = 12, 16, 50, 16
F32_TOL = 1e-5
BF16_TOL = 2e-2


def _inputs(seed, with_bias):
    rng = np.random.RandomState(seed)
    h = rng.randn(N, D).astype(np.float32)
    w = (rng.randn(D, V) * 0.3).astype(np.float32)
    b = (rng.randn(V) * 0.1).astype(np.float32) if with_bias else None
    lab = rng.randint(0, V, N).astype(np.int32)
    lab[:3] = [V - 1, 0, 40]  # the first, the last chunk and its last column
    g = rng.randn(N).astype(np.float32)
    return h, w, b, lab, g


def _jax(h, w, b, lab, g, eps, dtype):
    args = [jnp.asarray(a, dtype) for a in (h, w)]
    if b is not None:
        args.append(jnp.asarray(b, dtype))

    def f(*a):
        return jce(a[0], a[1], a[2] if b is not None else None, jnp.asarray(lab),
                   eps, CHUNK)

    nll, vjp = jax.vjp(f, *args)
    return nll, vjp(jnp.asarray(g))


def _port(h, w, b, lab, g, eps, dtype):
    args = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (h, w)]
    if b is not None:
        args.append(torch.from_numpy(b).to(dtype).requires_grad_())
    nll = tce(args[0], args[1], args[2] if b is not None else None,
              torch.from_numpy(lab), eps, CHUNK)
    return nll, torch.autograd.grad(nll, args, torch.from_numpy(g))


def _close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


@pytest.mark.parametrize("eps", [0.0, 0.1])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
def test_chunked_ce_values_and_grads_match_jax(eps, with_bias):
    h, w, b, lab, g = _inputs(0, with_bias)
    want_nll, want_grads = _jax(h, w, b, lab, g, eps, jnp.float32)
    nll, grads = _port(h, w, b, lab, g, eps, torch.float32)
    assert nll.dtype == torch.float32 and tuple(nll.shape) == (N,)
    _close(nll, want_nll, F32_TOL, "nll")
    for name, gt, wt in zip(("hidden", "weight", "bias"), grads, want_grads):
        assert gt.shape == wt.shape
        _close(gt, wt, F32_TOL, name)


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_chunked_ce_bf16_inputs_match_jax(eps):
    h, w, b, lab, g = _inputs(1, True)
    want_nll, want_grads = _jax(h, w, b, lab, g, eps, jnp.bfloat16)
    nll, grads = _port(h, w, b, lab, g, eps, torch.bfloat16)
    assert nll.dtype == torch.float32  # the loss always reduces in f32
    _close(nll, want_nll, BF16_TOL, "nll")
    for name, gt, wt in zip(("hidden", "weight", "bias"), grads, want_grads):
        assert gt.dtype == torch.bfloat16
        _close(gt, wt, BF16_TOL, name)


def test_chunked_ce_saves_only_what_the_backward_recomputes_from():
    """The forward keeps hidden, weight, bias, labels and the per-token
    lse — no [tokens, vocab] logits."""
    h, w, b, lab, _ = _inputs(2, True)
    ht = torch.from_numpy(h).requires_grad_()
    nll = tce(ht, torch.from_numpy(w), torch.from_numpy(b), torch.from_numpy(lab),
              0.0, CHUNK)
    saved = nll.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [(N, D), (D, V), (V,), (N,), (N,)]


def test_logit_dtype_other_than_f32_is_not_ported():
    h, w, _, lab, _ = _inputs(3, False)
    with pytest.raises(NotYetPorted):
        tce(torch.from_numpy(h), torch.from_numpy(w), None, torch.from_numpy(lab),
            0.0, CHUNK, logit_dtype=torch.bfloat16)
