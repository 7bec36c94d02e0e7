"""The port's CTC family against ``paddle_tpu.layers.ctc`` on the CPU, on
the same numpy inputs made from a seed: ``warpctc``'s loss and its grad
(ragged lengths, repeated labels, an empty label, an infeasible label and
``norm_by_times``), ``ctc_greedy_decoder`` (ties, lengths, padding) and
``edit_distance`` (lengths, an empty reference, both normalisations).

Tolerances: the loss within rtol 1e-5 (f32 logsumexp summed in another
order; the infeasible sample's clamped 1e30 too); the grad of the summed
loss within 1e-5 of its largest entry; ``F.ctc_loss`` as a second witness
on the feasible samples within 1e-4 (atol and rtol); the decoder's ids and
lengths and the distances exactly."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from paddle_tpu.layers import ctc as jctc

from paddle_tpu_torch.layers import ctc as tctc

B, T, C, L = 4, 12, 6, 5


def _t(x):
    return torch.from_numpy(np.array(x))


def _case(seed, infeasible):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, T, C).astype(np.float32)
    labels = rng.randint(1, C, (B, L)).astype(np.int32)
    labels[1, 1] = labels[1, 0]                      # a repeat needs a blank between
    logit_lengths = np.array([T, 9, 7, T], np.int32)
    label_lengths = np.array([L, 4, 0, 3], np.int32)
    if infeasible:                                   # 5 labels with repeats in 3 steps
        logit_lengths[3], label_lengths[3] = 3, L
        labels[3] = 2
    return logits, labels, logit_lengths, label_lengths


@pytest.mark.parametrize("norm_by_times", [False, True])
@pytest.mark.parametrize("infeasible", [False, True])
def test_warpctc_loss_and_grad_equal_jax(norm_by_times, infeasible):
    logits, labels, tl, ll = _case(3, infeasible)

    def jloss(x):
        return jctc.warpctc(x, labels, tl, ll, blank=0, norm_by_times=norm_by_times)

    want = np.asarray(jloss(jnp.asarray(logits)))
    want_g = np.asarray(jax.grad(lambda x: jloss(x).sum())(jnp.asarray(logits)))
    x = _t(logits).requires_grad_(True)
    got = tctc.warpctc(x, _t(labels), _t(tl), _t(ll), blank=0, norm_by_times=norm_by_times)
    got.sum().backward()
    assert got.shape == (B, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=0)
    g = x.grad.numpy()
    assert np.isfinite(g).all()
    assert np.abs(g - want_g).max() <= 1e-5 * np.abs(want_g).max()
    if infeasible:
        assert got[3, 0] > 1e29                      # the clamp's value, not inf
    # second witness: torch's own CTC on the feasible samples
    feasible = [0, 1, 2] if infeasible else [0, 1, 2, 3]
    ref = F.ctc_loss(torch.log_softmax(_t(logits), -1).transpose(0, 1), _t(labels).long(),
                     _t(tl).long(), _t(ll).long(), blank=0, reduction="none")
    if norm_by_times:
        ref = ref / _t(tl).float()
    np.testing.assert_allclose(got[feasible, 0].detach().numpy(), ref[feasible].numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("with_lengths", [False, True])
def test_ctc_greedy_decoder_equal_jax(with_lengths):
    rng = np.random.RandomState(5)
    probs = rng.randint(0, 3, (B, T, C)).astype(np.float32)   # many ties: first maximum wins
    lengths = np.array([T, 5, 0, 8], np.int32) if with_lengths else None
    want_ids, want_len = jctc.ctc_greedy_decoder(probs, blank=0, input_length=lengths,
                                                 padding_value=-7)
    got_ids, got_len = tctc.ctc_greedy_decoder(_t(probs), blank=0,
                                               input_length=None if lengths is None
                                               else _t(lengths), padding_value=-7)
    assert got_ids.dtype == torch.int32 and got_len.dtype == torch.int32
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_edit_distance_equal_jax(normalized, with_lengths):
    rng = np.random.RandomState(7)
    hyp = rng.randint(0, 4, (5, 9)).astype(np.int32)
    ref = rng.randint(0, 4, (5, 7)).astype(np.int32)
    hl = np.array([9, 3, 0, 6, 2], np.int32) if with_lengths else None
    rl = np.array([7, 0, 4, 6, 1], np.int32) if with_lengths else None
    want, want_n = jctc.edit_distance(hyp, ref, hl, rl, normalized=normalized)
    got, got_n = tctc.edit_distance(_t(hyp), _t(ref), None if hl is None else _t(hl),
                                    None if rl is None else _t(rl), normalized=normalized)
    assert got.shape == (5, 1) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got_n) == int(want_n) == 5
