"""Linear-chain CRF (counterpart of ``paddle_tpu.layers.crf``;
linear_chain_crf_op.cc and crf_decoding_op.cc).

Padded emissions [b, t, n_tags] with lengths; the transition parameter is
the reference's learned [n+2, n] matrix whose first two rows are the
start and end transitions. The forward algorithm (``logsumexp`` in f32)
and Viterbi run as loops over the steps, a row past its length keeping
its scores. Viterbi's ties go to the first maximum (``torch.argmax``, as
``jnp.argmax``), so the decoded tags equal the JAX package's on f32
inputs.
"""

from __future__ import annotations

import torch

from .. import initializer as init
from ..framework import LayerHelper


def _split_transition(transition):
    return transition[0], transition[1], transition[2:]  # start, end, trans[i -> j]


def linear_chain_crf(emission, label, lengths, param_attr=None, name=None):
    """Negative log-likelihood per sequence (linear_chain_crf op analog).
    emission [b, t, n] unnormalised scores, label [b, t] int, lengths [b].
    Returns (nll [b], transition [n+2, n])."""
    helper = LayerHelper("crf", name=name)
    n = emission.shape[-1]
    transition = helper.create_parameter("transition", (n + 2, n), torch.float32,
                                         attr=param_attr,
                                         initializer=init.Uniform(-0.1, 0.1))
    return crf_nll(emission, label, lengths, transition), transition


def crf_nll(emission, label, lengths, transition):
    """log Z − the gold path's score, per sequence [b], in f32."""
    b, t, n = emission.shape
    start, end, trans = _split_transition(transition)
    em = emission.float()
    lab = label.long()
    rows = torch.arange(b, device=em.device)
    steps = torch.arange(t, device=em.device)

    # the gold path's score: gathers and a masked sum, no recurrence
    first_score = start[lab[:, 0]] + em[rows, 0, lab[:, 0]]
    step_scores = trans[lab[:, :-1], lab[:, 1:]] + em[rows[:, None], steps[None, 1:], lab[:, 1:]]
    valid = steps[None, 1:] < lengths[:, None]
    gold = first_score + torch.sum(torch.where(valid, step_scores, 0.0), dim=1)
    last_idx = torch.clamp(lengths.long() - 1, 0, t - 1)
    gold = gold + end[lab[rows, last_idx]]

    # the partition function: the forward algorithm
    alpha = start[None, :] + em[:, 0]
    for i in range(1, t):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) + em[:, i]
        alpha = torch.where((lengths > i)[:, None], nxt, alpha)
    logz = torch.logsumexp(alpha + end[None, :], dim=1)
    return logz - gold


def crf_decoding(emission, lengths, transition) -> torch.Tensor:
    """Viterbi decode (crf_decoding op analog): the best path [b, t] int32,
    0 past each length."""
    b, t, n = emission.shape
    start, end, trans = _split_transition(transition)
    em = emission.float()
    tags = torch.arange(n, device=em.device)[None, :]

    delta = start[None, :] + em[:, 0]
    bps = []  # bps[i - 1]: each tag's best predecessor at step i [b, n]
    for i in range(1, t):
        scores = delta[:, :, None] + trans[None]       # [b, from, to]
        best_prev = torch.argmax(scores, dim=1)        # first maximum
        nxt = torch.amax(scores, dim=1) + em[:, i]
        valid = (lengths > i)[:, None]
        delta = torch.where(valid, nxt, delta)
        bps.append(torch.where(valid, best_prev, tags))
    cur = torch.argmax(delta + end[None, :], dim=1)  # the tag at the last step

    # backtrace: each step's tag, then the carry moves to the tag before it
    path = [None] * t
    for i in range(t - 1, 0, -1):
        path[i] = cur
        cur = torch.gather(bps[i - 1], 1, cur[:, None])[:, 0]
    path[0] = cur
    path = torch.stack(path, dim=1)
    mask = torch.arange(t, device=em.device)[None, :] < lengths[:, None]
    return torch.where(mask, path, 0).to(torch.int32)


__all__ = ["crf_decoding", "crf_nll", "linear_chain_crf"]
