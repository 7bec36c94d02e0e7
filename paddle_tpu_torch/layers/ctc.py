"""CTC family: loss, greedy decoding, edit distance (counterpart of
``paddle_tpu.layers.ctc``; warpctc_op, ctc_align_op and
edit_distance_op).

Sequences are padded with explicit lengths. ``warpctc`` is the JAX
function's log-space forward algorithm, a loop over the time steps with
the same ``NEG_INF`` clamp, so its value on an infeasible label is the
clamp's, not ``inf``; autograd gives its gradient, as ``jax.grad`` does
in the reference. Its log-sum-exp is ``jax.scipy.special.logsumexp``'s
form, the maximum held out of the gradient: ``torch.logsumexp``'s
backward, ``exp(x - result)``, gives each of three clamped entries a
weight of 1 (the result absorbs ``log 3`` at 1e30) where JAX gives 1/3, so
an infeasible sample's gradient would differ. It does not go through
``torch.nn.functional.ctc_loss``, whose infeasible-label and
``zero_infinity`` cases differ. ``edit_distance`` computes a row of the
Levenshtein table at once as ``j + cummin(tmp - j)`` in place of the JAX
package's inner scan; the integers are the same.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _lengths(x, device, default=None):
    if x is None:
        return default
    return torch.as_tensor(x, device=device).reshape(-1).long()


def _extend_labels(labels, blank):
    """[B, L] labels -> [B, 2L+1] blank-interleaved extended labels."""
    b, l = labels.shape
    ext = torch.full((b, 2 * l + 1), blank, dtype=labels.dtype, device=labels.device)
    ext[:, 1::2] = labels
    return ext


def _logsumexp(x, dim):
    """``jax.scipy.special.logsumexp``: m + log(sum(exp(x - m))), with the
    maximum m (0 where it is not finite) held out of the gradient."""
    m = x.detach().amax(dim=dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return (m + torch.log(torch.exp(x - m).sum(dim=dim, keepdim=True))).squeeze(dim)


def _shift(x, k, fill):
    """x shifted right by ``k`` along dim 1, ``fill`` in the first ``k``."""
    return F.pad(x, (k, 0), value=fill)[:, :x.shape[1]]


def warpctc(logits, labels, logit_lengths, label_lengths, blank: int = 0,
            norm_by_times: bool = False):
    """CTC negative log-likelihood (warpctc_op analog). logits [B, T, C]
    unnormalised, labels [B, L] padded ids (no blanks), logit_lengths and
    label_lengths [B]. Returns the [B, 1] per-sample loss in f32."""
    dev = logits.device
    labels = torch.as_tensor(labels, device=dev).long()
    logit_lengths = _lengths(logit_lengths, dev)
    label_lengths = _lengths(label_lengths, dev)
    b, t, _ = logits.shape
    log_probs = torch.log_softmax(logits.float(), dim=-1)

    ext = _extend_labels(labels, blank)                       # [B, S], S = 2L+1
    s = ext.shape[1]
    pos = torch.arange(s, device=dev)[None, :]
    # alpha[s] may also come from alpha[s-2] when ext[s] is a label that
    # differs from ext[s-2]
    allow_skip = (ext != blank) & (ext != _shift(ext, 2, -1))
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)

    alpha0 = torch.where(pos == 0, 0.0, neg)
    first = torch.where((pos == 1) & (label_lengths[:, None] > 0), 0.0, neg)
    alpha = torch.maximum(alpha0, first) + torch.gather(log_probs[:, 0, :], 1, ext)
    for tt in range(1, t):
        prev2 = torch.where(allow_skip, _shift(alpha, 2, NEG_INF), neg)
        merged = _logsumexp(torch.stack([alpha, _shift(alpha, 1, NEG_INF), prev2]), 0)
        new = merged + torch.gather(log_probs[:, tt, :], 1, ext)
        # a sample's alpha stays once past its input length
        alpha = torch.where((tt < logit_lengths)[:, None], new, alpha)

    send = 2 * label_lengths                                  # the final blank
    last_blank = torch.gather(alpha, 1, send[:, None])[:, 0]
    last_label = torch.gather(alpha, 1, torch.clamp(send - 1, min=0)[:, None])[:, 0]
    last_label = torch.where(label_lengths > 0, last_label, neg)
    loss = -_logsumexp(torch.stack([last_blank, last_label]), 0)
    if norm_by_times:
        loss = loss / torch.clamp(logit_lengths, min=1).to(loss.dtype)
    return loss[:, None]


def ctc_greedy_decoder(input, blank: int, input_length=None, padding_value: int = -1):
    """Greedy (best-path) CTC decoding: the first maximum of each step
    (``torch.argmax``, as ``jnp.argmax``), repeats merged, blanks dropped.
    input [B, T, C]. Returns (decoded [B, T] int32 padded with
    ``padding_value``, lengths [B] int32)."""
    b, t, _ = input.shape
    dev = input.device
    tok = torch.argmax(input, dim=-1)                         # [B, T] int64
    keep = (tok != blank) & (tok != _shift(tok, 1, -1))
    if input_length is not None:
        il = _lengths(input_length, dev)
        keep = keep & (torch.arange(t, device=dev)[None, :] < il[:, None])
    dest = torch.cumsum(keep.long(), dim=1) - 1               # write position
    lengths = (dest.max(dim=1).values + 1).int()
    dest = torch.where(keep, dest, t)                         # dropped -> the spare column
    out = torch.full((b, t + 1), padding_value, dtype=torch.int64, device=dev)
    out.scatter_(1, dest, torch.where(keep, tok, padding_value))
    return out[:, :t].int(), lengths


def edit_distance(input, label, input_length=None, label_length=None,
                  normalized: bool = True):
    """Levenshtein distance between padded token sequences (hypothesis
    [B, Th], reference [B, Tr]), each cut to its length (default the
    full width). Returns (distance [B, 1] f32, normalised by the reference
    length when ``normalized``; sequence_num, a 0-d int32)."""
    dev = input.device if isinstance(input, torch.Tensor) else None
    hyp = torch.as_tensor(input, device=dev).long()
    ref = torch.as_tensor(label, device=hyp.device).long()
    dev = hyp.device
    b, th = hyp.shape
    tr = ref.shape[1]
    hl = _lengths(input_length, dev, torch.full((b,), th, dtype=torch.long, device=dev))
    rl = _lengths(label_length, dev, torch.full((b,), tr, dtype=torch.long, device=dev))

    j = torch.arange(tr + 1, device=dev)
    row = j.expand(b, tr + 1)
    rows = [row]
    for i in range(th):
        cost = (hyp[:, i:i + 1] != ref).long()                # [B, Tr]
        # without the left neighbour: min(up + 1, diag + cost); the left
        # chain then is j + cummin(tmp - j)
        tmp = torch.cat([row[:, :1] + 1,
                         torch.minimum(row[:, 1:] + 1, row[:, :-1] + cost)], dim=1)
        row = j + torch.cummin(tmp - j, dim=1).values
        rows.append(row)
    table = torch.stack(rows)                                 # [Th+1, B, Tr+1]
    dist = table[hl, torch.arange(b, device=dev), rl].float()
    if normalized:
        dist = dist / torch.clamp(rl, min=1).float()
    return dist[:, None], torch.tensor(b, dtype=torch.int32, device=dev)


__all__ = ["NEG_INF", "ctc_greedy_decoder", "edit_distance", "warpctc"]
