"""Chunked (logits-free) softmax cross-entropy for large vocabularies
(counterpart of ``paddle_tpu.ops.fused_ce``).

The projection to the vocabulary and the softmax CE at the top of a
language model run over vocab chunks with an online log-sum-exp, so the
live logits are [tokens, chunk], never [tokens, vocab]; the backward
recomputes each chunk's logits from the hidden states and keeps only
hidden, weight, bias, labels and the per-token lse. Label smoothing over
the uniform prior: loss = (1−eps)·nll + eps·(lse − mean logits), with the
matching gradient softmax − ((1−eps)·onehot + eps/V).

The JAX version is jnp code under a custom VJP, not a Pallas kernel, so
this is plain PyTorch in a ``torch.autograd.Function``, with the same
math in the same order. The JAX chunk logits are bf16×bf16 products with
an f32 output (``preferred_element_type``); ``torch.matmul`` of two bf16
tensors would round its output to bf16, so :func:`_mm_f32` keeps the
output in f32 (see there).
"""

from __future__ import annotations

import torch

from . import _dtensor as _dt

from ..core.errors import NotYetPorted


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over [..., m, k] × [..., k, n] with an f32 output and f32
    accumulation. Two bf16 CUDA operands go to cuBLAS as they are, asking
    for an f32 output (``out_dtype``): the tensor-core product with
    nothing rounded after the f32 sum. Anything else is widened to f32
    first, which is exact for bf16 (its products fit in f32), so both give
    the JAX package's bf16×bf16→f32 products up to the order of the sum."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        if a.dim() == b.dim() == 2:
            return torch.mm(a, b, out_dtype=torch.float32)
        lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        a3 = a.expand(*lead, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
        b3 = b.expand(*lead, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
        return torch.bmm(a3, b3, out_dtype=torch.float32).view(
            *lead, a.shape[-2], b.shape[-1])
    return torch.matmul(a.float(), b.float())


def _chunk_logits(hidden, weight, bias, base: int, chunk: int):
    """f32 logits of vocab columns [base, base + chunk), [n, chunk]. The
    JAX version pads the weight to whole chunks and masks the pad tail to
    −inf; here the last chunk's product covers only the real columns and
    its logits are padded with −inf, which gives the same values."""
    v = weight.shape[1]
    stop = min(base + chunk, v)
    logits = _mm_f32(hidden, weight[:, base:stop])
    if bias is not None:
        logits = logits + bias[base:stop].float()[None, :]
    if stop - base < chunk:
        logits = torch.nn.functional.pad(logits, (0, chunk - (stop - base)),
                                         value=float("-inf"))
    return logits


def _fwd_stats(hidden, weight, bias, labels, smooth_eps: float, chunk: int):
    """(nll [n] f32, lse [n] f32) by an online lse over the chunks."""
    n = hidden.shape[0]
    v = weight.shape[1]
    lab = labels.long()
    dev = hidden.device
    m = torch.full((n,), float("-inf"), dtype=torch.float32, device=dev)
    s = torch.zeros((n,), dtype=torch.float32, device=dev)
    tgt = torch.zeros((n,), dtype=torch.float32, device=dev)
    logit_sum = torch.zeros((n,), dtype=torch.float32, device=dev)
    rows = torch.arange(n, device=dev)
    for base in range(0, v, chunk):
        logits = _chunk_logits(hidden, weight, bias, base, chunk)
        m_new = torch.maximum(m, logits.amax(dim=1))
        s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=1)
        # the target logit lives in exactly one chunk
        in_chunk = (lab >= base) & (lab < base + chunk)
        local = (lab - base).clamp(0, chunk - 1)
        tgt = torch.where(in_chunk, logits[rows, local], tgt)
        logit_sum = logit_sum + logits[:, :min(chunk, v - base)].sum(dim=1)
        m = m_new
    lse = m + torch.log(s)
    nll = (1.0 - smooth_eps) * (lse - tgt) + smooth_eps * (lse - logit_sum / v)
    return nll, lse


class _ChunkedCE(torch.autograd.Function):
    """The JAX package's custom VJP (fused_ce.py :35-134): the forward
    keeps hidden, weight, bias, labels and lse; the backward recomputes
    each chunk's logits."""

    @staticmethod
    def forward(ctx, hidden, weight, bias, labels, smooth_eps, chunk):
        nll, lse = _fwd_stats(hidden, weight, bias, labels, smooth_eps, chunk)
        ctx.save_for_backward(hidden, weight, bias, labels, lse)
        ctx.smooth_eps, ctx.chunk = smooth_eps, chunk
        return nll

    @staticmethod
    def backward(ctx, g):
        hidden, weight, bias, labels, lse = ctx.saved_tensors
        eps, chunk = ctx.smooth_eps, ctx.chunk
        d, v = weight.shape
        lab = labels.long()
        g32 = g.float()
        mm_dtype = hidden.dtype  # the JAX package's bf16 matmuls, f32 sums
        dh = torch.zeros(hidden.shape, dtype=torch.float32, device=hidden.device)
        dw = torch.empty((d, v), dtype=torch.float32, device=hidden.device)
        db = torch.empty((v,), dtype=torch.float32, device=hidden.device)
        for base in range(0, v, chunk):
            width = min(chunk, v - base)
            logits = _chunk_logits(hidden, weight, bias, base, chunk)
            col = torch.arange(base, base + chunk, device=hidden.device)[None, :]
            valid = col < v
            p = torch.exp(logits - lse[:, None])  # the pad tail is −inf: p = 0
            onehot = (col == lab[:, None]).float()
            dlogits = ((p - (1.0 - eps) * onehot
                        - torch.where(valid, eps / v, 0.0)) * g32[:, None]
                       ).to(mm_dtype)[:, :width]
            dh = dh + _mm_f32(dlogits, weight[:, base:base + width].t())
            dw[:, base:base + width] = _mm_f32(hidden.t(), dlogits)
            db[base:base + width] = dlogits.float().sum(dim=0)
        d_bias = db.to(bias.dtype) if bias is not None else None
        return dh.to(hidden.dtype), dw.to(weight.dtype), d_bias, None, None, None


def chunked_softmax_cross_entropy(hidden, weight, bias, labels,
                                  smooth_eps: float = 0.0, chunk: int = 4096,
                                  logit_dtype=torch.float32):
    """Per-token CE of softmax(hidden @ weight + bias) against labels.

    hidden: [n, d] (batch and time flattened first); weight: [d, V];
    bias: [V] or None; labels: [n] int. Returns nll [n] f32.
    Differentiable in hidden, weight and bias."""
    if logit_dtype != torch.float32:
        raise NotYetPorted("chunked_softmax_cross_entropy with logits in "
                           f"{logit_dtype} (float32 only so far)")
    if _dt.is_dtensor(hidden) or _dt.is_dtensor(weight):
        # a mesh's tensors: the rows' batch shard kept, the head's weight
        # and bias gathered, the per-row nll back as a DTensor of the rows
        like = hidden if _dt.is_dtensor(hidden) else weight
        rows = (_dt.batch_placements(like) if like is hidden
                else _dt.kept_placements(like, ()))
        full = _dt.kept_placements(like, ())
        part = _dt.partial_where_sharded(rows)
        nll = _ChunkedCE.apply(_dt.local_at(hidden, like, rows),
                               _dt.local_at(weight, like, full, part),
                               _dt.local_at(bias, like, full, part),
                               _dt.local_at(labels, like, rows),
                               float(smooth_eps), int(chunk))
        return _dt.wrap(nll, like, rows)
    return _ChunkedCE.apply(hidden, weight, bias, labels, float(smooth_eps),
                            int(chunk))


__all__ = ["chunked_softmax_cross_entropy"]
