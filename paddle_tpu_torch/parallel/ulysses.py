"""Ulysses sequence parallelism: an all-to-all head↔sequence reshard
(counterpart of ``paddle_tpu.parallel.ulysses``).

Where ring attention keeps the queries in place and passes K/V shards
around, Ulysses reshards so that attention runs over the WHOLE sequence
on h/n heads per rank:

    [b, h, s/n, d] —all_to_all→ [b, h/n, s, d] —attention→
    [b, h/n, s, d] —all_to_all→ [b, h, s/n, d]

Two ``all_to_all_single`` calls a direction; the inner attention (the
flash kernels when the caller passes them) sees the whole sequence and
needs nothing else. Needs num_heads % sp == 0.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.errors import enforce


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dist.all_to_all_single(out, x, group=group)
    return out


def seq_to_head(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Local [b, h, s/n, d] → [b, h/n, s, d]: rank j's head chunk goes to
    rank j, and the sequence chunks come back in rank order."""
    b, h, sl, d = x.shape
    x = x.reshape(b, n, h // n, sl, d).permute(1, 0, 2, 3, 4)
    y = _all_to_all(x, group)                       # [n (seq chunk), b, h/n, sl, d]
    return y.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * sl, d)


def head_to_seq(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The inverse of :func:`seq_to_head`: [b, h/n, s, d] → [b, h, s/n, d]."""
    b, hn, s, d = x.shape
    x = x.reshape(b, hn, n, s // n, d).permute(2, 0, 1, 3, 4)
    y = _all_to_all(x, group)                       # [n (head chunk), b, h/n, s/n, d]
    return y.permute(1, 0, 2, 3, 4).reshape(b, n * hn, s // n, d)


class _SeqToHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return seq_to_head(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return head_to_seq(g, ctx.group, ctx.n), None, None


class _HeadToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return head_to_seq(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return seq_to_head(g, ctx.group, ctx.n), None, None


def _plain_attention(q, k, v, causal: bool):
    from ..layers.attention import scaled_dot_product_attention
    return scaled_dot_product_attention(q, k, v, causal=causal)


def ulysses_local(q, k, v, group, causal: bool, attn_fn: Callable):
    """Ulysses attention of this rank's local shards [b, h, s/n, d] over
    the process ``group``, differentiable."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    qh, kh, vh = (_SeqToHead.apply(t, group, n) for t in (q, k, v))
    return _HeadToSeq.apply(attn_fn(qh, kh, vh, causal), group, n)


def ulysses_attention(q, k, v, mesh, axis_name: str = "sp", causal: bool = False,
                      batch_axes: Optional[tuple] = ("dp", "fsdp"),
                      attn_fn: Optional[Callable] = None):
    """Attention over [b, h, s, d] DTensors with s sharded on ``axis_name``
    (ulysses.py:52). ``attn_fn(q, k, v, causal)`` is the whole-sequence
    inner attention on local tensors (default: plain softmax attention;
    pass the flash kernel to compose with it). A batch shard stays, and a
    head shard on another axis (a tp rule's) is gathered first;
    ``batch_axes`` is read from the inputs' placements."""
    from torch.distributed.tensor import DTensor, Replicate

    from .ring_attention import _as_dtensor, sp_placements

    fn = attn_fn or _plain_attention
    if axis_name not in mesh.axis_names or mesh.shape[axis_name] == 1:
        return fn(q, k, v, causal)
    n = mesh.shape[axis_name]
    if q.shape[1] % n != 0:
        raise ValueError(f"ulysses needs num_heads ({q.shape[1]}) divisible by "
                         f"sp axis size ({n}); use ring_attention otherwise")
    enforce(q.shape[2] % n == 0, f"ulysses needs seq {q.shape[2]} divisible by sp={n}")
    q, k, v = (_as_dtensor(t, mesh) for t in (q, k, v))
    # the heads are gathered first: the JAX function's in_specs P(batch,
    # None, sp, None) replicate a head shard that a tp rule left on another
    # axis (ulysses.py:73), and this axis' all-to-all reshards them
    pl = [Replicate() if getattr(p, "dim", None) == 1 else p
          for p in sp_placements(q, mesh, axis_name)]
    q, k, v = (t.redistribute(placements=pl) for t in (q, k, v))
    out = ulysses_local(q.to_local(), k.to_local(), v.to_local(), mesh.group(axis_name),
                        causal, fn)
    return DTensor.from_local(out, mesh.device_mesh, pl, run_check=False)


__all__ = ["head_to_seq", "seq_to_head", "ulysses_attention", "ulysses_local"]
