"""Ring attention: sequence (context) parallelism over the mesh's ``sp``
axis (counterpart of ``paddle_tpu.parallel.ring_attention``).

Each rank holds a query/key/value shard of the sequence; the K/V shards
travel around the ring (``batch_isend_irecv`` to the next rank, from the
previous one) and every ring step runs the flash forward kernel
(``ops.flash_attention.flash_attention(..., return_lse=True)``) on the
local queries against the visiting shard. The per-step (out, lse) pairs
merge in log space. The backward is a second ring: the flash backward
kernels (``_flash_bwd(..., delta=)``) with the COMBINED lse and δ; dq
accumulates locally, dk/dv accumulate on buffers that travel with their
K/V shard and arrive home after the full cycle.

The visiting rank's place relative to the local rank (earlier, own,
later) picks what a step computes. The rank is a Python int in each
process, so the choice is made on the host and an invisible step
launches nothing. Schedules:

- ``"ring"``: contiguous shards; an earlier rank's shard is fully
  visible, the own shard causally, a later one not at all. Rank r does
  r+1 real steps (:func:`causal_work_per_rank`).
- ``"zigzag"`` (causal default): the sequence is cut into 2n blocks and
  rank r holds blocks (r, 2n-1-r), so every rank does the same work on
  every step.

Each ring step is a function of tensors and shard indices
(:func:`fwd_step`, :func:`bwd_step`, :func:`merge`), and the exchange is
a function of its own (:func:`rotate`): the ring loop is those steps with
a rotation between them.

With ``layout="natural"`` a zigzag call gathers q/k/v into zigzag order
and the output back; a model that keeps its activations in zigzag order
(models/gpt.py permutes its ids once) passes ``layout="zigzag"``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..core.errors import enforce
from ..ops import flash_attention as fa

NEG_INF = -1e30


def merge(acc: torch.Tensor, lse_c: torch.Tensor, out_i: torch.Tensor,
          lse_i: torch.Tensor):
    """Log-space merge of one step's flash result into the running one
    (ring_attention.py:62): (acc, lse) in f32."""
    lse_new = torch.logaddexp(lse_c, lse_i)
    w_old = torch.exp(lse_c - lse_new)[..., None]
    w_new = torch.exp(lse_i - lse_new)[..., None]
    return acc * w_old + out_i.float() * w_new, lse_new


def _visibility(idx: int, src: int) -> int:
    """0: the visiting shard is an earlier rank's, 1: the own, 2: a later
    rank's."""
    return 0 if src < idx else (1 if src == idx else 2)


class _RingSchedule:
    """Contiguous shards (ring_attention.py:80)."""

    name = "ring"

    def __init__(self, causal: bool):
        self.causal = causal


class _ZigzagSchedule:
    """Rank r holds blocks (r, 2n-1-r) of the 2n-block split
    (ring_attention.py:120)."""

    name = "zigzag"
    causal = True


def fwd_step(schedule, q: torch.Tensor, k_cur: torch.Tensor, v_cur: torch.Tensor,
             acc: torch.Tensor, lse: torch.Tensor, idx: int, src: int):
    """One forward ring step on rank ``idx`` with the shard of rank
    ``src``: the flash forward on what is visible, merged into (acc,
    lse), which it returns."""
    if not schedule.causal:
        o, l_ = fa.flash_attention(q, k_cur, v_cur, causal=False, return_lse=True)
        return merge(acc, lse, o, l_)
    vis = _visibility(idx, src)
    if schedule.name == "ring":
        if vis == 2:
            return acc, lse  # invisible: nothing to merge
        o, l_ = fa.flash_attention(q, k_cur, v_cur, causal=vis == 1, return_lse=True)
        return merge(acc, lse, o, l_)
    h2 = q.shape[2] // 2
    if vis == 0:
        # an earlier rank: its first block precedes both local blocks,
        # its second follows both
        o, l_ = fa.flash_attention(q, k_cur[:, :, :h2], v_cur[:, :, :h2], causal=False,
                                   return_lse=True)
        return merge(acc, lse, o, l_)
    if vis == 1:
        # the own shard: local causal is the zigzag visibility
        o, l_ = fa.flash_attention(q, k_cur, v_cur, causal=True, return_lse=True)
        return merge(acc, lse, o, l_)
    # a later rank: both its blocks lie between the local blocks, seen
    # by the local second half only
    o, l_ = fa.flash_attention(q[:, :, h2:], k_cur, v_cur, causal=False, return_lse=True)
    a2, s2 = merge(acc[:, :, h2:], lse[:, :, h2:], o, l_)
    return torch.cat([acc[:, :, :h2], a2], 2), torch.cat([lse[:, :, :h2], s2], 2)


def bwd_step(schedule, q, k_cur, v_cur, out, lse, g, delta, dq, dk_cur, dv_cur,
             idx: int, src: int):
    """One backward ring step: the flash backward kernels with the
    combined ``lse`` and ``delta`` on what is visible, added into the f32
    (dq, dk_cur, dv_cur), which it returns."""
    def grads(qq, kk, vv, causal, oo, ll, gg, dd):
        return fa._flash_bwd(qq, kk, vv, None, None, None, causal, oo, ll, gg, delta=dd)

    if not schedule.causal:
        dq_i, dk_i, dv_i = grads(q, k_cur, v_cur, False, out, lse, g, delta)
        return dq + dq_i.float(), dk_cur + dk_i.float(), dv_cur + dv_i.float()
    vis = _visibility(idx, src)
    if schedule.name == "ring":
        if vis == 2:
            return dq, dk_cur, dv_cur
        dq_i, dk_i, dv_i = grads(q, k_cur, v_cur, vis == 1, out, lse, g, delta)
        return dq + dq_i.float(), dk_cur + dk_i.float(), dv_cur + dv_i.float()
    h2 = q.shape[2] // 2
    if vis == 0:
        dq_i, dk_h, dv_h = grads(q, k_cur[:, :, :h2], v_cur[:, :, :h2], False,
                                 out, lse, g, delta)
        dk_cur = torch.cat([dk_cur[:, :, :h2] + dk_h.float(), dk_cur[:, :, h2:]], 2)
        dv_cur = torch.cat([dv_cur[:, :, :h2] + dv_h.float(), dv_cur[:, :, h2:]], 2)
        return dq + dq_i.float(), dk_cur, dv_cur
    if vis == 1:
        dq_i, dk_i, dv_i = grads(q, k_cur, v_cur, True, out, lse, g, delta)
        return dq + dq_i.float(), dk_cur + dk_i.float(), dv_cur + dv_i.float()
    dq_h, dk_i, dv_i = grads(q[:, :, h2:], k_cur, v_cur, False, out[:, :, h2:],
                             lse[:, :, h2:], g[:, :, h2:], delta[:, :, h2:])
    dq = torch.cat([dq[:, :, :h2], dq[:, :, h2:] + dq_h.float()], 2)
    return dq, dk_cur + dk_i.float(), dv_cur + dv_i.float()


def rotate(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The ring's exchange: send each tensor to the next rank of
    ``group`` and receive the previous rank's, in one
    ``batch_isend_irecv``."""
    import torch.distributed as dist

    n, r = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)
    recv = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, t, prv, group) for t in recv]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return recv


def _ring_fwd(schedule, q, k, v, group, n: int, idx: int):
    b, h, sl, d = q.shape
    acc = torch.zeros((b, h, sl, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, sl), NEG_INF, dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for i in range(n):
        acc, lse = fwd_step(schedule, q, k_cur, v_cur, acc, lse, idx, (idx - i) % n)
        if i < n - 1:
            k_cur, v_cur = rotate([k_cur, v_cur], group)
    return acc.to(q.dtype), lse


def _ring_bwd(schedule, q, k, v, out, lse, g, group, n: int, idx: int):
    # delta does not depend on the K/V shard: once, not per step
    delta = (out.float() * g.float()).sum(-1)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    k_cur, v_cur = k, v
    for i in range(n):
        dq, dk, dv = bwd_step(schedule, q, k_cur, v_cur, out, lse, g, delta, dq, dk, dv,
                              idx, (idx - i) % n)
        # dk/dv ride with their shard and are home after n rotations
        if i < n - 1:
            k_cur, v_cur, dk, dv = rotate([k_cur, v_cur, dk, dv], group)
        else:
            dk, dv = rotate([dk, dv], group)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """The ring's custom VJP (ring_attention.py:274) on this rank's local
    shards."""

    @staticmethod
    def forward(ctx, q, k, v, schedule, group, n, idx):
        out, lse = _ring_fwd(schedule, q, k, v, group, n, idx)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = (schedule, group, n, idx)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        schedule, group, n, idx = ctx.ring
        dq, dk, dv = _ring_bwd(schedule, q, k, v, out, lse, g.contiguous(), group, n, idx)
        return dq, dk, dv, None, None, None, None


def ring_attention_local(q, k, v, group, causal: bool = False,
                         schedule: str = "ring") -> torch.Tensor:
    """Ring attention of this rank's local shards [b, h, s/n, d] over the
    process ``group`` (its ranks in sequence order), differentiable.
    ``schedule`` "zigzag" expects the shards in zigzag order."""
    import torch.distributed as dist

    n, idx = dist.get_world_size(group), dist.get_rank(group)
    sched = _ZigzagSchedule() if schedule == "zigzag" else _RingSchedule(causal)
    return _RingAttention.apply(q, k, v, sched, group, n, idx)


# --------------------------------------------------------------------------
# schedule accounting and the zigzag layout
# --------------------------------------------------------------------------


def causal_work_per_rank(n: int, schedule: str = "zigzag"):
    """Causal attention work per rank over a whole pass, in (sl/2)² score
    tiles (sl: the local shard's length): plain ring, r full steps (4)
    plus the diagonal (2); zigzag, 2 units on each of the n steps. Both
    sum to 2n²."""
    if schedule == "ring":
        return [4 * r + 2 for r in range(n)]
    if schedule == "zigzag":
        return [2 * n] * n
    raise ValueError(f"unknown schedule {schedule!r}")


def zigzag_order(seq_len: int, n: int, device=None) -> torch.Tensor:
    """The global sequence index order that puts blocks (r, 2n-1-r) of the
    2n-block split contiguously on rank r (int64)."""
    block = seq_len // (2 * n)
    idx = []
    for r in range(n):
        idx.extend(range(r * block, (r + 1) * block))
        idx.extend(range((2 * n - 1 - r) * block, (2 * n - r) * block))
    return torch.tensor(idx, dtype=torch.long, device=device)


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------


def sp_placements(x, mesh, axis_name: str, seq_dim: int = 2):
    """The placements an sp kernel takes ``x`` at: ``Shard(seq_dim)`` on
    the sp axis, a batch or head shard (dim 0 or 1) kept on the other
    axes, everything else replicated."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for a, pl in zip(mesh.axis_names, x.placements):
        if a == axis_name:
            out.append(Shard(seq_dim))
        elif isinstance(pl, Shard) and pl.dim in (0, 1) and pl.dim != seq_dim:
            out.append(pl)
        else:
            out.append(Replicate())
    return out


def _as_dtensor(x, mesh):
    from .api import replicate
    return x if hasattr(x, "to_local") else replicate(mesh, x)


def ring_attention(q, k, v, mesh, axis_name: str = "sp", causal: bool = False,
                   batch_axes: Optional[tuple] = ("dp", "fsdp"),
                   block_q: Optional[int] = None, block_k: Optional[int] = None,
                   schedule: str = "auto", layout: str = "natural"):
    """Attention over [b, h, s, d] DTensors with s sharded on ``axis_name``
    (ring_attention.py:318). A batch shard over the data axes and a head
    shard stay; the sequence is resharded onto the sp axis if it is not
    there. ``schedule``: "auto" takes "zigzag" for causal attention
    (falling back to "ring" when s does not divide by 2n) and "ring"
    otherwise. ``layout``: "natural" gathers into zigzag order and back
    per call; "zigzag" takes activations already in that order.
    ``block_q``/``block_k`` are TPU tile flags and are not used (the
    kernels choose their own tiles); ``batch_axes`` is read from the
    inputs' placements."""
    from torch.distributed.tensor import DTensor

    enforce(schedule in ("auto", "ring", "zigzag"),
            f"unknown schedule {schedule!r} (auto|ring|zigzag)")
    enforce(layout in ("natural", "zigzag"),
            f"unknown layout {layout!r} (natural|zigzag)")
    if axis_name not in mesh.axis_names or mesh.shape[axis_name] == 1:
        return fa.flash_attention(q, k, v, causal=causal)
    n = mesh.shape[axis_name]
    s = q.shape[2]
    if schedule == "auto":
        schedule = "zigzag" if (causal and s % (2 * n) == 0) else "ring"
    if schedule == "zigzag" and not causal:
        schedule = "ring"  # zigzag only changes causal visibility
    enforce(not (layout == "zigzag" and schedule != "zigzag"),
            f"layout='zigzag' requires the zigzag schedule, but schedule resolved to "
            f"{schedule!r} (causal={causal}, seq={s}, 2n={2 * n}); un-permute the "
            "activations or fix seq divisibility")
    if schedule == "zigzag":
        enforce(s % (2 * n) == 0, f"zigzag needs seq {s} divisible by 2n={2 * n}")
    enforce(s % n == 0, f"ring attention needs seq {s} divisible by sp={n}")
    q, k, v = (_as_dtensor(t, mesh) for t in (q, k, v))
    order = inv = None
    if schedule == "zigzag" and layout == "natural":
        # the gathers' indices as replicated DTensors: their backward
        # (an index_put) then sees DTensors only, in or out of the step
        order = zigzag_order(s, n, device=mesh.device)
        inv = _as_dtensor(torch.argsort(order), mesh)
        order = _as_dtensor(order, mesh)
        q, k, v = (t[:, :, order] for t in (q, k, v))
    pl = sp_placements(q, mesh, axis_name)
    q, k, v = (t.redistribute(placements=pl) for t in (q, k, v))
    out = ring_attention_local(q.to_local(), k.to_local(), v.to_local(),
                               mesh.group(axis_name), causal, schedule)
    out = DTensor.from_local(out, mesh.device_mesh, pl, run_check=False)
    if inv is not None:
        out = out[:, :, inv]
    return out


__all__ = ["bwd_step", "causal_work_per_rank", "fwd_step", "merge", "ring_attention",
           "ring_attention_local", "rotate", "sp_placements", "zigzag_order"]
