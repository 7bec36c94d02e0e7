"""Mixture of experts with expert parallelism over the mesh ``ep`` axis
(counterpart of ``paddle_tpu.parallel.moe``).

A top-k-routed bank of expert FFNs (GShard/Switch style, static shapes):

- the router's softmax in f32, top-k selection with a static capacity per
  expert, C = ceil(tokens · k / E · capacity_factor); a token past its
  expert's capacity is dropped (its combine weight is zero);
- positions within an expert are given k-major (every first choice before
  any second choice), ties between equal probabilities broken as
  ``jax.lax.top_k`` breaks them, lower expert index first (a stable
  descending sort; ``torch.topk`` promises no order among ties);
- dispatch and combine are one-hot products, ``[t, E·C]`` matrices times
  the tokens (``torch.matmul``): the ``[t, k, E, C]`` product of the JAX
  einsum is never formed, each matrix is written by one scatter of the k
  choices a token;
- the experts run as one batched product over the bank ``[E_local, C', d]``
  in the compute dtype, the router in f32.

On a mesh with ``ep`` > 1 the experts are sharded over ``ep`` and the
tokens over the data axes and ``ep``; two ``all_to_all_single`` calls over
the ep group swap the token and expert shardings around the experts, with
autograd through both. The capacity comes from the GLOBAL batch, as the
JAX function traces it: ``t_local = B / shards · S`` with B the DTensor's
global batch, whatever rows the Trainer gave this rank. A
``pipeline.LocalRanks(n, "ep")`` in place of the mesh runs the n ep ranks
in this process on one device, through the same per-rank layouts, with an
all-to-all that slices and concatenates. With ``ep`` = 1 (or
no mesh) the same algorithm runs dense; on a mesh its tokens are gathered
so that every rank routes the whole batch, as GSPMD runs the JAX dense
path.

Returns ``(out, aux_loss)``: aux is the load-balance term (mean router
probability · dispatch fraction · E), averaged over the data and ep ranks
on the ep path.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.errors import enforce
from ..framework import LayerHelper, cast_compute, compute_dtype, current_context
from .. import initializer as init
from . import mesh as mesh_lib
from .pipeline import LocalRanks
from .sharding import PartitionSpec as P


# -- the static routing config of every moe() call, when captured ---------------

_capture_tls = threading.local()


@contextlib.contextmanager
def capture_moe_configs():
    """Collect the static routing config of every :func:`moe` layer run
    inside the block (moe.py:55); yields the list the records append to.
    Nested captures each see only their own block's layers."""
    prev = getattr(_capture_tls, "log", None)
    _capture_tls.log = log = []
    try:
        yield log
    finally:
        _capture_tls.log = prev


def _record_config(**cfg) -> None:
    log = getattr(_capture_tls, "log", None)
    if log is not None:
        log.append(cfg)


def _topk(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, larger first
    and, among equal values, the lower index first (``lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _topk_dispatch(probs, top_k: int, capacity: int, normalize_gates: bool):
    """Dispatch and combine ``[t, E, C]`` and the choice mask ``[t, k, E]``
    from router probs ``[t, E]`` (moe.py:77): positions within an expert
    k-major, so first choices are dropped last."""
    t, e = probs.shape
    vals, idx = _topk(probs, top_k)                       # [t, k]
    if normalize_gates:
        vals = vals / (vals.sum(-1, keepdim=True) + 1e-9)
    mask = torch.nn.functional.one_hot(idx, e).float()    # [t, k, E]
    flat = mask.transpose(0, 1).reshape(top_k * t, e)
    pos = torch.cumsum(flat, 0) - flat                    # position within expert
    pos = pos.reshape(top_k, t, e).transpose(0, 1)
    pos_k = (pos * mask).sum(-1)                          # [t, k]
    keep = (pos_k < capacity).float()
    # one scatter of the k choices a row: the choices' experts differ, so
    # their (expert, slot) cells do too
    cell = idx * capacity + pos_k.long().clamp(max=capacity - 1)
    zeros = torch.zeros((t, e * capacity), dtype=torch.float32, device=probs.device)
    dispatch = zeros.scatter(1, cell, keep)
    combine = zeros.scatter(1, cell, keep * vals)
    return (dispatch.view(t, e, capacity), combine.view(t, e, capacity), mask)


def _aux_loss(probs, mask):
    """Load-balance loss (Switch eq. 4): E · Σ_e fraction_e · meanprob_e."""
    e = probs.shape[-1]
    me = probs.mean(0)
    ce = mask.sum(1).mean(0)
    ce = ce / torch.clamp(ce.sum(), min=1e-9)
    return e * (me * ce).sum()


def _expert_ffn(xe, w1, b1, w2, b2, act, cdtype=None):
    """The expert bank over ``xe`` [E_local, C', d] (moe.py:107): products in
    the compute dtype, biases cast to it."""
    xe, w1, w2 = cast_compute(compute_dtype() if cdtype is None else cdtype, xe, w1, w2)
    h = torch.bmm(xe, w1) + b1[:, None, :].to(xe.dtype)
    h = act(h)
    return torch.bmm(h, w2) + b2[:, None, :].to(xe.dtype)


def _route(xt, wg, top_k: int, capacity: int, normalize_gates: bool, cdtype=None):
    """The router and the dispatch over tokens ``xt`` [t, d]: (the experts'
    input [E, C, d] in the compute dtype, combine [t, E, C], aux)."""
    logits = torch.matmul(xt.float(), wg)
    probs = torch.softmax(logits, dim=-1)
    dispatch, combine, mask = _topk_dispatch(probs, top_k, capacity, normalize_gates)
    aux = _aux_loss(probs, mask)
    xt_c = cast_compute(compute_dtype() if cdtype is None else cdtype, xt)
    t, e, c = dispatch.shape
    # "tec,td->ecd" as one product of the [t, E·C] one-hot matrix
    xe = torch.matmul(dispatch.reshape(t, e * c).t().to(xt_c.dtype), xt_c)
    return xe.view(e, c, -1), combine, aux


def _combine(combine, ye):
    """"tec,ecd->td" as one product: tokens ``[t, d]`` from ``ye`` [E, C, d]."""
    t, e, c = combine.shape
    return torch.matmul(combine.reshape(t, e * c).to(ye.dtype), ye.reshape(e * c, -1))


def _route_compute(xts, wg, banks, *, top_k, capacity, act, normalize_gates,
                   exchange=None):
    """Router → dispatch → experts → combine (moe.py:122) over the tokens of
    each rank this process runs, ``xts`` (a list of [t, d]), with each
    rank's expert bank ``banks`` (a list of (w1, b1, w2, b2)).
    ``exchange(tensors, inverse)`` wraps the experts with the ep
    token↔expert reshard; None on the dense path (one rank, the whole
    bank). Returns (a [t, d] a rank, an aux a rank)."""
    routed = [_route(xt, wg, top_k, capacity, normalize_gates) for xt in xts]
    xes = [xe for xe, _, _ in routed]
    if exchange is not None:
        xes = exchange(xes, inverse=False)
    yes = [_expert_ffn(xe, *bank, act) for xe, bank in zip(xes, banks)]
    if exchange is not None:
        yes = exchange(yes, inverse=True)
    return ([_combine(combine, ye) for (_, combine, _), ye in zip(routed, yes)],
            [aux for _, _, aux in routed])


def _send_layout(x: torch.Tensor, n: int, inverse: bool) -> torch.Tensor:
    """One rank's send buffer [n (destination), E/n, C, d]: from its tokens'
    slots [E, C, d], or with ``inverse`` from its experts' outputs
    [E/n, n·C, d]."""
    if not inverse:
        e, c, d = x.shape
        return x.reshape(n, e // n, c, d)
    el, nc, d = x.shape
    return x.reshape(el, n, nc // n, d).permute(1, 0, 2, 3)


def _recv_layout(y: torch.Tensor, inverse: bool) -> torch.Tensor:
    """One rank's receive buffer [n (source), E/n, C, d] as its experts'
    input [E/n, n·C, d], or with ``inverse`` as its tokens' slots [E, C, d]."""
    n, el, c, d = y.shape
    if not inverse:
        return y.permute(1, 0, 2, 3).reshape(el, n * c, d)
    return y.reshape(n * el, c, d)


def _exchange_local(xs, n: int, inverse: bool, all_to_all):
    """Token shard ↔ expert shard of each rank's tensor in ``xs``:
    [E, C, d] → [E/n, n·C, d] (``lax.all_to_all(split_axis=0,
    concat_axis=1, tiled=True)``), and back with ``inverse``.
    ``all_to_all`` maps the ranks' send buffers to their receive buffers
    (lists, one tensor a rank this process runs)."""
    ys = all_to_all([_send_layout(x, n, inverse) for x in xs])
    return [_recv_layout(y, inverse) for y in ys]


def _group_all_to_all(group):
    """This rank's all-to-all over the process ``group``."""
    from .ulysses import _all_to_all
    return lambda bufs: [_all_to_all(bufs[0], group)]


def _ranks_all_to_all(bufs):
    """The all-to-all of ranks run in this process: rank r receives slot r
    of every rank's send buffer, in rank order."""
    return [torch.stack([b[r] for b in bufs]) for r in range(len(bufs))]


class _Exchange(torch.autograd.Function):
    """:func:`_exchange_local` under autograd: the backward is the inverse
    exchange of the cotangents."""

    @staticmethod
    def forward(ctx, all_to_all, n, inverse, *xs):
        ctx.args = (all_to_all, n, inverse)
        return tuple(_exchange_local(list(xs), n, inverse, all_to_all))

    @staticmethod
    def backward(ctx, *gs):
        all_to_all, n, inverse = ctx.args
        return (None, None, None, *_exchange_local(list(gs), n, not inverse, all_to_all))


class _Pmean(torch.autograd.Function):
    """``lax.pmean`` of a value that varies over the group, invariant after:
    each rank's cotangent is the output's divided by the group's size."""

    @staticmethod
    def forward(ctx, x, group, n):
        import torch.distributed as dist
        ctx.n = n
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def _moe_body(xs, wg, banks, *, all_to_all, n, top_k, capacity, act, normalize_gates,
              pmean):
    """The ep computation (moe.py:147) of the ranks this process runs: ``xs``
    their tokens [b_local, s, d] a rank, ``banks`` their expert shards
    (w1, b1, w2, b2) [E/n, ...], ``wg`` the whole router; ``all_to_all``
    as :func:`_exchange_local` takes it, ``pmean`` the mean of the ranks'
    aux losses over the data and ep ranks. Returns (out [b_local, s, d] a
    rank, the averaged aux)."""
    def exchange(ts, inverse):
        return list(_Exchange.apply(all_to_all, n, inverse, *ts))

    yts, auxes = _route_compute([x.reshape(-1, x.shape[-1]) for x in xs], wg, banks,
                                top_k=top_k, capacity=capacity, act=act,
                                normalize_gates=normalize_gates, exchange=exchange)
    return [yt.reshape(x.shape).to(x.dtype) for yt, x in zip(yts, xs)], pmean(auxes)


def moe(x, num_experts: int, d_ff: int, top_k: int = 2, capacity_factor: float = 1.25,
        mesh=None, axis_name: str = mesh_lib.EP, act: str = "gelu",
        normalize_gates: bool = True, param_attr=None,
        name: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k-routed MoE FFN over ``x`` [batch, seq, d_model] (moe.py:170):
    ``router_w`` [d, E] and the bank ``expert_w1`` [E, d, d_ff],
    ``expert_b1``, ``expert_w2`` [E, d_ff, d], ``expert_b2``, all f32.
    Returns ``(out, aux_loss)``. With ``mesh`` (a :class:`parallel.Mesh`)
    and its ``ep`` axis > 1 the experts are sharded over ``ep`` and the
    tokens exchanged by all-to-all (``x`` a DTensor of the mesh, or the same
    whole tensor on every rank); a ``LocalRanks`` runs its ep ranks in this
    process; otherwise the dense path, with the same numerics where
    capacity allows."""
    from ..layers.ops import apply_activation

    helper = LayerHelper("moe", name=name)
    b, s, d = x.shape
    act_fn = lambda h: apply_activation(h, act)  # noqa: E731

    wg = helper.create_parameter("router_w", shape=(d, num_experts), dtype=torch.float32,
                                 attr=param_attr)
    w1 = helper.create_parameter("expert_w1", shape=(num_experts, d, d_ff),
                                 dtype=torch.float32, attr=param_attr)
    b1 = helper.create_parameter("expert_b1", shape=(num_experts, d_ff), dtype=torch.float32,
                                 initializer=init.Constant(0.0))
    w2 = helper.create_parameter("expert_w2", shape=(num_experts, d_ff, d),
                                 dtype=torch.float32, attr=param_attr)
    b2 = helper.create_parameter("expert_b2", shape=(num_experts, d), dtype=torch.float32,
                                 initializer=init.Constant(0.0))

    ep = mesh.shape[axis_name] if mesh is not None and axis_name in mesh.axis_names else 1
    if ep > 1 and num_experts % ep != 0:
        raise ValueError(f"num_experts={num_experts} not divisible by ep={ep}")
    data_axes = () if mesh is None else tuple(
        a for a in mesh_lib.data_axis_names(mesh) if mesh.shape[a] > 1)
    shards = ep * int(np.prod([mesh.shape[a] for a in data_axes] or [1]))
    t_local = (b // max(1, shards)) * s if ep > 1 else b * s
    capacity = max(1, int(math.ceil(t_local * top_k / num_experts * capacity_factor)))
    ctx = current_context()
    _record_config(name=ctx.full_name(helper.name) if ctx else helper.name,
                   num_experts=num_experts, top_k=top_k,
                   capacity_factor=float(capacity_factor), capacity=capacity,
                   tokens=t_local, ep=ep)

    if ep == 1:
        if mesh is None or not _on_mesh(x, wg):
            (yt,), (aux,) = _route_compute([x.reshape(b * s, d)], wg, [(w1, b1, w2, b2)],
                                           top_k=top_k, capacity=capacity, act=act_fn,
                                           normalize_gates=normalize_gates)
            return yt.reshape(b, s, d).to(x.dtype), aux
        return _dense_on_mesh(x, (wg, w1, b1, w2, b2), mesh, top_k, capacity, act_fn,
                              normalize_gates)
    if isinstance(mesh, LocalRanks):
        return _ep_local(x, (wg, w1, b1, w2, b2), ep, top_k, capacity, act_fn,
                         normalize_gates)
    return _ep_on_mesh(x, (wg, w1, b1, w2, b2), mesh, axis_name, data_axes, top_k,
                       capacity, act_fn, normalize_gates)


def _on_mesh(*ts) -> bool:
    from ..ops._dtensor import is_dtensor
    return any(is_dtensor(t) for t in ts)


def _dense_on_mesh(x, params, mesh, top_k, capacity, act, normalize_gates):
    """The dense path on a mesh's DTensors: every rank routes the whole
    batch (the global token order and capacity of the JAX dense path under
    GSPMD), and keeps its rows of the output."""
    from torch.distributed.tensor import Replicate

    from ..ops._dtensor import batch_placements, is_dtensor, local_at, wrap

    whole = [Replicate()] * len(mesh.axis_names)
    b, s, d = x.shape
    xl = local_at(x, mesh, whole)
    wg, w1, b1, w2, b2 = (local_at(t, mesh, whole) for t in params)
    (yt,), (aux,) = _route_compute([xl.reshape(b * s, d)], wg, [(w1, b1, w2, b2)],
                                   top_k=top_k, capacity=capacity, act=act,
                                   normalize_gates=normalize_gates)
    out = wrap(yt.reshape(b, s, d).to(xl.dtype), mesh, whole)
    if is_dtensor(x):
        out = out.redistribute(placements=batch_placements(x))
    return out, wrap(aux, mesh, whole)


def _ep_on_mesh(x, params, mesh, axis_name, data_axes, top_k, capacity, act,
                normalize_gates):
    """The ep path: tokens sharded over the data axes and ep (data major, as
    the JAX spec ``P((*data, ep))``), the bank over ep, the router whole.
    Each input's local grad is declared for what it is: the tokens' rows
    their own, the router's a sum over the data and ep ranks, the bank's a
    sum over the data ranks."""
    from torch.distributed.tensor import Partial, Replicate

    from ..ops._dtensor import batch_placements, is_dtensor, local_at, wrap
    from .sharding import placements

    varying = tuple(data_axes) + (axis_name,)
    lead = varying if len(varying) > 1 else varying[0]
    x_pl = placements(P(lead, None, None), mesh)
    e_pl = placements(P(axis_name), mesh)
    whole = [Replicate()] * len(mesh.axis_names)
    wg_grad = [Partial() if a in varying else Replicate() for a in mesh.axis_names]
    e_grad = [Partial() if a in data_axes else q for a, q in zip(mesh.axis_names, e_pl)]
    wg, w1, b1, w2, b2 = params
    xl = local_at(x, mesh, x_pl)
    wgl = local_at(wg, mesh, whole, wg_grad)
    w1l, b1l, w2l, b2l = (local_at(t, mesh, e_pl, e_grad) for t in (w1, b1, w2, b2))
    n = mesh.shape[axis_name]
    pmean_n = int(np.prod([mesh.shape[a] for a in varying]))
    pmean_group = mesh.axes_group(tuple(a for a in mesh.axis_names if a in varying))
    (out,), aux = _moe_body([xl], wgl, [(w1l, b1l, w2l, b2l)],
                            all_to_all=_group_all_to_all(mesh.group(axis_name)), n=n,
                            top_k=top_k, capacity=capacity, act=act,
                            normalize_gates=normalize_gates,
                            pmean=lambda auxes: _Pmean.apply(auxes[0], pmean_group, pmean_n))
    out = wrap(out, mesh, x_pl)
    out = out.redistribute(placements=batch_placements(x) if is_dtensor(x) else whole)
    if not is_dtensor(x):
        out = out.to_local()
    return out, wrap(aux, mesh, whole)


def _ep_local(x, params, n, top_k, capacity, act, normalize_gates):
    """The ep path of ``n`` ranks run in this process (a :class:`LocalRanks`
    mesh): rank r takes the r-th of ``n`` row blocks of ``x`` and the r-th
    of ``n`` blocks of the bank, the all-to-all slices and concatenates,
    and the aux is the mean of the ranks'. Returns (out [b, s, d], aux)."""
    b = x.shape[0]
    enforce(b % n == 0, f"batch {b} does not split over {n} ep ranks")
    wg, *bank = params
    banks = list(zip(*(t.chunk(n) for t in bank)))
    outs, aux = _moe_body(list(x.chunk(n)), wg, banks, all_to_all=_ranks_all_to_all, n=n,
                          top_k=top_k, capacity=capacity, act=act,
                          normalize_gates=normalize_gates,
                          pmean=lambda auxes: torch.stack(auxes).mean())
    return torch.cat(outs), aux


def moe_ep_rules():
    """Sharding-rule entries placing the expert banks on ``ep`` (moe.py:249):
    append them to a rule table (``transformer_tp_rules(extra=...)``)."""
    return [
        (r".*moe.*/expert_(w1|b1|w2|b2)$", P("ep")),
        (r".*moe.*/router_w$", P()),
    ]


__all__ = ["capture_moe_configs", "moe", "moe_ep_rules"]
