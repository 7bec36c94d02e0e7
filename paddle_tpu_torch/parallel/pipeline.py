"""Pipeline parallelism over the ``pp`` mesh axis (counterpart of
``paddle_tpu.parallel.pipeline``).

Per-layer parameters are stacked on a leading ``[num_layers, ...]`` axis
and split over ``pp``. A schedule runs M microbatches through the ranks:
each tick every rank applies its layer chunk to the activation it holds,
then passes the result to the next rank. Activations enter at rank 0 and
leave at rank P-1, whose finished microbatches are summed over ``pp`` so
that every rank holds them.

Two schedules, chosen by ``interleave`` (V, virtual stages a rank), as in
the JAX module:

- V = 1 (GPipe): rank r owns one contiguous span of L/P layers; the loop
  runs M + P - 1 ticks, P - 1 of them fill and drain.
- V > 1 (interleaved): rank r owns V non-adjacent chunks of L/(P·V)
  layers (global chunk q on rank q mod P), and chunk q of microbatch j
  runs at tick (j÷P)·VP + (q÷P)·P + (q mod P) + (j mod P). An activation
  made at tick t is used at tick t + 1 by the next rank, so each tick has
  one exchange as in GPipe, and the bubble shrinks V-fold
  (:func:`bubble_fraction`). ``param_layout="interleaved"`` says that the
  stacked rows already rest in the rank-major chunk order of
  :func:`interleave_perm` (the Trainer stores them so), so a rank's chunks
  are its own rows; ``"stacked"`` (logical order) gathers the rows over
  ``pp`` each step when V > 1.

One function computes a rank's tick, :func:`pp_tick`, and two drivers
share it:

- :func:`pipeline_apply` runs on the ``pp`` group of a
  :class:`parallel.Mesh`, each rank a process. The exchange is a
  ``batch_isend_irecv`` to rank r + 1 from rank r - 1, its backward the
  same exchange reversed. The stacked params and the activations are
  DTensors there (the Trainer's scope): the schedule runs on their local
  shards and hands back a DTensor with the batch's placements, so no
  DTensor reaches a kernel launch.
- :func:`pipeline_local` runs all P ranks' ticks in lockstep in one
  process on one device, a rotation of the list standing for the
  exchange: the CPU tests and the card drive the schedule through it.
  :class:`LocalRanks` stands for such a set of ranks where a mesh is
  taken (``framework.pipeline_mode(LocalRanks(4), 8)``), so a program's
  stacks run the schedule on one device through ``apply_stacked``.

Every rank computes every tick, bubble ticks included, as the JAX
function does, so each rank issues the same sequence of collectives in
the forward and in the backward.

Gradients follow the JAX function's, which runs its ``shard_map`` with
the varying-axes check off whenever tensor parallelism, extras or an rng
is in play (pipeline.py:362-370): inside the per-rank region a ``psum``
(:func:`psum`, the final sum over ``pp`` and the stages' tp sums) reduces
its cotangent as well, the output's cotangent is divided by the sizes of
the mesh axes the output is replicated over, and an input's local grad is
a ``Partial`` sum over the axes it is replicated over. Together these give
the sequential stack's gradients.

Dropout: with ``rng_key`` (an int tag) each (global layer, microbatch,
data-shard position) draws from its own generator, seeded from the
running program's seed and those three folded into the tag
(:func:`framework.rng_derived`), so the masks decorrelate across layers
and microbatches and repeat for the same step seed. The tp axis is not
folded, as in the JAX module: a layer's masks agree across its tp ranks.

A rank's local microbatches are its rows of each global microbatch in its
own order: the rows that share a microbatch differ from the JAX
function's grouping when the batch is also split over data axes, which
changes no result at dropout 0 (the blocks are row-wise).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..core.errors import enforce


# -- trees of tensors (a dict of leaves, or one tensor) -------------------------


def _tree_map(fn, tree, *rest):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def stack_layer_params(per_layer_params: list) -> Any:
    """Stack a list of per-layer param trees into ``[L, ...]`` leaves."""
    first = per_layer_params[0]
    if isinstance(first, dict):
        return {k: stack_layer_params([p[k] for p in per_layer_params]) for k in first}
    return torch.stack(list(per_layer_params))


def interleave_perm(L: int, pp: int, v: int) -> np.ndarray:
    """Row permutation taking logical layer order to the rank-major
    chunk-interleaved rest layout: row j holds logical layer ``perm[j]``;
    rank r's V chunks lie at rows [r·V·Lc, (r+1)·V·Lc), its local chunk c
    being global chunk c·P + r. The inverse is ``np.argsort(perm)``."""
    enforce(L % (pp * v) == 0, f"{L} layers not divisible by pp·interleave={pp}·{v}")
    Lc = L // (pp * v)
    perm = np.empty(L, dtype=np.int64)
    j = 0
    for r in range(pp):
        for c in range(v):
            g = c * pp + r
            for i in range(Lc):
                perm[j] = g * Lc + i
                j += 1
    return perm


def _schedule_ticks(m: int, p: int, v: int) -> int:
    """Ticks of the schedule: the last microbatch's last chunk runs at
    ((m-1)÷p)·vp + (v-1)·p + (p-1) + ((m-1) mod p), plus one."""
    return ((m - 1) // p) * v * p + (v - 1) * p + (p - 1) + ((m - 1) % p) + 1


def bubble_fraction(pp: int, microbatches: int, interleave: int = 1) -> float:
    """The schedule's share of wasted ticks: each rank computes every
    tick and M·V of them are useful. (P-1)/(M·V+P-1) when P divides M or V
    is 1, larger when P does not divide M and V > 1."""
    t = _schedule_ticks(microbatches, pp, interleave)
    return (t - microbatches * interleave) / t


def tick_slot(rank: int, t: int, p: int, m: int, v: int) -> Tuple[int, int, bool, bool]:
    """What rank ``rank`` does at tick ``t`` (pipeline.py:156-172): (its
    local chunk, the microbatch, whether it takes a fresh microbatch,
    whether it finishes one)."""
    groups = -(-m // p)
    u_glob = min(max(t - rank, 0), groups * v * p - 1)
    g, u = divmod(u_glob, v * p)
    c_local = u // p
    j = g * p + u % p
    mb = min(max(j, 0), m - 1)
    ingest = rank == 0 and c_local == 0
    record = rank == p - 1 and c_local == v - 1 and t - rank >= 0 and j < m
    return c_local, mb, ingest, record


def _flag(value: bool, like: torch.Tensor) -> torch.Tensor:
    # filled on the device: a copy from the host could not be captured
    return torch.full((), bool(value), dtype=torch.bool, device=like.device)


def _layer_rng(rng_key: Optional[int], layer: int, mb: int):
    if rng_key is None:
        return contextlib.nullcontext()
    from ..framework import rng_derived
    from ..initializer import mix_seed
    return rng_derived(mix_seed(mix_seed(rng_key, layer), mb))


def pp_tick(rank: int, t: int, holding, xm, chunks, exm, layer_fn: Callable,
            p: int, m: int, v: int, rng_key: Optional[int] = None):
    """One rank's tick (the body of ``_pp_body``, pipeline.py:106): take a
    fresh microbatch from ``xm`` [M, mb, ...] (rank 0 starting a chunk-0
    pass) or the activation ``holding``, and run this rank's chunk of the
    tick over it, with the microbatch's slice of the extras ``exm``.
    ``chunks`` is the rank's param tree ``[V, Lc, ...]``; chunk c is global
    chunk c·P + rank. Returns (the activation the rank passes on, its
    microbatch, whether it finished that microbatch)."""
    c, mb, ingest, record = tick_slot(rank, t, p, m, v)
    cur = torch.where(_flag(ingest, holding), xm[mb], holding)
    extra = _tree_map(lambda e: e[mb], exm)
    lc = _leaves(chunks)[0].shape[1]
    base = (c * p + rank) * lc
    for li in range(lc):
        lp = _tree_map(lambda leaf: leaf[c, li], chunks)
        with _layer_rng(rng_key, base + li, mb):
            cur = layer_fn(cur, lp) if extra is None else layer_fn(cur, lp, extra)
    return cur, mb, record


def _rank_chunks(stacked, rank: int, p: int, v: int, param_layout: str):
    """Rank ``rank``'s chunks ``[V, Lc, ...]`` of whole stacked leaves: rows
    [V, P, Lc] → [P, V, Lc] in logical order, or its own rows of the
    interleaved layout."""
    def take(leaf):
        lc = leaf.shape[0] // (p * v)
        rest = tuple(leaf.shape[1:])
        if param_layout == "interleaved":
            return leaf.reshape((p, v, lc) + rest)[rank]
        return leaf.reshape((v, p, lc) + rest)[:, rank]
    return _tree_map(take, stacked)


class LocalRanks:
    """P ranks run in this process on one device, passed where a
    :class:`parallel.Mesh` is taken: ``axis_names`` and ``shape`` name its
    one axis. Pipeline ranks (:func:`pipeline_local`), or with ``axis_name``
    "ep" the expert-parallel ranks of ``parallel.moe.moe``."""

    def __init__(self, pp: int, axis_name: str = "pp"):
        self.axis_names = (axis_name,)
        self.shape = {axis_name: int(pp)}

    def __repr__(self):
        return f"LocalRanks({self.shape})"


def _check(L: int, b: int, p: int, v: int, microbatches: int, dshard: int,
           axes_named: tuple, param_layout: str) -> int:
    """The JAX function's enforcements; returns the microbatch size."""
    enforce(param_layout in ("stacked", "interleaved"),
            f"unknown param_layout {param_layout!r} ('stacked'|'interleaved')")
    enforce(L % (p * v) == 0, f"{L} layers not divisible by pp·interleave={p}·{v}")
    enforce(b % microbatches == 0,
            f"batch {b} not divisible by microbatches={microbatches}")
    mb = b // microbatches
    enforce(mb % dshard == 0,
            f"microbatch size {mb} (batch {b} / microbatches {microbatches}) "
            f"must be divisible by the data-shard product {dshard} of axes "
            f"{axes_named}; lower microbatches or raise the batch")
    return mb


def _check_extras(x, extras):
    if extras is not None and _leaves(extras):
        enforce(all(e.shape[0] == x.shape[0] for e in _leaves(extras)),
                "extras leaves must share x's batch dim")
        return extras
    return None


def pipeline_local(x, stacked_params, layer_fn: Callable, pp: int,
                   microbatches: int = 4, extras=None, interleave: int = 1,
                   param_layout: str = "stacked", rng_key: Optional[int] = None):
    """The schedule of :func:`pipeline_apply` for ``pp`` ranks, run in this
    process on one device: every tick computes each rank's
    :func:`pp_tick` in turn, and a rotation of the list of the ranks'
    results stands for the exchange (rank r takes rank r-1's); the ranks'
    masked outputs are summed as the world's all-reduce sums them. ``x``
    ``[B, ...]``, the stacked params ``[L, ...]`` and the extras are whole
    tensors; returns the last rank's finished microbatches, ``[B, ...]``."""
    extras = _check_extras(x, extras)
    p, v = int(pp), max(1, int(interleave))
    L = _leaves(stacked_params)[0].shape[0]
    b = x.shape[0]
    mb = _check(L, b, p, v, microbatches, 1, (), param_layout)
    xm = x.reshape((microbatches, mb) + tuple(x.shape[1:]))
    exm = _tree_map(lambda e: e.reshape((microbatches, mb) + tuple(e.shape[1:])), extras)
    chunks = [_rank_chunks(stacked_params, r, p, v, param_layout) for r in range(p)]
    holding = [torch.zeros_like(xm[0]) for _ in range(p)]
    outputs = [[torch.zeros_like(xm[0]) for _ in range(microbatches)] for _ in range(p)]
    ticks = _schedule_ticks(microbatches, p, v)
    for t in range(ticks):
        done = []
        for r in range(p):
            out, j, rec = pp_tick(r, t, holding[r], xm, chunks[r], exm, layer_fn,
                                  p, microbatches, v, rng_key)
            outputs[r][j] = torch.where(_flag(rec, out), out, outputs[r][j])
            done.append(out)
        holding = [done[(r - 1) % p] for r in range(p)]
    # the last rank's microbatches, summed over the ranks as the world
    # driver's all-reduce sums them: every tick of every rank stays in the
    # graph, so the backward runs each one (bubble ticks with zero
    # cotangents), as each rank of a world does
    out = sum(torch.where(_flag(r == p - 1, o), o, torch.zeros_like(o))
              for r, o in enumerate(torch.stack(os_) for os_ in outputs))
    return out.reshape((b,) + tuple(out.shape[2:]))


# -- the per-rank region: collectives with the JAX function's gradients ---------

_region = threading.local()


@contextlib.contextmanager
def _in_region(mesh):
    old = getattr(_region, "mesh", None)
    _region.mesh = mesh
    try:
        yield
    finally:
        _region.mesh = old


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _Psum(torch.autograd.Function):
    """``lax.psum`` in a region run with the varying-axes check off: the
    cotangent is summed over the group too (its transpose there)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the cotangent times ``scale`` (the region's
    output cotangent over the axes the output is replicated on)."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _exchange(x: torch.Tensor, group, p: int, rank: int, step: int) -> torch.Tensor:
    """Send ``x`` to rank + ``step`` and receive from rank - ``step`` of the
    group (one ``batch_isend_irecv``)."""
    import torch.distributed as dist
    x = x.contiguous()
    out = torch.empty_like(x)
    to = dist.get_global_rank(group, (rank + step) % p)
    frm = dist.get_global_rank(group, (rank - step) % p)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, to, group),
                                   dist.P2POp(dist.irecv, out, frm, group)])
    for r in reqs:
        r.wait()
    return out


class _Ppermute(torch.autograd.Function):
    """``lax.ppermute`` to the next rank of the ring; its backward sends the
    cotangent back the other way."""

    @staticmethod
    def forward(ctx, x, group, p, rank):
        ctx.args = (group, p, rank)
        return _exchange(x, group, p, rank, 1)

    @staticmethod
    def backward(ctx, g):
        group, p, rank = ctx.args
        return _exchange(g, group, p, rank, -1), None, None, None


def psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """``jax.lax.psum(x, axis_name)`` on this rank's local tensor inside a
    :func:`pipeline_apply` region (a tp-parallel stage's partial sums); the
    cotangent is summed as well (module doc). An axis of size 1 is the
    identity."""
    mesh = getattr(_region, "mesh", None)
    enforce(mesh is not None,
            f"psum over {axis_name!r} outside a pipeline_apply region on a mesh")
    if mesh.shape.get(axis_name, 1) == 1:
        return x
    return _Psum.apply(x, mesh.group(axis_name))


def _region_local(t, mesh, spec, grad_partial_axes):
    """``t`` (a DTensor, or a whole tensor taken as replicated) as this
    rank's local tensor at ``spec``; its local grad a ``Partial`` sum over
    ``grad_partial_axes`` (size > 1), the spec's shards elsewhere."""
    from torch.distributed.tensor import Partial

    from ..ops._dtensor import local_at
    from .sharding import placements

    pl = placements(spec, mesh)
    grad = [Partial() if a in grad_partial_axes and mesh.shape[a] > 1 else q
            for a, q in zip(mesh.axis_names, pl)]
    return local_at(t, mesh, pl, grad)


def _spec_axes(spec) -> set:
    out = set()
    for e in spec:
        if e is not None:
            out.update(e if isinstance(e, tuple) else (e,))
    return out


def _unmentioned(mesh, spec) -> tuple:
    """The mesh axes larger than 1 that ``spec`` does not name."""
    named = _spec_axes(spec)
    return tuple(a for a in mesh.axis_names if a not in named and mesh.shape[a] > 1)


def _region_params(stacked, mesh, lead, param_specs):
    """Each stacked leaf as its local tensor at ``lead`` followed by its tp
    spec (``param_specs``' entry for its non-layer dims), the grad a
    ``Partial`` sum over the axes that spec does not name."""
    from .sharding import PartitionSpec

    def one(leaf, tail=()):
        spec = PartitionSpec(*lead, *tuple(tail))
        return _region_local(leaf, mesh, spec, _unmentioned(mesh, spec))
    if param_specs is None:
        return _tree_map(one, stacked)
    return _tree_map(one, stacked, param_specs)


def _batch_spec(mesh, batch_axes, ndim):
    from .sharding import PartitionSpec
    bspec = tuple(a for a in batch_axes if a in mesh.axis_names and mesh.shape[a] > 1)
    lead = bspec if len(bspec) > 1 else (bspec[0] if bspec else None)
    return bspec, PartitionSpec(lead, *([None] * (ndim - 1)))


def _data_fold(rng_key, mesh, bspec):
    if rng_key is None:
        return None
    from ..initializer import mix_seed
    for a in bspec:
        rng_key = mix_seed(rng_key, f"{a}{mesh.coord(a)}")
    return rng_key


def _seq(x, stacked, layer_fn, extras, rng_key):
    """The stack applied layer by layer, layer ``li`` under its own rng tag
    when ``rng_key`` is given (the JAX package's per-layer ``fold_in``)."""
    L = _leaves(stacked)[0].shape[0]
    for li in range(L):
        lp = _tree_map(lambda leaf: leaf[li], stacked)
        if rng_key is None:
            ctx = contextlib.nullcontext()
        else:
            from ..framework import rng_derived
            from ..initializer import mix_seed
            ctx = rng_derived(mix_seed(rng_key, li))
        with ctx:
            x = layer_fn(x, lp) if extras is None else layer_fn(x, lp, extras)
    return x


def _out_of_region(out, x, mesh, x_spec, was_dtensor):
    """The region's local output back as a DTensor of ``x_spec`` (its
    cotangent divided by the sizes of the axes it is replicated over), or
    as the whole tensor when the caller passed a plain one."""
    from ..ops._dtensor import wrap
    from .sharding import placements

    n = int(np.prod([mesh.shape[a] for a in _unmentioned(mesh, x_spec)] or [1]))
    if n > 1:
        out = _ScaleGrad.apply(out, 1.0 / n)
    d = wrap(out, mesh, placements(x_spec, mesh))
    return d if was_dtensor else d.full_tensor()


def pipeline_apply(x, stacked_params, layer_fn: Callable, mesh=None, axis_name: str = "pp",
                   microbatches: int = 4, batch_axes: Tuple[str, ...] = ("dp", "fsdp"),
                   param_specs=None, extras=None, interleave: int = 1,
                   param_layout: str = "stacked", rng_key: Optional[int] = None):
    """Run ``layer_fn`` over stacked layers, pipelined across ``axis_name``
    of ``mesh`` (pipeline.py:202).

    - x: activations [B, ...], B divisible by ``microbatches`` and each
      microbatch by the data-shard product of ``batch_axes``.
    - stacked_params: a tree of ``[L, ...]`` leaves, L divisible by
      pp·interleave.
    - layer_fn(activation, layer_params[, extra]) -> activation.
    - param_specs: partition specs of each leaf's non-layer dims (tensor
      parallelism inside a stage, e.g. ``{"w1": P(None, "tp")}``); the
      layer then sums its tp partials with :func:`psum`.
    - extras: a tree of [B, ...] side inputs (masks, an encoder's output),
      delivered per microbatch to the rank that works on it.
    - param_layout: "stacked" (logical row order) or "interleaved" (rows in
      :func:`interleave_perm` order, as ``Trainer.startup`` stores them).
    - rng_key: an int tag when the blocks draw dropout in training (module
      doc); None for deterministic blocks.

    With no mesh, no ``axis_name`` axis or one of size 1 the stack runs
    layer by layer: on the inputs as they are, or, with ``param_specs``, on
    each rank's local tp shards. ``x`` and the params may be DTensors of
    ``mesh`` (a plain tensor is taken as the same whole tensor on every
    rank); the result is a DTensor of the batch's placements, or a whole
    tensor when ``x`` was one. A :class:`LocalRanks` in place of the mesh
    runs :func:`pipeline_local`."""
    from ..ops._dtensor import is_dtensor

    extras = _check_extras(x, extras)
    if isinstance(mesh, LocalRanks):
        enforce(param_specs is None, "tensor parallelism needs a mesh of processes")
        if mesh.shape.get(axis_name, 1) > 1:
            return pipeline_local(x, stacked_params, layer_fn, mesh.shape[axis_name],
                                  microbatches, extras=extras, interleave=interleave,
                                  param_layout=param_layout, rng_key=rng_key)
        mesh = None
    if mesh is None or axis_name not in mesh.axis_names or mesh.shape[axis_name] == 1:
        enforce(param_layout == "stacked",
                "interleaved param storage requires a pp axis (size>1) in "
                "the mesh — the Trainer only permutes rows when one exists")
        if mesh is None or param_specs is None:
            return _seq(x, stacked_params, layer_fn, extras, rng_key)
        # a degenerate pipeline with tp-parallel stages: the layers sum their
        # tp partials, so they run on each rank's local shards
        bspec, x_spec = _batch_spec(mesh, batch_axes, x.dim())
        was = is_dtensor(x)
        xl = _region_local(x, mesh, x_spec, _unmentioned(mesh, x_spec))
        el = _tree_map(lambda e: _region_local(
            e, mesh, _batch_spec(mesh, batch_axes, e.dim())[1],
            _unmentioned(mesh, x_spec)), extras)
        pl = _region_params(stacked_params, mesh, (None,), param_specs)
        with _in_region(mesh):
            out = _seq(xl, pl, layer_fn, el, _data_fold(rng_key, mesh, bspec))
        return _out_of_region(out, x, mesh, x_spec, was)

    p = mesh.shape[axis_name]
    v = max(1, int(interleave))
    L = _leaves(stacked_params)[0].shape[0]
    b = x.shape[0]
    named = tuple(a for a in batch_axes if a in mesh.axis_names)
    dshard = int(np.prod([mesh.shape[a] for a in named] or [1]))
    _check(L, b, p, v, microbatches, dshard, named, param_layout)
    bspec, x_spec = _batch_spec(mesh, batch_axes, x.dim())
    was = is_dtensor(x)
    rank = mesh.coord(axis_name)
    xl = _region_local(x, mesh, x_spec, _unmentioned(mesh, x_spec))
    el = _tree_map(lambda e: _region_local(
        e, mesh, _batch_spec(mesh, batch_axes, e.dim())[1],
        _unmentioned(mesh, x_spec)), extras)
    if param_layout == "stacked" and v > 1:
        # logical rows: each rank gathers the stack over pp and takes its
        # chunks (the JAX function's per-step re-layout); the grad of the
        # gathered stack is this rank's rows, a Partial sum over pp
        whole = _region_params(stacked_params, mesh, (None,), param_specs)
        chunks = _rank_chunks(whole, rank, p, v, "stacked")
    else:
        local = _region_params(stacked_params, mesh, (axis_name,), param_specs)
        chunks = _tree_map(lambda leaf: leaf.reshape((v, leaf.shape[0] // v)
                                                     + tuple(leaf.shape[1:])), local)
    bl = xl.shape[0]
    enforce(bl % microbatches == 0,
            f"this rank's {bl} rows do not split into {microbatches} microbatches")
    xm = xl.reshape((microbatches, bl // microbatches) + tuple(xl.shape[1:]))
    exm = _tree_map(lambda e: e.reshape((microbatches, bl // microbatches)
                                        + tuple(e.shape[1:])), el)
    key = _data_fold(rng_key, mesh, bspec)
    group = mesh.group(axis_name)
    ticks = _schedule_ticks(microbatches, p, v)
    with _in_region(mesh):
        holding = torch.zeros_like(xm[0])
        outputs = [torch.zeros_like(xm[0]) for _ in range(microbatches)]
        for t in range(ticks):
            done, j, rec = pp_tick(rank, t, holding, xm, chunks, exm, layer_fn, p,
                                   microbatches, v, key)
            outputs[j] = torch.where(_flag(rec, done), done, outputs[j])
            if t + 1 < ticks:
                holding = _Ppermute.apply(done, group, p, rank)
        out = torch.stack(outputs)
        # the last rank's microbatches, summed over pp so every rank has them
        out = torch.where(_flag(rank == p - 1, out), out, torch.zeros_like(out))
        out = _Psum.apply(out, group)
    out = out.reshape((bl,) + tuple(out.shape[2:]))
    return _out_of_region(out, x, mesh, x_spec, was)


__all__ = ["LocalRanks", "bubble_fraction", "interleave_perm", "pipeline_apply",
           "pipeline_local",
           "pp_tick", "psum", "stack_layer_params", "tick_slot"]
