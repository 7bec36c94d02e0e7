"""Executor, Trainer and fit (counterpart of ``paddle_tpu.executor``).

The JAX package jit-compiles ``Program.apply`` (Executor.run) and
value_and_grad plus the optimizer update (Trainer.step) into one donated
program each. PyTorch runs eagerly, so here a run is the program's
forward under ``torch.no_grad``, and a step is the forward, ``backward()``
and the optimizer's pure update, whose results are copied into the
parameters in place (the analog of buffer donation). The grads of the
last step stay on the parameters (``param.grad``) until the next step.

``Trainer`` takes a ``Program`` built by :func:`framework.build` (every
model of the port, GPT's included: ``build(gpt.make_model(cfg))``); its
params and state live in ``trainer.scope`` under their JAX names. ``fit`` drives a
Trainer from a reader: DataFeeder → DeviceFeeder (the prefetch on the
card) or a plain put → ``step``, with the JAX package's events, interval
checkpoints (:class:`CheckpointConfig`), resume from the newest valid
checkpoint and a boundary checkpoint on SIGTERM/SIGINT. ``Inferencer``
runs a program from a checkpoint directory.

Mixed precision and non-finite steps, as in the JAX package:
``Trainer(strategy=DistStrategy(loss_scale=..., dynamic_loss_scale=...))``
scales the loss before the backward, unscales the grads and keeps the
step's old values when a grad is not finite (``out["loss_scale"]``);
``Trainer(guard=GuardPolicy(...))`` (or the ``check_nan_inf`` flag, read
at ``startup``) discards a step whose grads or float outputs are not
finite and records an :class:`~paddle_tpu_torch.resilience.Incident`.
Both compute one flag on the device and select the old values back on the
device (``LossScaler.select``), as the JAX package does, so a step never
waits on the card: the guard's host half examines the flag later
(``defer_readback``), and a captured step (which cannot read the host)
takes the same body.

A reduced optimizer state, as in the JAX package:
``DistStrategy(opt_state_dtype="bfloat16")`` stores the accumulators in
that dtype (``Optimizer.set_state_dtype``, set at ``startup``).

Rematerialization and gradient accumulation, as in the JAX package:
``DistStrategy(remat=True, remat_policy=...)`` runs the program's
training forward under ``framework.remat_mode`` (and without ``remat``
with remat off, whatever the ambient ``remat_mode``); ``DistStrategy(accum_steps=a)`` splits
every feed along dim 0 into ``a`` microbatches, runs forward and backward
on each (the program state threaded from one to the next), sums the
grads in f32, divides them by ``a`` and updates once, the fetched
outputs the microbatches' mean (executor.py:1008-1029).

K steps a dispatch, as the JAX package's ``lax.scan``:
``Trainer.run_steps(stacked_feed)`` runs K steps of the same body from a
``{name: (K, ...)}`` feed, on the card as one captured CUDA graph of the
step replayed K times (``_captured_step``), bit for bit the K ``step()``
calls it stands for; ``fit(steps_per_dispatch=K)`` feeds it K-batch
chunks (``DeviceFeeder(stack_k=K)``).

A mesh, as in the JAX package: ``Trainer(mesh=make_mesh(...),
sharding_rules=...)`` runs one process a device (``parallel.initialize``).
``startup`` places the scope as DTensors by the rule table
(``parallel.api.shard_scope``), each step takes the WHOLE batch on every
rank and keeps the rank's slice (``parallel.api.put_batch(...,
global_batch=True)``; a DTensor feed is used as given), and the step runs
on the DTensors: their propagation inserts the collectives of the
default ("gspmd") exchange, each param's grad coming back ``Partial`` and
reduced to its param's placements. ``DistStrategy(accum_exchange=
"hoisted")`` and ``quantized_allreduce="int8"|"int4"`` run the model on
each rank's local tensors instead and exchange the grads explicitly once
a step (one ``all_reduce``, or the block-scaled quantized ring with its
error-feedback residual); ``zero_sharding=True`` keeps params and
optimizer state as (N, k) rows (``parallel.zero``); and
``sequence_parallel=True`` enters ``framework.sp_mode`` around the
forward. ``pp_microbatches=M`` (with ``pp_interleave=V``) enters
``framework.pipeline_mode`` around it on a mesh with a ``pp`` axis, and
the stacked blocks run through ``parallel.pipeline.pipeline_apply``; with
V > 1 ``startup`` stores each pp-sharded stacked leaf's rows in the
interleaved rest order once, and checkpoints go through
:meth:`Trainer.stacked_to_logical` so they stay in logical layer order.
The fetched outputs come back as full tensors on every rank.

Not carried yet, each raising :class:`NotYetPorted` with the slice that
brings it: the ``DistStrategy`` fields of the
parameter server and the program dump, feed wire formats, on-device augmentation, the HBM
dataset cache and interval profile events; the journal and telemetry of
checkpoint saves, resizes and guard incidents come with the observability
slice.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from .amp import LossScaler
from .core.config import get_flag
from .core.errors import EnforceError, NotYetPorted, enforce
from .core.place import default_device
from .data.feeder import PipelineMetrics, host_feed_nbytes
from .framework import (Program, RngStream, build, check_params, params_from_jax,
                        pipeline_mode, remat_mode, resolve_remat_policy, sp_mode)
from .initializer import mix_seed
from .parallel.strategy import DistStrategy, unported_fields
from .resilience import GuardPolicy

Feed = Dict[str, Any]


class Scope:
    """Name→value runtime store (scope.h:41 analog). ``params`` are the
    program's parameters themselves, under their JAX names."""

    def __init__(self):
        self.params: Dict[str, torch.Tensor] = {}
        self.state: Dict[str, torch.Tensor] = {}
        self.opt_state: Optional[Dict[str, Any]] = None
        # {scale, good_steps, overflows} when the trainer runs a loss scaler
        self.loss_scale_state: Optional[Dict[str, torch.Tensor]] = None


def _floating(tree):
    if isinstance(tree, dict):
        tree = tree.values()
    elif isinstance(tree, torch.Tensor):
        tree = [tree]
    for v in tree:
        if isinstance(v, (dict, list, tuple)):
            yield from _floating(v)
        elif isinstance(v, torch.Tensor) and v.is_floating_point():
            yield v


def _check_nan_inf(tree, where: str):
    """FLAGS_check_nan_inf analog on the forward path (``Executor.run``):
    raise if a floating tensor of ``tree`` holds a NaN or an Inf. Reads one
    flag back from the device. ``Trainer`` routes the flag to the guard
    instead."""
    flags = [torch.isfinite(t).all() for t in _floating(tree)]
    if flags and not bool(torch.stack(flags).all()):
        raise FloatingPointError(f"NaN/Inf detected in {where} (FLAGS_check_nan_inf analog)")


def _loss_scaler(strategy) -> Optional[LossScaler]:
    """The loss scaler a ``DistStrategy`` asks for (executor.py:358-365),
    or None; a field of a later slice raises :class:`NotYetPorted`."""
    if strategy is None:
        return None
    enforce(isinstance(strategy, DistStrategy),
            f"Trainer(strategy={strategy!r}): expected a parallel.DistStrategy")
    later = unported_fields(strategy)
    if later:
        name = sorted(later)[0]
        raise NotYetPorted(f"DistStrategy.{name}={getattr(strategy, name)!r}: "
                           f"{later[name]}")
    if not (strategy.loss_scale or strategy.dynamic_loss_scale):
        return None
    return LossScaler(init_scale=strategy.loss_scale or 2.0 ** 15,
                      dynamic=strategy.dynamic_loss_scale,
                      growth_interval=strategy.loss_scale_growth_interval)


def _strategy_accum(strategy) -> int:
    """The microbatches a step runs: ``DistStrategy.accum_steps`` (1
    without a strategy)."""
    a = 1 if strategy is None else int(strategy.accum_steps)
    enforce(a >= 1, f"DistStrategy(accum_steps={a}): need >= 1")
    return a


def _mean_of(values: List[torch.Tensor]) -> torch.Tensor:
    """The mean over microbatches of one output (``jnp.mean(x, axis=0)``:
    an integer output's mean is f32)."""
    t = torch.stack(values)
    return t.mean(0) if t.is_floating_point() else t.float().mean(0)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor (a plain tensor is its own)."""
    return t._local_tensor if hasattr(t, "_local_tensor") else t


def _full(t):
    """A DTensor output as the full tensor every rank holds (a plain tensor
    as it is)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _leaf_pairs(dst, src, pairs):
    """(dst leaf, src leaf) of two trees of dicts, where src is another
    tensor; a key src has and dst lacks is added to dst."""
    for k, v in src.items():
        d = dst.get(k)
        if isinstance(v, dict):
            if d is None:
                d = dst[k] = {}
            _leaf_pairs(d, v, pairs)
        elif d is None:
            dst[k] = v
        elif v is not d:
            pairs.append((d, v))
    return pairs


def write_in_place(dst, src) -> None:
    """Copy the leaves of ``src`` into the tensors of ``dst`` (trees of
    dicts of the same shape): the training state keeps its tensors, which
    a captured step reads and writes at fixed addresses. One multi-tensor
    copy per dtype."""
    groups: Dict[Any, List] = {}
    for d, v in _leaf_pairs(dst, src, []):
        if hasattr(d, "to_local"):
            # a mesh's DTensors: the copy is of this rank's shards, at the
            # destination's placements
            if hasattr(v, "to_local"):
                if tuple(v.placements) != tuple(d.placements):
                    v = v.redistribute(placements=d.placements)
                v = v._local_tensor
            d = d._local_tensor
        groups.setdefault((d.dtype, v.dtype), []).append((d, v))
    with torch.no_grad():
        for pairs in groups.values():
            torch._foreach_copy_([d for d, _ in pairs], [v for _, v in pairs])


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = _full(tree.detach()).cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree


def _put(value, device: torch.device) -> torch.Tensor:
    if isinstance(value, np.ndarray):
        if value.dtype.name == "bfloat16":  # ml_dtypes: through its 16-bit pattern
            return params_from_jax({"v": value}, device=device)["v"]
        value = torch.from_numpy(np.ascontiguousarray(value))
    return torch.as_tensor(value).to(device, non_blocking=True)


def _microbatch_major(v, a: int, n: int, stacked: bool):
    """A whole batch reordered so that each of ``n`` equal contiguous rank
    slices holds, microbatch after microbatch, its share of each of the
    ``a`` microbatches (microbatch ``i`` = rows ``[i·b/a, (i+1)·b/a)``)."""
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
    d = 1 if stacked else 0
    b = t.shape[d]
    enforce(b % (a * n) == 0, f"DistStrategy(accum_steps={a}) on {n} data ranks: a batch "
            f"of {b} does not split into {a} microbatches of {n} equal rank slices")
    head, tail = tuple(t.shape[:d]), tuple(t.shape[d + 1:])
    t = t.reshape(head + (a, n, b // (a * n)) + tail).transpose(d, d + 1)
    return t.reshape(head + (b,) + tail)


def _reduced_grad(p: torch.Tensor) -> torch.Tensor:
    """``p.grad``; for a DTensor param, reduced to the param's placements
    (a grad comes back ``Partial`` over the axes its inputs were sharded
    on: this is the default exchange's all-reduce or reduce-scatter)."""
    g = p.grad
    if hasattr(g, "redistribute") and tuple(g.placements) != tuple(p.placements):
        g = g.redistribute(placements=p.placements)
    return g


def _allreduce_mean(grads: Dict[str, torch.Tensor], group, n: int) -> Dict[str, torch.Tensor]:
    """The grads' mean over ``group``: one ``all_reduce`` of all of them
    packed in one f32 buffer a dtype."""
    import torch.distributed as dist

    out = {}
    by_dtype: Dict[Any, List[str]] = {}
    for k, g in grads.items():
        by_dtype.setdefault(g.dtype, []).append(k)
    for dtype, keys in by_dtype.items():
        flat = torch.cat([grads[k].reshape(-1) for k in keys])
        dist.all_reduce(flat, group=group)
        flat = flat / n
        off = 0
        for k in keys:
            m = grads[k].numel()
            out[k] = flat[off:off + m].view(grads[k].shape)
            off += m
    return out


def _micro_slice(v: torch.Tensor, i: int, a: int) -> torch.Tensor:
    """Microbatch ``i`` of ``a`` of a feed: rows ``[i·b/a, (i+1)·b/a)`` of
    a plain tensor, or of each rank's local rows of a DTensor (whose rows
    :func:`_microbatch_major` ordered), as a DTensor of the same
    placements."""
    if hasattr(v, "to_local"):
        from torch.distributed.tensor import DTensor
        loc = v.to_local()
        m = loc.shape[0] // a
        return DTensor.from_local(loc[i * m:(i + 1) * m], v.device_mesh, v.placements,
                                  run_check=False)
    m = v.shape[0] // a
    return v[i * m:(i + 1) * m]


@contextlib.contextmanager
def _sp_consumed(mesh, impl: str):
    """``sp_mode`` around a training forward, warning when the model never
    read it (executor.py:392): its attention then is not sequence
    parallel."""
    with sp_mode(mesh, impl=impl) as cfg:
        yield cfg
    if not cfg["consumed"]:
        import warnings
        warnings.warn("DistStrategy.sequence_parallel is set but the model never consumed "
                      "the context — attention is NOT sequence-parallel. Use an sp-aware "
                      "model (models/gpt.py).")


class Executor:
    """Forward/eval executor with a held scope (executor.py:256 analog).

    ``place`` is where it runs: the CUDA card unless the caller passes
    ``CPUPlace()`` (no card: :class:`NoCudaDevice`)."""

    def __init__(self, place=None):
        self.device = default_device(place, "Executor")
        self.place = self.device
        self.scope = Scope()

    def startup(self, program: Program, rng: Optional[int] = None, *example_args,
                **example_kwargs) -> Scope:
        """Run the startup program on the example inputs (on this
        executor's device): initialise params and state into the scope.
        ``rng`` is an int seed; None takes the ``seed`` flag."""
        args = [_put(a, self.device) for a in example_args]
        kwargs = {k: _put(v, self.device) for k, v in example_kwargs.items()}
        params, state = program.init(rng, *args, place=self.device, **kwargs)
        self.scope.params, self.scope.state = params, state
        return self.scope

    def run(self, program: Program, feed: Optional[Feed] = None,
            fetch_list: Optional[Sequence[str]] = None, scope: Optional[Scope] = None,
            return_numpy: bool = True, training: bool = False, rng: Optional[int] = None,
            update_state: bool = False):
        """Run a program forward (Executor.run analog, executor.py:374).

        ``feed`` maps the program function's argument names to arrays;
        ``fetch_list`` selects keys of its dict output (None returns the
        whole output)."""
        scope = scope or self.scope
        feed = {k: _put(v, self.device) for k, v in (feed or {}).items()}
        with torch.no_grad(), record_function(f"exe.run/{program.name}"):
            out, new_state = program.apply(scope.params, scope.state, training=training,
                                           rng=rng, place=self.device, **feed)
        if get_flag("check_nan_inf"):
            _check_nan_inf(out, f"outputs of {program.name}")
        if update_state:
            scope.state = new_state
        if fetch_list is None:
            return _to_numpy(out) if return_numpy else out
        enforce(isinstance(out, dict),
                "fetch_list requires the program to return a dict of named outputs")
        vals = [out[name] for name in fetch_list]
        return [_to_numpy(v) for v in vals] if return_numpy else vals


class Trainer:
    """Eager train loop: forward, backward and the optimizer update per
    :meth:`step`, on one device or, with ``mesh``, on every rank of a mesh.

    ``program`` is a :class:`framework.Program` (anything else raises
    :class:`EnforceError`). ``place`` (the JAX package's argument) or
    ``device`` is where it runs: the CUDA card unless the caller passes
    the CPU (no card: :class:`NoCudaDevice`); under a ``mesh``
    (:class:`parallel.Mesh`) it is this rank's device of the mesh.
    ``sharding_rules`` (:class:`parallel.ShardingRules`, default
    ``replicated()``) places the params on the mesh. ``fetch_list`` prunes
    what ``step`` returns to those outputs and the loss."""

    def __init__(self, program, optimizer, loss_name: str = "loss", place=None,
                 mesh=None, sharding_rules=None, strategy=None,
                 fetch_list: Optional[Sequence[str]] = None, guard=None, feed_wire=None,
                 augment=None, device=None):
        from .parallel.mesh import Mesh
        from .parallel.sharding import ShardingRules

        unported = {"feed_wire": feed_wire, "augment": augment}
        for name, value in unported.items():
            if value is not None:
                raise NotYetPorted(f"Trainer({name}=...): a later slice "
                                   "(ROADMAP queue 1)")
        enforce(guard is None or isinstance(guard, (bool, GuardPolicy)),
                f"Trainer(guard={guard!r}): expected True, False, None or a GuardPolicy")
        enforce(mesh is None or isinstance(mesh, Mesh),
                f"Trainer(mesh={mesh!r}): expected a parallel.Mesh (parallel.make_mesh)")
        enforce(sharding_rules is None or isinstance(sharding_rules, ShardingRules),
                f"Trainer(sharding_rules={sharding_rules!r}): expected a "
                "parallel.ShardingRules")
        if place is not None and device is not None:
            enforce(torch.device(place) == torch.device(device),
                    f"Trainer(place={place}, device={device}): two devices")
        if not isinstance(program, Program):
            raise EnforceError(f"Trainer(program={type(program).__name__}): expected a "
                               "framework.Program, e.g. build(gpt.make_model(cfg))")
        asked = device if device is not None else place
        if mesh is not None:
            # the mesh's device, checked to exist: a CUDA mesh with no card
            # raises here, never runs on the CPU
            enforce(asked is None or torch.device(asked).type == mesh.device.type,
                    f"Trainer(place={asked}, mesh on {mesh.device}): the mesh's ranks "
                    "run on their own devices")
            asked = mesh.device
        self.device = default_device(asked, "Trainer")
        self.place = self.device
        self.mesh = mesh
        self.sharding_rules_raw = sharding_rules
        self.sharding_rules = (sharding_rules.adapted_to(mesh)
                               if sharding_rules is not None and mesh is not None
                               else sharding_rules)
        # set at startup: the exchange ("gspmd", "local" or None off-mesh),
        # its data axes, the quantized wire's settings, the ZeRO layout
        self._exchange: Optional[str] = None
        self._exchange_axes: tuple = ()
        self._logical_shapes: Dict[str, tuple] = {}
        self._quant: Optional[Dict[str, Any]] = None
        self._zero = None
        self.collective_bytes: Optional[Dict[str, Any]] = None
        self.program = program
        self.optimizer = optimizer
        self.loss_name = loss_name
        self.fetch_list = list(fetch_list) if fetch_list is not None else None
        self.strategy = strategy
        self.loss_scaler = _loss_scaler(strategy)
        _strategy_accum(strategy)
        if mesh is None and strategy is not None:
            # the exchange knobs act on a mesh's ranks: without one they
            # would do nothing, so they raise (executor.py:456)
            for name, off in (("accum_exchange", "gspmd"), ("quantized_allreduce", "none"),
                              ("zero_sharding", False)):
                value = getattr(strategy, name)
                enforce(value in (off, None), f"DistStrategy.{name}={value!r} needs a mesh "
                        "(it is the cross-shard exchange policy): pass Trainer(mesh=...)")
        if strategy is not None:
            resolve_remat_policy(strategy.remat_policy)  # an unknown name raises here
        # the NaN/Inf guard: True is the default policy; None defers to the
        # check_nan_inf flag, read at startup; False opts out, flag or not
        self.guard_policy = GuardPolicy() if guard is True else (guard or None)
        self._guard_opt_out = guard is False
        self._guard: Optional[GuardPolicy] = None  # resolved at startup
        self._guard_bit_names: tuple = ()          # bit i of the mask -> value name
        self._guard_pending = None                 # (mask, feed, step) not read yet
        self._nan_flag_warned = False
        self.guard_incidents: List[Any] = []
        self.guard_incident_total = 0
        self.scope = Scope()
        self.global_step = 0
        # the meta of the checkpoint io.load_trainer last restored
        self._last_loaded_meta: Optional[Dict[str, Any]] = None
        # the stream the eager steps draw from (seeded before each step)
        self._rng = RngStream(self.device)
        # run_steps' captured step (_captured_step.FusedSteps), made on its
        # first dispatch and dropped when the training state is replaced
        self._fused = None
        self.pipeline_metrics = PipelineMetrics()
        # the interleaved pipeline's row permutation of each stacked leaf
        self._pp_perm: Dict[str, np.ndarray] = {}

    # ------------------------------------------------------------------
    def startup(self, rng: Optional[int] = None, sample_feed: Optional[Feed] = None,
                params: Optional[Dict[str, Any]] = None):
        """Initialise the params and build the optimizer state.

        The program runs its init on zeros of ``sample_feed``'s shapes
        and dtypes on this trainer's device. ``params`` ({JAX name:
        tensor}, e.g. from ``params_from_jax``)
        replaces the initial values; they are copied, so training never
        writes to the caller's tensors. ``rng`` is an int seed; None takes
        the ``seed`` flag."""
        seed = get_flag("seed") if rng is None else int(rng)
        example = {k: torch.zeros_like(_put(v, "cpu"), device=self.device)
                   for k, v in (sample_feed or {}).items()}
        fresh, state = self.program.init(seed, place=self.device, **example)
        if params is not None:
            check_params(params, self.program.param_info, "Trainer.startup(params=)")
            fresh = {k: params[k].detach().to(self.device, copy=True) for k in fresh}
        fresh = self._interleave_stacked_params(fresh)
        sd = None if self.strategy is None else self.strategy.opt_state_dtype
        if sd is not None:  # before init, as the JAX Trainer (executor.py:400-402)
            self.optimizer.set_state_dtype(sd)
        with torch.no_grad():
            opt_state = self.optimizer.init({k: p.detach() for k, p in fresh.items()})
        ls = (self.loss_scaler.init_state(self.device)
              if self.loss_scaler is not None else None)
        self.scope.quant_resid = None
        if self.mesh is not None:
            fresh, state, opt_state, ls = self._place_on_mesh(fresh, state, opt_state, ls)
        for p in fresh.values():
            p.requires_grad_(p.is_floating_point())
        self.scope.params, self.scope.state = fresh, state
        self.scope.opt_state = opt_state
        self.scope.loss_scale_state = ls
        # the check_nan_inf flag is read here, as the JAX package reads it
        # when it builds the step (executor.py:948-957): the legacy flag
        # aborts at the step at fault
        guard = self.guard_policy
        if guard is None and not self._guard_opt_out and get_flag("check_nan_inf"):
            guard = GuardPolicy(max_incidents=0, window=1, record_feed_digest=False,
                                defer_readback=False)
        self._guard = guard
        self._guard_pending = None
        self.global_step = 0
        self._fused = None
        self.pipeline_metrics.reset()
        return self

    # -- the pipeline's rest layout (executor.py:477-556) ------------------------
    def _pp_settings(self):
        """(``pp_microbatches``, ``pp_interleave`` at least 1)."""
        s = self.strategy
        pp_m = 0 if s is None else int(s.pp_microbatches)
        pp_v = 1 if s is None else int(s.pp_interleave)
        return pp_m, max(1, pp_v)

    def _interleave_stacked_params(self, params):
        """The interleaved pipeline's rest layout: each pp-sharded stacked
        leaf's rows permuted ONCE, at startup, into the rank-major chunk
        order (``parallel.pipeline.interleave_perm``), so a rank's chunks
        are its own shard and a step needs no re-layout. Checkpoints stay
        in logical order (:meth:`stacked_to_logical`)."""
        self._pp_perm = {}
        pp_m, pp_v = self._pp_settings()
        if (pp_m <= 0 or pp_v <= 1 or self.mesh is None
                or self.mesh.shape.get("pp", 1) <= 1 or self.sharding_rules is None):
            return params
        from .parallel.pipeline import interleave_perm
        p = self.mesh.shape["pp"]
        out = dict(params)
        for name, leaf in params.items():
            spec = self.sharding_rules.spec_for(name, tuple(leaf.shape), self.mesh)
            lead = spec[0] if len(spec) > 0 else None
            if not (lead == "pp" or (isinstance(lead, tuple) and "pp" in lead)):
                continue
            if leaf.dim() < 1 or leaf.shape[0] % (p * pp_v) != 0:
                continue
            perm = interleave_perm(leaf.shape[0], p, pp_v)
            out[name] = leaf[torch.as_tensor(perm, device=leaf.device)]
            self._pp_perm[name] = perm
        return out

    def _apply_row_perm(self, params, opt_state, index_of):
        """Each permuted leaf's rows (and every per-param optimizer subtree
        under that param's name, at any depth: the arrays whose leading dim
        is the permutation's length) taken by ``index_of(perm)``. Never
        changes its inputs."""
        perms = self._pp_perm
        if not perms:
            return params, opt_state

        def rows(t, perm):
            return t[torch.as_tensor(index_of(perm), device=t.device)]

        params = dict(params)
        for name, perm in perms.items():
            if name in params:
                params[name] = rows(params[name], perm)

        def permute(sub, perm):
            if isinstance(sub, dict):
                return {k: permute(v, perm) for k, v in sub.items()}
            if isinstance(sub, torch.Tensor) and sub.dim() >= 1 and sub.shape[0] == len(perm):
                return rows(sub, perm)
            return sub

        def walk(tree):
            if not isinstance(tree, dict):
                return tree
            return {k: (permute(v, perms[k]) if k in perms else walk(v))
                    for k, v in tree.items()}

        return params, (walk(opt_state) if opt_state is not None else None)

    def stacked_to_logical(self, params, opt_state=None):
        """Undo the interleaved rest layout (checkpoint order), on whole
        tensors."""
        return self._apply_row_perm(params, opt_state, lambda perm: np.argsort(perm))

    def stacked_from_logical(self, params, opt_state=None):
        """Apply the interleaved rest layout to logical-order whole tensors
        (a checkpoint restored into an interleaved trainer)."""
        return self._apply_row_perm(params, opt_state, lambda perm: perm)

    @contextlib.contextmanager
    def _pp_scope(self):
        """``framework.pipeline_mode`` as the strategy asks for it
        (executor.py:603-625): warned and skipped when the mesh has no
        ``pp`` axis larger than 1, and warned when the model never
        consumed it."""
        import warnings

        pp_m, pp_v = self._pp_settings()
        if pp_m <= 0:
            yield None
            return
        if self.mesh is None or self.mesh.shape.get("pp", 1) <= 1:
            warnings.warn(f"DistStrategy.pp_microbatches={pp_m} is set but the mesh "
                          f"{None if self.mesh is None else self.mesh.shape} has no 'pp' "
                          "axis (size>1); training proceeds WITHOUT it")
            yield None
            return
        layout = "interleaved" if self._pp_perm else "stacked"
        with pipeline_mode(self.mesh, pp_m, interleave=pp_v, param_layout=layout) as cfg:
            yield cfg
        if not cfg["consumed"]:
            warnings.warn("DistStrategy.pp_microbatches is set but the model never consumed "
                          "the context — no stacked block stack routed through the "
                          "pipeline; every pp rank redundantly computes the full model. "
                          "Build the model with its stacked representation (e.g. "
                          "TransformerConfig(stacked=True)).")

    # -- the mesh (executor.py:404-463, :638-730) ------------------------------
    def _place_on_mesh(self, params, state, opt_state, ls):
        """Resolve the exchange and place the scope on the mesh: ZeRO rows,
        or DTensors by the rule table; the loss-scale state replicated, and
        the quantized exchange's error-feedback residual (one f32 slot per
        data-parallel rank per param, ``(dshard,) + shape`` sharded on its
        leading axis, zeros at startup and not checkpointed)."""
        from .parallel import api as par_api
        from .parallel import zero as zero_mod

        s = self.strategy
        self._logical_shapes = {k: tuple(v.shape) for k, v in params.items()}
        mode = "gspmd" if s is None else s.accum_exchange
        enforce(mode in ("gspmd", "hoisted"),
                f"DistStrategy.accum_exchange={mode!r} (gspmd|hoisted)")
        a = _strategy_accum(s)
        enforce(mode == "gspmd" or a > 1,
                "accum_exchange='hoisted' without accum_steps>1 is a misconfiguration "
                "(there is no loop to hoist out of)")
        qmode = "none" if s is None else (s.quantized_allreduce or "none")
        enforce(qmode in ("none", "int8", "int4"),
                f"DistStrategy.quantized_allreduce={qmode!r} (none|int8|int4)")
        if s is not None:
            enforce(s.reduce_strategy in ("allreduce", "sharded"),
                    f"DistStrategy.reduce_strategy={s.reduce_strategy!r} (allreduce|sharded)")
            enforce(s.sp_impl in ("ring", "ulysses"),
                    f"DistStrategy.sp_impl={s.sp_impl!r} (ring|ulysses)")
        self._quant = None
        self._exchange, self._exchange_axes = "gspmd", ()
        if qmode != "none":
            from .parallel import quantized_collectives as qc
            bits = 8 if qmode == "int8" else 4
            block = int(s.quant_block_size)
            qc.wire_block_bytes(1, bits=bits, block_size=block)  # validates
            self._quant = {"bits": bits, "block_size": block,
                           "error_feedback": bool(s.error_feedback),
                           "stochastic_rounding": bool(s.quant_stochastic_rounding)}
            self._exchange_axes = self._local_exchange_axes(
                f"quantized_allreduce={qmode!r}", params, state)
            self._exchange = "local"
        elif mode == "hoisted":
            self._exchange_axes = self._local_exchange_axes(
                "accum_exchange='hoisted'", params, state)
            self._exchange = "local"
        self._zero = None
        if s is not None and s.zero_sharding:
            zaxes = self._local_exchange_axes("zero_sharding=True", params, state)
            self._zero = zero_mod.make_spec(self.mesh, zaxes, params, state, opt_state)
        params, state, opt_state = self._mesh_placement(params, state, opt_state)
        if ls is not None:
            ls = {k: par_api.replicate(self.mesh, v) for k, v in ls.items()}
        if self._quant is not None and self._quant["error_feedback"]:
            from torch.distributed.tensor import DTensor, Replicate, Shard
            axes = self._exchange_axes
            pl = [Shard(0) if a in axes else Replicate() for a in self.mesh.axis_names]
            self.scope.quant_resid = {
                k: DTensor.from_local(torch.zeros((1,) + shape, dtype=torch.float32,
                                                  device=self.device),
                                      self.mesh.device_mesh, pl, run_check=False)
                for k, shape in self._logical_shapes.items()}
        self.collective_bytes = self._collective_bytes_summary()
        return params, state, opt_state, ls

    def _mesh_placement(self, params, state, opt_state):
        """Full logical trees (the same on every rank) placed on the mesh:
        ZeRO rows when ``zero_sharding`` is on, else by the rule table. A
        checkpoint restore places what it loaded the same way."""
        from .parallel import api as par_api
        from .parallel import zero as zero_mod

        if self._zero is not None:
            return (zero_mod.partition_params(params, self._zero, self.mesh),
                    {k: par_api.replicate(self.mesh, v) for k, v in state.items()},
                    zero_mod.partition_opt_state(opt_state, self._zero, self.mesh))
        return par_api.shard_scope(self.mesh, self.sharding_rules, params, state, opt_state)

    def _local_exchange_axes(self, why: str, params, state) -> tuple:
        """The data axes of a rank-local gradient path (the hoisted
        exchange, the quantized ring, ZeRO), each precondition enforced
        (executor.py:649): a mesh with a data axis, no sequence
        parallelism, no program state, every param replicated."""
        axes = tuple(a for a in ("dp", "fsdp") if a in self.mesh.axis_names
                     and self.mesh.shape[a] > 1)
        if not axes:
            # a world of one: its data axes of size 1 (one shard, N = 1),
            # which the JAX package, whose meshes span a host's devices,
            # has no use for
            axes = tuple(a for a in ("dp", "fsdp") if a in self.mesh.axis_names)
        enforce(axes, f"{why}: mesh has no data axis")
        enforce(not (self.strategy is not None and (self.strategy.sequence_parallel
                                                    or self._pp_settings()[0] > 0)),
                f"{why} composes only with pure data parallelism (no pp/sp: their "
                "schedules cannot nest inside the local gradient path)")
        enforce(not state, f"{why} requires stateless models: per-shard mutable "
                "state (e.g. BN running stats) would silently diverge across shards")
        if self.sharding_rules is not None:
            for name, leaf in params.items():
                spec = self.sharding_rules.spec_for(name, tuple(leaf.shape), self.mesh)
                enforce(all(e is None for e in spec),
                        f"{why} requires fully replicated params; {name} is sharded "
                        f"{spec} (use fsdp/tp with the default gspmd exchange instead)")
        return axes

    def _collective_bytes_summary(self) -> Optional[Dict[str, Any]]:
        """Bytes-on-wire of one optimizer step's gradient exchange
        (executor.py:682): one rank's ring all-reduce bytes summed over the
        grads and data axes, f32 against the configured wire; with ZeRO,
        the top-of-step all-gather too. None when the mesh has no data
        axis larger than 1."""
        from .parallel import quantized_collectives as qc

        axes = self._exchange_axes or tuple(
            a for a in ("dp", "fsdp") if a in self.mesh.axis_names and self.mesh.shape[a] > 1)
        if not axes:
            return None
        zero, quant = self._zero, self._quant
        sizes = [int(np.prod(sh)) if sh else 1 for sh in self._logical_shapes.values()]
        ranks = {a: int(self.mesh.shape[a]) for a in axes}
        fp32 = sum(qc.ring_wire_bytes(n, p) for n in sizes for p in ranks.values())
        wire = fp32 if quant is None else sum(
            qc.ring_wire_bytes(n, p, bits=quant["bits"], block_size=quant["block_size"])
            for n in sizes for p in ranks.values())
        out = {"mode": "none" if quant is None else f"int{quant['bits']}",
               "bits": None if quant is None else quant["bits"],
               "block_size": None if quant is None else quant["block_size"],
               "error_feedback": bool(quant and quant["error_feedback"]),
               "axes": axes, "ranks": ranks, "grad_elems": int(sum(sizes)),
               "fp32_bytes_per_step": int(fp32), "wire_bytes_per_step": int(wire),
               "reduction": (float(fp32) / wire) if wire else 1.0}
        if zero is not None:
            from .parallel import zero as zero_mod
            out["zero"] = {"shards": zero.n, "axes": zero.axes,
                           "allgather_bytes_per_step": zero_mod.allgather_bytes_per_step(zero)}
        return out

    def _logical_params(self) -> Dict[str, torch.Tensor]:
        """The params at their logical shapes: the ZeRO rows gathered
        (collective: every rank calls it), else ``scope.params``."""
        if self._zero is None:
            return self.scope.params
        from .parallel import zero as zero_mod
        with torch.no_grad():
            return zero_mod.combine_params(self.scope.params, self._zero, self.mesh)

    def _mesh_scope(self):
        """Plain tensors a step makes (masks, positions, the loss-scale
        arithmetic's constants) take part as replicated DTensors."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import implicit_replication
        return implicit_replication()

    def _sp_scope(self):
        """``framework.sp_mode`` as the strategy asks for it
        (``sequence_parallel``, ``sp_impl``), warning when the mesh has
        no ``sp`` axis larger than 1 (executor.py:375)."""
        s = self.strategy
        if s is None or not s.sequence_parallel:
            return contextlib.nullcontext()
        if self.mesh is None or self.mesh.shape.get("sp", 1) <= 1:
            import warnings
            warnings.warn(f"DistStrategy.sequence_parallel is set but the mesh "
                          f"{None if self.mesh is None else self.mesh.shape} has no 'sp' "
                          "axis (size>1); training proceeds WITHOUT it")
            return contextlib.nullcontext()
        return _sp_consumed(self.mesh, s.sp_impl)

    def _put_feed(self, feed: Feed, stacked: bool = False) -> Feed:
        """The feed's values as tensors on this trainer's device (a
        ``(K, ...)`` super-batch as one tensor a name); its host bytes and
        the put's submission time go to ``pipeline_metrics``. Under a mesh
        the feed is the whole batch on every rank, and each value becomes a
        DTensor holding this rank's slice (``parallel.api.put_batch``); a
        step that accumulates microbatches through the default exchange
        takes its slice of each microbatch, so that microbatch ``i`` is
        the batch's rows ``[i·b/a, (i+1)·b/a)`` as on one device."""
        nbytes = host_feed_nbytes(feed)
        t0 = time.perf_counter()
        if self.mesh is None:
            out = {k: _put(v, self.device) for k, v in feed.items()}
        else:
            from .parallel import api as par_api
            a = _strategy_accum(self.strategy)
            if a > 1 and self._exchange == "gspmd":
                from .parallel.mesh import data_parallel_size
                n = data_parallel_size(self.mesh)
                feed = {k: _microbatch_major(v, a, n, stacked) for k, v in feed.items()}
            out = par_api.put_batch(self.mesh, self.sharding_rules, feed, stacked=stacked,
                                    global_batch=True)
        if nbytes:
            self.pipeline_metrics.record_h2d(nbytes, time.perf_counter() - t0)
        return out

    def pipeline_report(self) -> Dict[str, Any]:
        """The input pipeline's stage attribution since ``startup`` (or
        ``pipeline_metrics.reset()``): seconds per stage, bytes, the
        link estimate and the bottleneck (:meth:`PipelineMetrics.report`).
        Fed by ``fit``'s ``DeviceFeeder`` and by ``_put_feed`` on direct
        ``step``/``run_steps`` calls."""
        return self.pipeline_metrics.report()

    def _step_seed(self, rng: Optional[int], step: int, fused: bool = False) -> int:
        """The seed step ``step`` draws from: the JAX package's
        ``fold_in(key(seed + 1), global_step)`` (executor.py:1310) as
        ``mix_seed(seed + 1, step)``; a ``step(rng=r)`` draws from ``r``
        itself, a ``run_steps(rng=r)`` from ``mix_seed(r, step)``
        (executor.py:1193)."""
        if rng is None:
            seed = mix_seed(get_flag("seed") + 1, step)
        else:
            seed = mix_seed(int(rng), step) if fused else int(rng)
        if self._exchange == "local":
            # each rank's masks differ, as the JAX package folds the shard
            # index into the key (executor.py:625)
            for a in self._exchange_axes:
                seed = mix_seed(seed, f"{a}{self.mesh.coord(a)}")
        return seed

    def _run(self, feed: Feed, training: bool, rng=None, state=None, params=None):
        """(outputs as a dict, new state) of one run of the program from
        ``params`` and ``state`` (None: the scope's); ``rng`` is an int seed
        or an ``RngStream``."""
        out, new_state = self.program.apply(self.scope.params if params is None else params,
                                            self.scope.state if state is None else state,
                                            training=training, rng=rng,
                                            place=self.device, **feed)
        if not isinstance(out, dict):
            out = {self.loss_name: out}
        return out, new_state

    def _fetch(self, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        keys = list(out) if self.fetch_list is None else \
            list(dict.fromkeys(self.fetch_list + [self.loss_name]))
        return {k: out[k].detach() for k in keys}

    def step(self, feed: Feed, rng: Optional[int] = None,
             span: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """One optimization step; returns the fetched outputs, computed
        before the update, with ``loss_scale`` (the scale after this step)
        under a loss scaler and ``guard_nonfinite`` (the bitmask) under the
        guard.

        A non-finite grad under a loss scaler, or a non-finite checked
        value under the guard, keeps the params, the optimizer state (its
        step too) and the program state at their values from before the
        step, selected back on the device; ``global_step`` still advances.
        The step reads nothing back from the card.

        ``rng`` (an int seed) replaces the step's derived seed
        ``mix_seed(seed + 1, global_step)``; the program's random ops
        (dropout) draw from a stream seeded with it
        (:class:`framework.RngStream`). ``span`` names the feeder batch of
        a journal event in the JAX package; it is taken and unused until
        the observability slice (ROADMAP queue 1, item 24)."""
        enforce(self.scope.opt_state is not None, "call startup() before step()")
        feed = self._put_feed(feed)
        out = self._step_body(feed, self._rng.reset(self._step_seed(rng, self.global_step)))
        self.global_step += 1
        self._after_dispatch(out, feed, 1)
        return out

    def _after_dispatch(self, out: Dict[str, torch.Tensor], feed: Feed, k: int) -> None:
        """The host's half of a dispatch of ``k`` steps that ended at
        ``global_step``: the ``benchmark`` flag's wait, and the guard's
        masks parked (or examined)."""
        if get_flag("benchmark") and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self._guard is not None:
            self._guard_enqueue(out["guard_nonfinite"], feed, self.global_step - k, k)
        else:
            self._warn_inert_nan_flag()

    def _state_trees(self) -> Dict[str, Any]:
        """The training state a step reads and writes in place: params,
        optimizer state, program state, loss-scale state and the quantized
        exchange's residual."""
        return {"params": self.scope.params, "opt": self.scope.opt_state,
                "state": self.scope.state, "ls": self.scope.loss_scale_state or {},
                "resid": getattr(self.scope, "quant_resid", None) or {}}

    def _remat_scope(self):
        """``remat_mode`` as the strategy sets it for a training run, in
        place of any ambient one (executor.py:615): ``remat`` switches it
        on, ``remat_policy`` chooses what a block keeps."""
        s = self.strategy
        return remat_mode(bool(s is not None and s.remat),
                          policy=None if s is None else s.remat_policy)

    def _forward_backward(self, feed: Feed, stream: RngStream, state, params=None, ls=None):
        """One training run of the program from ``params`` (None: the
        scope's) and ``state`` and its backward, the loss scaled under a
        loss scaler (by ``ls``, None: the scope's state): (fetched outputs,
        new state); the grads are left on the params."""
        scaler = self.loss_scaler
        ls = self.scope.loss_scale_state if ls is None else ls
        # profiler ranges (``trainer.forward`` ...): a profiled step splits
        # its device time by them; about a microsecond each when no
        # profiler runs
        with record_function("trainer.forward"), self._remat_scope(), self._sp_scope(), \
                self._pp_scope():
            out, new_state = self._run(feed, training=True, rng=stream, state=state,
                                       params=params)
        with record_function("trainer.backward"):
            loss = out[self.loss_name]
            (loss if scaler is None else scaler.scale_loss(loss, ls)).backward()
        return self._fetch(out), new_state

    def _accumulate(self, feed: Feed, stream: RngStream, a: int, params=None, ls=None,
                    state=None):
        """``a`` microbatches, rows ``[i·b/a, (i+1)·b/a)`` of every feed
        (the JAX package's ``reshape((a, b // a) + ...)``; under a mesh,
        of each rank's rows, see :meth:`_put_feed`), each drawing its masks
        from the step's stream in turn, the program state threaded from
        one to the next: (the outputs' means, the last state, the grads
        summed in f32 and divided by ``a``). A param left unreached gets
        zeros, as ``jax.grad`` gives. A DTensor param's grad is reduced to
        its placements after each microbatch (as GSPMD exchanges inside
        the JAX package's microbatch scan)."""
        params = self.scope.params if params is None else params
        for k, v in feed.items():
            n = _local(v).shape[0] if v.dim() >= 1 else 0
            enforce(v.dim() >= 1 and n % a == 0,
                    f"DistStrategy(accum_steps={a}): feed {k!r} of shape "
                    f"{tuple(v.shape)} does not split into {a} microbatches")
        acc = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        state = self.scope.state if state is None else state
        outs, reached = [], set()
        for i in range(a):
            micro = {k: _micro_slice(v, i, a) for k, v in feed.items()}
            out, state = self._forward_backward(micro, stream, state, params, ls)
            state = {k: v.detach() for k, v in state.items()}
            outs.append(out)
            with torch.no_grad():
                for k, p in params.items():
                    if p.grad is not None:
                        acc[k].add_(_reduced_grad(p))
                        p.grad = None
                        reached.add(k)
        grads = {k: g.div_(a) for k, g in acc.items()}
        # the step's grads stay on the params, in their dtypes
        for k in reached:
            p = params[k]
            p.grad = grads[k] if grads[k].dtype == p.dtype else grads[k].to(p.dtype)
        return {k: _mean_of([o[k] for o in outs]) for k in outs[0]}, state, grads

    def _step_body(self, feed: Dict[str, torch.Tensor],
                   stream: RngStream) -> Dict[str, torch.Tensor]:
        """One step on the device, with no read back to the host: the
        forward (random ops drawing from ``stream``) and backward, on each
        microbatch under gradient accumulation, the exchange under a mesh,
        the unscale and finiteness flag, the guard's mask, the update, and
        the select of the old values where the step is skipped
        (``LossScaler.select``, as the JAX package's step,
        executor.py:1008-1115; the loss-scale state is not rolled back).
        The results are written into the training state's own tensors
        (:func:`write_in_place`). Returns the fetched outputs (under a mesh
        as full tensors on every rank).

        ``step`` runs it eagerly; ``run_steps`` runs it from fixed feed
        slots, captured as a CUDA graph on the card (``_captured_step``)."""
        params = self.scope.params
        scaler, ls = self.loss_scaler, self.scope.loss_scale_state
        resid = self.scope.quant_resid if self.mesh is not None else None
        for p in params.values():
            p.grad = None
        with self._mesh_scope():
            if self._exchange == "local":
                out, new_state, grads, new_resid, unscaled = self._local_grads(feed, stream)
            else:
                out, new_state, grads = self._grads(feed, stream)
                new_resid, unscaled = None, False
            # an output that is training state (a state variable the program
            # returns) is copied: the update below writes that tensor in place
            owned = {_local(t).untyped_storage().data_ptr()
                     for t in _leaves(self._state_trees())}
            out = {k: v.clone() if _local(v).untyped_storage().data_ptr() in owned else v
                   for k, v in out.items()}
            keep = None  # 0-d bool on the device: whether this step's update stands
            with torch.no_grad():
                if scaler is not None:
                    present = {k: g for k, g in grads.items() if g is not None}
                    if not unscaled:
                        grads.update(scaler.unscale(present, ls))
                    keep = scaler.all_finite([grads[k] for k in present])
                    new_ls = scaler.update(ls, keep)
                    out["loss_scale"] = new_ls["scale"]
                if self._guard is not None:
                    # with a loss scaler a grad overflow is the scaler's to skip
                    # and back off from; the guard then watches the outputs only
                    mask = self._guard_mask(out, None if scaler is not None else grads)
                    out["guard_nonfinite"] = mask
                    keep = mask == 0 if keep is None else keep & (mask == 0)
            with torch.no_grad(), record_function("trainer.update"):
                values = {k: p.detach() for k, p in params.items()}
                new_state = {k: v.detach() for k, v in new_state.items()}
                new_params, new_opt = self.optimizer.update(
                    grads, self.scope.opt_state, values, self.program.param_info)
                if keep is not None:
                    new_params = LossScaler.select(keep, new_params, values)
                    new_opt = LossScaler.select(keep, new_opt, self.scope.opt_state)
                    new_state = LossScaler.select(keep, new_state, self.scope.state)
                    if new_resid is not None:
                        # a skipped step banks no residual (executor.py:1077)
                        new_resid = LossScaler.select(keep, new_resid, resid)
                write_in_place({"params": values, "opt": self.scope.opt_state,
                                "state": self.scope.state, "ls": ls or {},
                                "resid": resid if new_resid is not None else {}},
                               {"params": new_params, "opt": new_opt, "state": new_state,
                                "ls": new_ls if scaler is not None else {},
                                "resid": new_resid or {}})
            if self.mesh is not None:
                out = {k: _full(v) for k, v in out.items()}
        return out

    def _grads(self, feed: Feed, stream: RngStream):
        """(fetched outputs, new state, grads) of the step on one device or
        through the mesh's default exchange: the program runs on the
        DTensors (under ZeRO on params gathered from the rows) and each
        grad is reduced to its param's placements (under ZeRO
        reduce-scattered to rows)."""
        from .parallel import zero as zero_mod

        model = self.scope.params
        if self._zero is not None:
            with torch.no_grad():
                model = zero_mod.combine_params(model, self._zero, self.mesh)
            for p in model.values():
                p.requires_grad_(p.is_floating_point())
        a = _strategy_accum(self.strategy)
        if a > 1:
            out, new_state, grads = self._accumulate(feed, stream, a, model)
        else:
            out, new_state = self._forward_backward(feed, stream, self.scope.state, model)
            # jax.grad gives every param a grad, zeros where the program did
            # not reach it (a frozen param is detached); its regularizer and a
            # global-norm clip see those zeros, and the update skips frozen ones
            grads = {k: (torch.zeros_like(p) if p.grad is None
                         else (p.grad if self._zero is not None else _reduced_grad(p)))
                     for k, p in model.items()}
        if self._zero is not None:
            with torch.no_grad():
                grads = zero_mod.partition_grads(grads, self._zero, self.mesh)
            for k, p in self.scope.params.items():
                p.grad = grads[k]
        return out, new_state, grads

    def _local_grads(self, feed: Feed, stream: RngStream):
        """The rank-local gradient path (executor.py:590-880): the program
        runs on this rank's local tensors with no collective, over its
        ``accum_steps`` microbatches, and the grads are exchanged ONCE: one
        ``all_reduce`` of all of them in one buffer (the hoisted
        exchange), or per grad the quantized ring with its error feedback.
        The float scalar outputs are averaged over the ranks. Returns
        (outputs, state, grads as replicated DTensors, new residual or
        None, whether the grads are already unscaled)."""
        import torch.distributed as dist
        from .parallel import api as par_api

        mesh, axes = self.mesh, self._exchange_axes
        group = mesh.axes_group(axes)
        dshard = int(np.prod([mesh.shape[x] for x in axes]))
        a = _strategy_accum(self.strategy)
        scaler = self.loss_scaler
        ls = self.scope.loss_scale_state
        ls_local = None if ls is None else {k: v.to_local() for k, v in ls.items()}
        src = self.scope.params
        if self._zero is not None:
            from .parallel import zero as zero_mod
            with torch.no_grad():
                src = zero_mod.combine_params(src, self._zero, mesh)
        lparams = {k: p.to_local().detach().requires_grad_(p.is_floating_point())
                   for k, p in src.items()}
        lfeed = {k: v.to_local() if hasattr(v, "to_local") else v for k, v in feed.items()}
        b = next(iter(lfeed.values())).shape[0]
        enforce(b % a == 0, f"batch {b * dshard} must divide accum_steps*data shards "
                            f"({a}*{dshard}) for the rank-local exchange")
        if a > 1:
            out, _, grads = self._accumulate(lfeed, stream, a, lparams, ls_local, state={})
        else:
            out, _ = self._forward_backward(lfeed, stream, {}, lparams, ls_local)
            grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
                     for k, p in lparams.items()}
        for k, v in out.items():
            enforce(v.is_floating_point() and v.dim() == 0,
                    f"accum_exchange='hoisted': output {k!r} is {v.dtype}"
                    f"{tuple(v.shape)} per rank — only float scalar outputs (loss/metrics) "
                    "can be averaged across ranks; pass fetch_list=[...] to prune "
                    "per-sample or integer outputs")
        with torch.no_grad():
            names = sorted(out)
            if names:
                outs = torch.stack([out[k].float() for k in names])
                dist.all_reduce(outs, group=group)
                out = {k: (outs[i] / dshard).to(out[k].dtype) for i, k in enumerate(names)}
            new_resid, unscaled = None, False
            if self._quant is None:
                grads = _allreduce_mean(grads, group, dshard)
            else:
                grads, new_resid = self._quantized_exchange(grads, ls_local, stream)
                unscaled = scaler is not None
            grads = {k: par_api.replicate(mesh, g) for k, g in grads.items()}
            if self._zero is not None:
                # the exchanged grads are whole on every rank: each keeps its row
                grads = zero_mod.partition_grads(grads, self._zero, mesh)
        for k, p in self.scope.params.items():
            p.grad = grads[k]
        return out, {}, grads, new_resid, unscaled

    def _quantized_exchange(self, grads, ls_local, stream: RngStream):
        """The quantized exchange of the local path (executor.py:542): per
        grad, unscale (the residual lives in unscaled units), add this
        rank's error-feedback residual, round-trip through the wire grid
        (the new residual is what did not make it onto the wire), then the
        quantized ring over each data axis and the mean. Stochastic
        rounding draws from a ``torch.Generator`` seeded from the step's
        seed, the grad's index and the axis."""
        from torch.distributed.tensor import DTensor
        from .parallel import quantized_collectives as qc

        q, mesh, axes = self._quant, self.mesh, self._exchange_axes
        dshard = int(np.prod([mesh.shape[x] for x in axes]))
        resid = self.scope.quant_resid
        scaler = self.loss_scaler
        out, new_resid = {}, ({} if resid is not None else None)

        def gen(*tags):
            if not q["stochastic_rounding"]:
                return None
            seed = mix_seed(stream.seed, 0x7157)
            for t in tags:
                seed = mix_seed(seed, t)
            return torch.Generator(device=self.device).manual_seed(seed)

        for i, (k, g) in enumerate(sorted(grads.items())):
            if scaler is not None:
                g = g * (1.0 / ls_local["scale"]).to(g.dtype)
            key = gen(i)
            if resid is not None:
                v = g.float() + resid[k].to_local()[0]
                x = qc.block_roundtrip(v, bits=q["bits"], block_size=q["block_size"],
                                       generator=key)
                r = resid[k]
                new_resid[k] = DTensor.from_local((v - x)[None], r.device_mesh, r.placements,
                                                  run_check=False)
                key = None  # the ring re-encodes x exactly; the rounding is spent
            else:
                x = g
            for j, ax in enumerate(axes):
                x = qc.quantized_psum(x, mesh.group(ax), bits=q["bits"],
                                      block_size=q["block_size"],
                                      generator=None if key is None else gen(i, j))
            out[k] = (x / dshard).to(g.dtype)
        return out, new_resid

    def run_steps(self, stacked_feed: Feed, k: Optional[int] = None,
                  rng: Optional[int] = None,
                  span: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """K optimization steps in one dispatch (executor.py:1341):
        ``stacked_feed`` carries K per-step batches on a new leading axis
        (``{name: (K, batch, ...)}``); the fetched outputs come back
        stacked ``(K, ...)``. Each step draws from the seed ``step()``
        would draw at its global step (``mix_seed(seed + 1,
        global_step + i)``, or ``mix_seed(rng, global_step + i)``), so K
        fused steps are bit for bit K ``step()`` calls, the guard and the
        loss scaler working per step. ``global_step`` advances by K; the
        guard charges an incident to its own step.

        On the card the step is captured once as a CUDA graph (per trainer
        and feed signature) and replayed K times (``_captured_step``); a
        failed capture or replay raises, and never runs eager steps. On the
        CPU the same body runs K times. ``k`` must equal the feed's
        leading dim; a remainder batch goes to :meth:`step`, as ``fit``
        sends it. ``span`` is taken and unused until item 24."""
        from . import _captured_step

        enforce(self.scope.opt_state is not None, "call startup() before run_steps()")
        default_device(self.device, "Trainer.run_steps")
        lead = {name: int(v.shape[0]) for name, v in stacked_feed.items()}
        enforce(len(set(lead.values())) == 1,
                f"run_steps: stacked feed leading dims disagree: {lead}")
        feed_k = next(iter(lead.values()))
        k = feed_k if k is None else int(k)
        enforce(k == feed_k, f"run_steps(k={k}): stacked feed carries {feed_k} step "
                             "batches on its leading axis")
        feed = self._put_feed(stacked_feed, stacked=True)
        base = self.global_step
        seeds = [self._step_seed(rng, base + i, fused=True) for i in range(k)]
        if self._fused is None or not self._fused.valid_for(self, feed):
            self._fused = None  # the old graph and its pool go first
            self._fused = _captured_step.FusedSteps(self, feed)
        with record_function("trainer.run_steps"):
            outs = self._fused.run(feed, seeds)
        self.global_step += k
        self._after_dispatch(outs, feed, k)
        return outs

    # -- the NaN/Inf guard's host half (executor.py:1404-1500) -------------
    def _guard_mask(self, out: Dict[str, torch.Tensor], grads) -> torch.Tensor:
        """The step's 0-d int64 bitmask on the device: bit i is set when
        checked value i (the grads, when given, then each float output in
        name order) holds a NaN or an Inf. Past 32 values the tail folds
        into bit 31, as the JAX package's uint32 mask does."""
        names, flags = [], []
        if grads is not None:
            names.append("grads")
            flags.append(~LossScaler.all_finite([g for g in grads.values()
                                                 if g is not None]))
        for k in sorted(out):
            v = out[k]
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                names.append(k)
                flags.append(~torch.isfinite(v).all())
        if len(flags) > 32:
            rest = flags[31:]
            flags = flags[:31] + [torch.stack(rest).any()]
            names = names[:31] + [f"any-of-{len(rest)}-more:{'/'.join(names[31:34])}…"]
        self._guard_bit_names = tuple(names)
        if not flags:
            return torch.zeros((), dtype=torch.int64, device=self.device)
        bits = torch.stack(flags).to(torch.int64)
        return (bits << torch.arange(len(flags), device=bits.device)).sum()

    def _guard_enqueue(self, mask: torch.Tensor, feed: Feed, base_step: int,
                       k: int) -> None:
        """Park this dispatch's mask (``(k,)`` for ``k`` fused steps from
        ``base_step``) and examine the previous one (which bits, the
        incidents, the escalation); with ``GuardPolicy(defer_readback=False)``
        examine it at once, so an escalation raises at the dispatch at
        fault."""
        item = (mask, feed if self._guard.record_feed_digest else None, base_step, k)
        if not self._guard.defer_readback:
            self._guard_examine(*item)
            return
        prev, self._guard_pending = self._guard_pending, item
        if prev is not None:
            self._guard_examine(*prev)

    def drain_guard(self) -> None:
        """Read the last parked guard mask (one wait on the device). Call
        it where the step loop pauses, before reading ``guard_incidents``;
        ``fit`` does at its end and on preemption."""
        prev, self._guard_pending = self._guard_pending, None
        if prev is not None:
            self._guard_examine(*prev)

    def _guard_examine(self, mask: torch.Tensor, feed: Optional[Feed], base_step: int,
                       k: int) -> None:
        """Record an incident for each step whose mask is not 0, at its own
        step, digesting only that step's slice of a stacked feed, then
        escalate at each incident's step (executor.py:1466-1500)."""
        from . import resilience

        masks = [int(m) for m in mask.reshape(-1).tolist()]
        if not any(masks):
            return
        recorded = []
        for i, m in enumerate(masks):
            if not m:
                continue
            bad = tuple(n for b, n in enumerate(self._guard_bit_names) if (m >> b) & 1)
            digest = None
            if feed is not None:
                try:
                    digest = resilience.feed_digest(
                        {n: v[i] for n, v in feed.items()} if k > 1 else feed)
                except Exception:  # digesting must never mask the incident
                    digest = None
            recorded.append(resilience.record_incident(
                self.guard_incidents, base_step + i, bad or ("unknown",), digest))
        self.guard_incident_total += len(recorded)
        for inc in recorded:
            resilience.escalate_if_needed(self.guard_incidents, self._guard, inc.step)

    def _warn_inert_nan_flag(self) -> None:
        """The check_nan_inf flag is read at startup: turned on later it
        arms nothing on this trainer, so say so once."""
        if self._nan_flag_warned or self._guard_opt_out or not get_flag("check_nan_inf"):
            return
        import warnings
        self._nan_flag_warned = True
        warnings.warn("check_nan_inf was enabled after Trainer.startup(): the guard is "
                      "resolved at startup, so the flag has no effect on this trainer; "
                      "set it before startup() or pass Trainer(guard=GuardPolicy(...))")

    def eval(self, feed: Feed) -> Dict[str, torch.Tensor]:
        """Forward pass in inference mode (no dropout), no update; returns
        every output. With the interleaved rest layout the stacked rows make
        sense only through the schedule, so eval enters the training
        pipeline (executor.py:1215-1245) and its batch must divide into
        ``pp_microbatches``; a plain-pp trainer evaluates layer by layer at
        any batch."""
        feed = self._put_feed(feed)
        pp = contextlib.nullcontext()
        if self._pp_perm:
            pp_m, pp_v = self._pp_settings()
            b = next(iter(feed.values())).shape[0]
            enforce(b % pp_m == 0,
                    f"Trainer.eval with pp_interleave={pp_v}>1 runs the training pipeline "
                    f"schedule, so the eval batch ({b}) must be divisible by "
                    f"pp_microbatches={pp_m} (and its microbatches by the dp shard "
                    "product) — pad or re-batch the eval feed; plain-pp trainers keep "
                    "the any-batch layer-by-layer path")
            pp = pipeline_mode(self.mesh, pp_m, interleave=pp_v, param_layout="interleaved")
        with torch.no_grad(), self._mesh_scope(), pp:
            out, _ = self._run(feed, training=False, params=self._logical_params())
        return {k: _full(v.detach()) for k, v in out.items()}


class CheckpointConfig:
    """contrib.trainer CheckpointConfig analog (contrib/trainer.py:100):
    where ``fit`` saves (``checkpoint_dir``), every how many epochs and
    steps (0: never), and how many of its own checkpoints it keeps."""

    def __init__(self, checkpoint_dir: str, epoch_interval: int = 1,
                 step_interval: int = 0, max_num_checkpoints: int = 3):
        self.checkpoint_dir = checkpoint_dir
        self.epoch_interval = epoch_interval
        self.step_interval = step_interval
        self.max_num_checkpoints = max_num_checkpoints


class Event:
    """Training events (contrib.trainer BeginEpochEvent/EndStepEvent…):
    ``kind`` is begin_epoch, begin_step, end_step, end_epoch, preempted
    (once, after the boundary checkpoint, when fit returns on
    SIGTERM/SIGINT) or resized (the same, on a ``ResizeRequest``);
    ``step`` the trainer's global step when it fired; ``metrics`` the
    step's fetched outputs on end_step (stacked ``(n, ...)`` for a fused
    dispatch of n steps); ``num_steps`` the steps an event covers;
    ``pipeline`` the input pipeline's report (``Trainer.pipeline_report``)
    on end_epoch, preempted and resized."""

    def __init__(self, kind: str, epoch: int, step: int, metrics=None,
                 num_steps: int = 1, pipeline=None):
        self.kind = kind
        self.epoch = epoch
        self.step = step
        self.metrics = metrics or {}
        self.num_steps = num_steps
        self.pipeline = pipeline


# fit's arguments of later slices: (default, the slice that brings it)
_FIT_LATER = {
    "feed_wire": (None, "data extras, ROADMAP queue 1 item 23"),
    "device_cache": (None, "data extras, ROADMAP queue 1 item 23"),
    "augment": (None, "data extras, ROADMAP queue 1 item 23"),
    "profile_interval_steps": (0, "observability, ROADMAP queue 1 item 24"),
}


def _fit_tag(tag: str) -> bool:
    """Whether a checkpoint tag is fit's own (step_N / epoch_N): only those
    rotate, so a hand-saved checkpoint in the same directory ("best") is
    never deleted."""
    head, _, num = tag.partition("_")
    return head in ("step", "epoch") and num.isdigit()


def fit(trainer: Trainer, reader, num_epochs: int, feed_names: Sequence[str],
        dtypes: Optional[Sequence[Any]] = None, event_handler=None,
        checkpoint_config: Optional[CheckpointConfig] = None, prefetch: bool = True,
        steps_per_dispatch: int = 1, resume: bool = False, elastic: bool = False,
        preemption: Optional[bool] = None, resize=None, feed_wire=None,
        profile_interval_steps: int = 0, device_cache=None, augment=None):
    """High-level train loop (contrib.trainer.Trainer.train analog):
    reader → DataFeeder → DeviceFeeder (``prefetch=True``: batches copied
    to the card on a side stream while the step runs) or a plain put →
    ``trainer.step``, with begin_epoch / begin_step / end_step / end_epoch
    events in the JAX package's order and with its step counts. A trainer
    on the CPU has nothing to prefetch to: pass ``prefetch=False`` there.
    At its end (and on preemption) fit reads the guard's last parked mask
    (``Trainer.drain_guard``), so every incident is recorded.

    With a ``checkpoint_config`` fit saves ``step_N`` every
    ``step_interval`` steps and ``epoch_N`` every ``epoch_interval``
    epochs (``io.save_trainer``), keeps the newest ``max_num_checkpoints``
    of its own tags (rebuilt from disk, so a restart rotates the old ones
    out) and sweeps torn-save leftovers at start. ``resume=True`` restores
    the newest valid checkpoint (falling back over corrupt ones) and skips
    the batches of its epoch that it already consumed. ``preemption``
    (default: on with a checkpoint_config) catches SIGTERM/SIGINT: fit
    saves a boundary checkpoint after the current step, fires
    ``"preempted"`` and returns.

    ``elastic=True`` (with ``resume``) restores a checkpoint written at
    another mesh through ``resilience.reshard_restore``, its feasibility
    checked on one batch peeked from the reader (an infeasible batch raises
    ``ReshardError`` before any step). ``resize`` (a path or a
    ``resilience.ResizeRequest``) is polled at each dispatch boundary after
    the preemption flag: once requested, fit saves the boundary checkpoint
    (unless this run just saved this step), waits for the sharded saves in
    flight, fires ``"resized"`` and returns, for the launcher to relaunch
    at the new size; a SIGTERM that arrived too is reported as
    ``"preempted"``.

    ``steps_per_dispatch=K`` fuses the steps: the batches come in K-batch
    chunks (``DeviceFeeder(stack_k=K)``, or ``iter_chunked`` without the
    prefetch) and each full chunk runs as one ``trainer.run_steps``;
    remainder batches and batches of another shape go to
    ``trainer.step``. Events fire once a dispatch (``Event.num_steps``,
    stacked metrics), ``global_step`` advances by the steps taken,
    ``step_interval`` checkpoints and preemption are checked at dispatch
    boundaries (a save lands on the boundary that crossed the interval),
    and a resume re-stacks the chunks from the restored position."""
    from . import io as _io
    from . import resilience
    from .data.feeder import DataFeeder, DeviceFeeder, iter_chunked

    given = {"feed_wire": feed_wire, "device_cache": device_cache, "augment": augment,
             "profile_interval_steps": profile_interval_steps}
    for name, (default, later) in _FIT_LATER.items():
        if given[name] != default:
            raise NotYetPorted(f"fit({name}=...): {later}")
    enforce(int(steps_per_dispatch) >= 1,
            f"fit(steps_per_dispatch={steps_per_dispatch}): need >= 1")
    k = int(steps_per_dispatch)
    feeder = DataFeeder(feed_names, dtypes)

    def emit(*args, **kw):
        if event_handler:
            event_handler(Event(*args, **kw))

    enforce(resume or not elastic,
            "fit(elastic=True) without resume=True does nothing: elastic names the "
            "resume-across-a-mesh-change behavior")
    start_epoch, skip_steps = 0, 0
    if resume:
        enforce(checkpoint_config is not None,
                "fit(resume=True) needs a checkpoint_config to scan")
        sample_feed = None
        if elastic:
            # one reader batch, peeked (each epoch calls reader() afresh), for
            # the reshard's feasibility check: a batch the new data shards
            # cannot split is a ReshardError here, not an error mid-run
            first = next(iter(reader()), None)
            if first is not None:
                sample_feed = feeder.feed(first)
        meta = resilience.restore_latest(checkpoint_config.checkpoint_dir, trainer,
                                         elastic=elastic, sample_feed=sample_feed)
        if meta is not None:
            start_epoch = int(meta.get("epoch", 0))
            skip_steps = int(meta.get("epoch_step", 0))

    kept: List[str] = []
    if checkpoint_config is not None:
        resilience.sweep_tmp_dirs(checkpoint_config.checkpoint_dir)
        # over-quota checkpoints from earlier runs go at this run's first
        # save: trimming here could delete the only valid one, just restored
        kept = [c.path for c in resilience.list_checkpoints(
            checkpoint_config.checkpoint_dir) if _fit_tag(c.tag)]
    last_saved_step = [None]  # the step of this run's last save

    def save(tag: str, epoch: int, epoch_step: int):
        if checkpoint_config is None:
            return
        d = os.path.join(checkpoint_config.checkpoint_dir, tag)
        _io.save_trainer(d, trainer, extra_meta={"epoch": epoch, "epoch_step": epoch_step})
        last_saved_step[0] = trainer.global_step
        if d in kept:  # a re-saved tag takes the newest place
            kept.remove(d)
        kept.append(d)
        while len(kept) > checkpoint_config.max_num_checkpoints:
            shutil.rmtree(kept.pop(0), ignore_errors=True)

    use_preempt = preemption if preemption is not None else checkpoint_config is not None
    # a scheduled resize: a path becomes a ResizeRequest; a request the
    # caller made (and may hold a signal for) is used as it is
    resize_ctx = (resilience.ResizeRequest(resize) if isinstance(resize, (str, os.PathLike))
                  else resize)
    si = checkpoint_config.step_interval if checkpoint_config else 0
    with (resilience.PreemptionHandler() if use_preempt
          else contextlib.nullcontext()) as ph, \
            (resize_ctx if resize_ctx is not None else contextlib.nullcontext()) as rz:
        for epoch in range(start_epoch, num_epochs):
            # a resume lands mid-epoch: skip the batches the restored
            # checkpoint already consumed (one batch is one step), and
            # chunk the rest from there
            skip = skip_steps if epoch == start_epoch else 0
            steps_in_epoch = skip
            emit("begin_epoch", epoch, trainer.global_step)

            def batches(_skip=skip):
                for i, samples in enumerate(reader()):
                    if i >= _skip:
                        yield feeder.feed(samples)

            device_feeder = None
            if prefetch:
                device_feeder = DeviceFeeder(batches, device=trainer.device, stack_k=k,
                                             metrics=trainer.pipeline_metrics)
                items = iter(device_feeder)
            elif k > 1:
                items = iter_chunked(batches(), k, put_fn=trainer._put_feed,
                                     put_stacked_fn=lambda f: trainer._put_feed(f, stacked=True))
            else:
                items = map(trainer._put_feed, batches())
            preempted = resized = False
            try:
                for item in items:
                    n, feed = item if k > 1 else (1, item)
                    gs_before = trainer.global_step
                    emit("begin_step", epoch, gs_before, num_steps=n)
                    out = trainer.run_steps(feed, k=n) if n > 1 else trainer.step(feed)
                    steps_in_epoch += n
                    emit("end_step", epoch, trainer.global_step, out, num_steps=n)
                    # a dispatch that crossed an interval multiple saves (the
                    # exact multiple when n == 1)
                    if si and trainer.global_step // si > gs_before // si:
                        save(f"step_{trainer.global_step}", epoch, steps_in_epoch)
                    if ph is not None and ph.requested:
                        preempted = True
                        break
                    if rz is not None and rz.requested:
                        preempted = resized = True
                        break
            finally:
                # an abandoned epoch (exception, early exit, preemption)
                # stops the fill thread
                if device_feeder is not None:
                    device_feeder.close()
            if preempted:
                # read the parked guard mask; an escalation it raises must
                # not cost the boundary checkpoint (the bad update was
                # discarded on the device), so it is raised after the save
                guard_err = None
                try:
                    trainer.drain_guard()
                except FloatingPointError as e:
                    guard_err = e
                # the boundary checkpoint, unless this run's interval save
                # just wrote this very step (a stale same-tag directory of
                # an earlier run does not count)
                if last_saved_step[0] != trainer.global_step:
                    save(f"step_{trainer.global_step}", epoch, steps_in_epoch)
                _io.wait_for_checkpoints()
                if ph is not None and ph.requested:
                    # a SIGTERM that landed after the resize poll wins: a real
                    # preemption is never reported as a planned resize
                    resized = False
                # (the JAX package journals fit.resized / fit.preempted, counts
                # them and dumps its flight recorder here: ROADMAP queue 1,
                # item 24)
                emit("resized" if resized else "preempted", epoch, trainer.global_step,
                     pipeline=trainer.pipeline_report())
                if guard_err is not None:
                    raise guard_err
                return trainer
            emit("end_epoch", epoch, trainer.global_step, pipeline=trainer.pipeline_report())
            if checkpoint_config and checkpoint_config.epoch_interval and \
                    (epoch + 1) % checkpoint_config.epoch_interval == 0:
                save(f"epoch_{epoch}", epoch + 1, 0)
    trainer.drain_guard()
    return trainer


class Inferencer:
    """High-level inference wrapper (contrib/inferencer.py:31): build the
    inference program, load its params, run batches.

        inf = Inferencer(infer_fn, param_path="ckpt_dir")
        out = inf.infer({"image": batch})

    ``param_path`` is a persistables or ``save_trainer`` directory;
    otherwise pass ``params`` (and ``state``). Runs on ``place``: the CUDA
    card unless the caller passes the CPU (no card: NoCudaDevice)."""

    def __init__(self, infer_func: Callable, param_path: Optional[str] = None,
                 params=None, state=None, place=None):
        from . import io as _io

        self.program = infer_func if isinstance(infer_func, Program) else build(infer_func)
        self.device = default_device(place, "Inferencer")
        self.place = self.device
        if param_path is not None:
            params, state, _, _ = _io.load_persistables(param_path)
            enforce(bool(params), f"Inferencer: no parameters found in {param_path!r}")
        enforce(params is not None, "Inferencer: need param_path or params")
        self._params = {k: _put(v, self.device) for k, v in params.items()}
        self._state = {k: _put(v, self.device) for k, v in (state or {}).items()}

    def infer(self, inputs: Feed, return_numpy: bool = True):
        with torch.no_grad():
            out, _ = self.program.apply(self._params, self._state, training=False,
                                        place=self.device, **inputs)
        return _to_numpy(out) if return_numpy else out


_global_scope = Scope()


def global_scope() -> Scope:
    """executor.py global_scope analog: the process-wide name→tensor
    scope used when no explicit scope is passed."""
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope: Scope):
    """executor.py scope_guard analog: swap the global scope within a
    with-block."""
    global _global_scope
    old, _global_scope = _global_scope, scope
    try:
        yield scope
    finally:
        _global_scope = old


__all__ = ["CheckpointConfig", "Event", "Executor", "Inferencer", "Scope", "Trainer",
           "fit", "global_scope", "scope_guard"]
