"""Framework core (counterpart of ``paddle_tpu.framework``): parameter
attributes, the build context, ``create_parameter``/``LayerHelper``,
``Program`` and ``build``.

As in the JAX package a *function* is the program: layer calls inside it
ask the active :class:`BuildContext` for parameters by stable unique names
(``fc_0/w``). ``Program.init`` runs the function once on example inputs
and creates the parameters and state (the startup program);
``Program.apply`` runs it with given ones and returns ``(outputs,
new_state)``. Both run eagerly in PyTorch: ``init`` under
``torch.no_grad`` on the example's device, ``apply`` on the scope's own
tensors, so autograd records the graph that ``Trainer.step``
differentiates.

Where the port differs from the JAX package:

- An rng key is a Python int. A parameter draws from its own CPU
  generator seeded from the key and its full name
  (:func:`initializer.param_generator`), so its values depend neither on
  the device nor on the order of the other layers. A run's random ops
  draw from its :class:`RngStream`: one generator on the program's
  device, seeded once a run, whose state advances at every draw (so a
  captured step replays it; ``Trainer.run_steps``).
- The compute dtype of mixed precision is recorded on the context when
  ``init``/``apply`` starts (the active :func:`amp_guard`'s dtype, else the
  ``default_compute_dtype`` flag); layers read it from there through
  :func:`compute_dtype`, never from a process global.
  :func:`cast_compute` takes it as an explicit argument, as the GPT
  generator calls it. The program's image layout is recorded there too, and
  :func:`current_layout` reads it, so a block recomputed by
  :func:`maybe_remat` on autograd's thread sees the layout its forward
  saw.
- ``trainable=False`` detaches the parameter: its grad is None where the
  JAX package's ``stop_gradient`` gives zeros; the optimizer skips both.
- A remat policy (:func:`resolve_remat_policy`) is a selective
  activation-checkpoint policy of ``torch.utils.checkpoint``, not a
  ``jax.checkpoint_policies`` callable; the names map onto it.
- :func:`sp_mode` and :func:`pipeline_mode` are the JAX package's
  ambient sequence- and pipeline-parallel switches; the Trainer enters
  them from ``DistStrategy(sequence_parallel=True, sp_impl=...)`` and
  ``DistStrategy(pp_microbatches=..., pp_interleave=...)``. Where the
  JAX package folds a key per (layer, microbatch, data shard) inside the
  pipeline, the port draws from a side generator seeded from the run's
  seed and that tag (:func:`rng_derived`), so a captured step reseeds it
  before each replay.
- Not carried yet, raising :class:`NotYetPorted`: ``Program.desc`` and
  ``desc_flat`` (jaxprs; an FX form comes with ROADMAP queue 1 item 25).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                     create_selective_checkpoint_contexts, noop_context_fn)

from .core import unique_name as _unique_name
from .core.config import get_flag
from .core.dtypes import convert_dtype
from .core.errors import EnforceError, NotFoundError, NotYetPorted, enforce
from .core.place import default_device
from .initializer import param_generator

Params = Dict[str, torch.Tensor]
State = Dict[str, torch.Tensor]

DEFAULT_DTYPE = torch.float32


# --------------------------------------------------------------------------
# ParamAttr — per-parameter attributes (param_attr.py analog)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ParamAttr:
    """Parameter attributes (python/paddle/fluid/param_attr.py analog).

    ``regularizer`` is an object with ``apply(param, grad) -> grad`` (see
    paddle_tpu_torch.regularizer); ``learning_rate`` is a per-param LR
    multiplier; ``trainable=False`` freezes the parameter."""

    name: Optional[str] = None
    initializer: Optional[Any] = None
    learning_rate: float = 1.0
    regularizer: Optional[Any] = None
    trainable: bool = True

    @staticmethod
    def to_attr(attr: Any) -> "ParamAttr":
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if attr is False:
            return ParamAttr(trainable=False)
        raise ValueError(f"Cannot interpret param_attr: {attr!r}")


@dataclasses.dataclass
class ParamInfo:
    """Static metadata recorded at init for each parameter."""

    shape: Tuple[int, ...]
    dtype: Any
    trainable: bool = True
    learning_rate: float = 1.0
    regularizer: Optional[Any] = None
    is_distributed: bool = False


# --------------------------------------------------------------------------
# BuildContext — the live scope while a program runs
# --------------------------------------------------------------------------


class RngStream:
    """The random numbers of one program run: a generator on the run's
    device (``main``), seeded once a run by :meth:`reset`, whose state
    advances at every draw. The draws of one run differ from each other
    (each dropout mask, each layer), and one seed draws the same numbers
    again. ``Trainer`` seeds its stream before each step from
    ``mix_seed(seed + 1, global_step)`` or the step's ``rng``.

    Side generators, taken in the order the run asks for them, serve
    draws that must not come from the advancing main state:

    - a :func:`maybe_remat` recompute, which must draw its forward's
      numbers: :meth:`fork` sets a side generator at the state of the
      generator the block's forward starts from;
    - an op given its own ``seed`` (``dropout(seed=9)``) and a block under
      :func:`rng_scope`: :meth:`seeded`;
    - a block under :func:`rng_derived` (a pipeline layer's draws for one
      microbatch): :meth:`derived`, seeded from the run's seed and a tag.

    A CUDA graph cannot create, seed or read a generator while it is
    captured. A captured step (``Trainer.run_steps`` on the card) runs
    its step once eagerly first, which records the side generators it
    takes: their order, their seeds and, for a fork, the main state's
    offset. :meth:`freeze` fixes that record; from then on :meth:`reset`
    sets every generator on the host before each replay, where the
    replay reads them (``CUDAGraph.register_generator_state``), and the
    graph advances their Philox offsets on the card."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.main = torch.Generator(device=self.device)
        self.seed: Optional[int] = None
        self.used = False  # a draw took the main generator
        self.frozen = False
        self._side: List[torch.Generator] = []
        # per side generator of the run: (its own seed, or None for the
        # run's seed; the Philox offset it starts from)
        self._plan: List[Tuple[Optional[int], int]] = []
        self._taken = 0

    def reset(self, seed: int) -> "RngStream":
        """Seed the next run: the main generator at ``seed``, and (frozen)
        each side generator where the recorded run took it."""
        self.seed = int(seed)
        self.main.manual_seed(self.seed)
        self._taken = 0
        if self.frozen:
            for g, (own, offset) in zip(self._side, self._plan):
                g.manual_seed(self._seed_of(own))
                if offset:
                    g.set_offset(offset)
        else:
            self._plan = []
        return self

    def freeze(self) -> None:
        """Fix the side generators the last run took (see the class)."""
        del self._side[len(self._plan):]
        self.frozen = True

    def generators(self) -> List[torch.Generator]:
        """The generators the last run drew from: main (if it did), then
        the side generators in the order it took them."""
        return ([self.main] if self.used else []) + self._side[:len(self._plan)]

    def generator(self, index: Optional[int] = None) -> torch.Generator:
        """Side generator ``index``, or (None) the main generator."""
        if index is None:
            self.used = True
            return self.main
        return self._side[index]

    def fork(self, index: Optional[int]) -> int:
        """Take the next side generator, set at the current state of
        generator ``index`` (None: main): it draws what ``index`` draws
        from here on. Returns its index."""
        src = self.main if index is None else self._side[index]
        return self._take(None if index is None else self._plan[index][0], src)

    def seeded(self, seed: int) -> int:
        """Take the next side generator, seeded with ``seed``."""
        return self._take(int(seed), None)

    def derived(self, tag: int) -> int:
        """Take the next side generator, seeded with ``mix_seed(run seed,
        tag)``: it follows the run's seed (a captured step reseeds it at
        every :meth:`reset`), unlike :meth:`seeded`'s fixed seed."""
        return self._take(("run", int(tag)), None)

    def _seed_of(self, own) -> int:
        """The seed a side generator takes: the run's (None), the run's
        mixed with a tag (``("run", tag)``) or its own."""
        if own is None:
            return self.seed
        if isinstance(own, tuple):
            from .initializer import mix_seed
            return mix_seed(self.seed, own[1])
        return own

    def _take(self, own: Optional[int], src: Optional[torch.Generator]) -> int:
        i = self._taken
        self._taken += 1
        if self.frozen:
            enforce(i < len(self._plan) and self._plan[i][0] == own,
                    "a captured step asked for its random numbers in another order "
                    "than the run it was recorded from (control flow that depends "
                    "on the data?)")
            return i
        if i == len(self._side):
            self._side.append(torch.Generator(device=self.device))
        g = self._side[i]
        if src is None:
            g.manual_seed(self._seed_of(own))
            offset = 0
        else:
            g.set_state(src.get_state())
            offset = src.get_offset() if self.device.type == "cuda" else 0
        self._plan.append((own, offset))
        return i


def as_stream(rng: Union[None, int, RngStream], device) -> Optional[RngStream]:
    """``rng`` as a run's :class:`RngStream`: a stream passes as it is,
    an int seeds a new one on ``device``, None has none."""
    if rng is None or isinstance(rng, RngStream):
        return rng
    return RngStream(device).reset(int(rng))


class BuildContext:
    """Per-run context: parameter scope, name generator, rng, mode, the
    device, the compute dtype and the image layout.

    Mode 'init' creates parameters (the startup program); mode 'apply'
    fetches them. Name generation is context-local, so the init and apply
    runs of one function agree. ``rng`` is an int seed or an
    :class:`RngStream`; the parameters of init draw from the seed, the
    run's random ops from the stream."""

    def __init__(self, mode: str, params: Params, state: State,
                 rng: Union[None, int, RngStream], training: bool,
                 param_info: Dict[str, ParamInfo], device: torch.device,
                 compute_dtype: torch.dtype, layout: str = "NCHW"):
        enforce(mode in ("init", "apply"), f"BuildContext mode {mode!r}")
        self.mode = mode
        self.params = params
        self.state = state
        self.new_state: State = {}
        self.stream = as_stream(rng, device)
        self.rng = None if self.stream is None else self.stream.seed
        # the side generator of ``stream`` the run draws from (None: main)
        self.gen_index: Optional[int] = None
        self.training = training
        self.param_info = param_info
        self.device = device
        self.compute_dtype = compute_dtype
        self.layout = layout
        self.namer = _unique_name.UniqueNameGenerator()
        self.name_stack: List[str] = []

    # -- naming ------------------------------------------------------------
    def unique_name(self, key: str) -> str:
        return self.namer(key)

    def full_name(self, suffix: str) -> str:
        return "/".join(self.name_stack + [suffix]) if self.name_stack else suffix

    # -- rng ---------------------------------------------------------------
    def next_rng_key(self) -> torch.Generator:
        enforce(self.stream is not None,
                "This program needs an RNG (dropout/random op) but none was "
                "passed; call apply(..., rng=seed).")
        return self.stream.generator(self.gen_index)

    def param_rng_key(self, name: str) -> torch.Generator:
        # one generator per name: stable when unrelated layers are added or
        # reordered, as the per-name fold_in of the JAX package
        return param_generator(self.rng, name)


_tls = threading.local()


def _ambient_compute_dtype() -> torch.dtype:
    return convert_dtype(getattr(_tls, "amp_dtype", None)
                         or get_flag("default_compute_dtype"))


def compute_dtype() -> torch.dtype:
    """Mixed-precision compute dtype of the running program (recorded on
    its context when init/apply started); outside a program, the active
    :func:`amp_guard`'s dtype, else the ``default_compute_dtype`` flag.
    Master params stay float32; layers cast matmul operands to this."""
    ctx = current_context()
    return ctx.compute_dtype if ctx is not None else _ambient_compute_dtype()


@contextlib.contextmanager
def amp_guard(dtype="bfloat16"):
    """Scoped mixed precision for the programs started inside the block
    (fluid contrib float16 rewrite analog). Thread-local: another
    thread's programs keep their own setting."""
    prev = getattr(_tls, "amp_dtype", None)
    _tls.amp_dtype = dtype
    try:
        yield
    finally:
        _tls.amp_dtype = prev


def cast_compute(compute_dtype, *tensors):
    """Cast matmul operands to ``compute_dtype``; integer tensors pass
    through. Returns one tensor for one argument, else a tuple."""
    cd = convert_dtype(compute_dtype)
    out = tuple(t.to(cd) if torch.is_floating_point(t) else t for t in tensors)
    return out if len(out) > 1 else out[0]


def _ctx() -> BuildContext:
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        raise EnforceError(
            "No build context active: layer functions must run inside "
            "Program.init/apply (pt.build(fn)) — the program_guard analog.")
    return ctx


def current_context() -> Optional[BuildContext]:
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def _use_ctx(ctx: BuildContext):
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev


@contextlib.contextmanager
def reuse_names():
    """Replay the unique-name counters on exit, so a block of layer calls
    run again resolves to the SAME parameter names (the ParamAttr-name /
    while_op sub-block variable-reuse analog)."""
    ctx = _ctx()
    snapshot = dict(ctx.namer.ids)
    try:
        yield
    finally:
        ctx.namer.ids.clear()
        ctx.namer.ids.update(snapshot)


@contextlib.contextmanager
def name_scope(name: str):
    """Hierarchical naming scope (fluid.name_scope analog)."""
    ctx = _ctx()
    ctx.name_stack.append(name)
    try:
        yield
    finally:
        ctx.name_stack.pop()


def in_training() -> bool:
    ctx = current_context()
    return bool(ctx and ctx.training)


def current_device(device=None) -> torch.device:
    """Where a creation op puts its tensor: ``device`` when given, else the
    running program's device, else the CUDA card
    (:func:`core.place.default_device`)."""
    if device is None and current_context() is not None:
        return current_context().device
    return default_device(device, "a creation op outside a program")


def next_rng_key() -> torch.Generator:
    """The generator the running program's random ops draw from."""
    return _ctx().next_rng_key()


def seeded_generator(seed: int, device) -> torch.Generator:
    """A generator seeded with ``seed``, for an op given its own seed: a
    side generator of the running program's stream when it runs on
    ``device`` (a captured step can set it before each replay), else a
    new generator on ``device``."""
    ctx = current_context()
    device = torch.device(device)
    if ctx is not None and ctx.stream is not None and ctx.stream.device == device:
        return ctx.stream.generator(ctx.stream.seeded(seed))
    return torch.Generator(device=device).manual_seed(int(seed))


@contextlib.contextmanager
def rng_fold(tag: int):
    """The JAX package folds ``tag`` into its rng for the block, so a body
    traced once and run once per layer draws other numbers in each. The
    port runs the body again for each layer, and its :class:`RngStream`
    advances at every draw, so each layer already draws other numbers:
    the block runs as it is (kept for the JAX package's API)."""
    yield


@contextlib.contextmanager
def rng_scope(key: Optional[int]):
    """REPLACE the running program's rng with ``key`` for the block: its
    draws come from a generator seeded with ``key``. No-op when ``key``
    is None or no program is active."""
    ctx = current_context()
    if ctx is None or key is None:
        yield
        return
    old = ctx.stream, ctx.gen_index, ctx.rng
    if ctx.stream is None:
        ctx.stream, ctx.gen_index = RngStream(ctx.device).reset(int(key)), None
    else:
        ctx.gen_index = ctx.stream.seeded(key)
    ctx.rng = int(key)
    try:
        yield
    finally:
        ctx.stream, ctx.gen_index, ctx.rng = old


@contextlib.contextmanager
def rng_derived(tag: int):
    """Draw the block's random numbers from a side generator seeded from
    the running program's seed and ``tag`` (:meth:`RngStream.derived`):
    the JAX package's ``rng_scope(fold_in(key, tag))`` inside a pipeline
    schedule, where each (layer, microbatch, data shard) has its own key.
    Deterministic for a step's seed and different for another seed, eager
    or captured. No-op when no program with an rng runs."""
    ctx = current_context()
    if ctx is None or ctx.stream is None:
        yield
        return
    old = ctx.gen_index
    ctx.gen_index = ctx.stream.derived(tag)
    try:
        yield
    finally:
        ctx.gen_index = old


# --------------------------------------------------------------------------
# Parameter / variable creation — the LayerHelper primitives
# --------------------------------------------------------------------------


def create_parameter(shape, dtype=None, name: Optional[str] = None, attr: Any = None,
                     initializer: Optional[Any] = None,
                     is_distributed: bool = False) -> torch.Tensor:
    """Create-or-fetch a named parameter (LayerHelper.create_parameter
    analog). In init mode runs the initializer; in apply mode fetches
    from the scope."""
    from . import initializer as _init_mod  # local import to avoid cycle

    ctx = _ctx()
    attr = ParamAttr.to_attr(attr)
    shape = tuple(int(s) for s in shape)
    dtype = convert_dtype(dtype) if dtype is not None else DEFAULT_DTYPE
    full = attr.name or ctx.full_name(name or "param")

    if ctx.mode == "init" and full not in ctx.params:
        init_fn = attr.initializer or initializer or _init_mod.Xavier()
        ctx.params[full] = init_fn(ctx.param_rng_key(full), shape, dtype).to(ctx.device)
        ctx.param_info[full] = ParamInfo(
            shape=shape, dtype=dtype, trainable=attr.trainable,
            learning_rate=attr.learning_rate, regularizer=attr.regularizer,
            is_distributed=is_distributed)
    if full not in ctx.params:
        raise NotFoundError(
            f"Parameter {full!r} not found in scope (have: {sorted(ctx.params)[:20]}...)")
    p = ctx.params[full]
    info = ctx.param_info.get(full)
    if info is not None and not info.trainable:
        p = p.detach()
    if isinstance(attr, WeightNormParamAttr):
        p = _weight_norm_reparam(p, attr, full, ctx)
    return p


def create_variable(shape, dtype=None, name: Optional[str] = None,
                    initializer: Optional[Any] = None) -> torch.Tensor:
    """Create-or-fetch non-trainable persistable state (e.g. BN moving
    mean — the reference's persistable non-parameter vars)."""
    from . import initializer as _init_mod

    ctx = _ctx()
    shape = tuple(int(s) for s in shape)
    dtype = convert_dtype(dtype) if dtype is not None else DEFAULT_DTYPE
    full = ctx.full_name(name or "var")
    if ctx.mode == "init" and full not in ctx.state:
        init_fn = initializer or _init_mod.Constant(0.0)
        ctx.state[full] = init_fn(ctx.param_rng_key(full), shape, dtype).to(ctx.device)
    if full in ctx.new_state:
        return ctx.new_state[full]
    if full not in ctx.state:
        raise NotFoundError(f"State variable {full!r} not found in scope.")
    return ctx.state[full]


def assign_variable(name_suffix_or_full: str, value: torch.Tensor, full: bool = False) -> None:
    """Functional write to a state variable; the new value is returned
    from apply() as part of new_state."""
    ctx = _ctx()
    full_name = name_suffix_or_full if full else ctx.full_name(name_suffix_or_full)
    ctx.new_state[full_name] = value


class LayerHelper:
    """Names a layer instance and scopes its parameters (layer_helper.py
    analog): each call site gets a unique instance name ("fc_0");
    parameters created under it are "fc_0/w" etc."""

    def __init__(self, layer_type: str, name: Optional[str] = None):
        ctx = _ctx()
        self.name = name or ctx.unique_name(layer_type)

    def scope(self):
        return name_scope(self.name)

    def create_parameter(self, suffix: str, shape, dtype=None, attr=None, initializer=None,
                         is_distributed: bool = False) -> torch.Tensor:
        with self.scope():
            return create_parameter(shape, dtype=dtype, name=suffix, attr=attr,
                                    initializer=initializer,
                                    is_distributed=is_distributed)

    def create_variable(self, suffix: str, shape, dtype=None, initializer=None) -> torch.Tensor:
        with self.scope():
            return create_variable(shape, dtype=dtype, name=suffix, initializer=initializer)

    def assign_variable(self, suffix: str, value: torch.Tensor) -> None:
        with self.scope():
            assign_variable(suffix, value)


# --------------------------------------------------------------------------
# Program — build/init/apply
# --------------------------------------------------------------------------


def _first_device(*trees) -> Optional[torch.device]:
    for tree in trees:
        values = tree.values() if isinstance(tree, dict) else tree
        for v in values:
            if isinstance(v, torch.Tensor):
                return v.device
    return None


def _run_device(place, what: str, *trees) -> torch.device:
    """Where a program runs: ``place`` when given, else the first tensor's
    device among ``trees``, else the CUDA card (never a quiet CPU)."""
    if place is not None:
        return default_device(place, what)
    return _first_device(*trees) or default_device(None, what)


def _as_input(x, device: torch.device):
    """A feed value as a tensor on ``device``; anything else passes."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x)).to(device)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return x


class Program:
    """A program built from a function: the ProgramDesc analog.

    ``fn`` is a Python function of tensor inputs that uses the port's
    layers; running it under init/apply creates / consumes the parameter
    scope. ``param_info`` (filled by init) carries the per-parameter
    attributes the optimizer consults."""

    def __init__(self, fn: Callable, name: Optional[str] = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "program")
        self.param_info: Dict[str, ParamInfo] = {}
        # the layout in force when the program is built is the one every
        # run of it sees (a layout_mode active at run time does not leak in)
        self.layout = current_layout()

    def init(self, rng: Optional[int], *args, place=None, **kwargs) -> Tuple[Params, State]:
        """Run the startup program: run ``fn`` once on the example inputs
        under ``torch.no_grad`` and create the params and state.

        ``rng`` is the seed (None: the ``seed`` flag). The program runs on
        ``place`` when given, else on the device of the first tensor among
        the inputs, else on the CUDA card; every input goes there."""
        device = _run_device(place, "Program.init", args, kwargs)
        params: Params = {}
        state: State = {}
        self.param_info = {}
        ctx = BuildContext("init", params, state,
                           get_flag("seed") if rng is None else int(rng),
                           training=False, param_info=self.param_info, device=device,
                           compute_dtype=_ambient_compute_dtype(), layout=self.layout)
        args = tuple(_as_input(a, device) for a in args)
        kwargs = {k: _as_input(v, device) for k, v in kwargs.items()}
        with torch.no_grad(), _use_ctx(ctx):
            self.fn(*args, **kwargs)
        return params, state

    def apply(self, params: Params, state: Optional[State], *args, training: bool = False,
              rng: Union[None, int, RngStream] = None, place=None,
              **kwargs) -> Tuple[Any, State]:
        """Run the program on ``params``. Returns (outputs, new_state).
        ``rng`` (an int seed, or a :class:`RngStream` seeded by the
        caller) is what its random ops draw from.

        The program runs on ``place`` when given, else on the device of
        the first tensor among the params and inputs, else on the CUDA
        card; the inputs go there (numpy ones as tensors)."""
        device = _run_device(place, "Program.apply", params, args, kwargs)
        args = tuple(_as_input(a, device) for a in args)
        kwargs = {k: _as_input(v, device) for k, v in kwargs.items()}
        ctx = BuildContext("apply", params, state or {}, rng, training,
                           dict(self.param_info), device, _ambient_compute_dtype(),
                           self.layout)
        with _use_ctx(ctx):
            out = self.fn(*args, **kwargs)
        new_state = dict(ctx.state)
        new_state.update(ctx.new_state)
        return out, new_state

    def desc(self, *args, **kwargs):
        raise NotYetPorted("Program.desc: the JAX package returns a jaxpr; the "
                           "port's graph form comes with the analysis slice "
                           "(ROADMAP queue 1, item 25)")

    desc_flat = desc


def build(fn: Callable, name: Optional[str] = None) -> Program:
    """Wrap a layer-composition function into a Program."""
    return Program(fn, name=name)


def params_from_jax(flat: Dict[str, Any], param_info: Optional[Dict[str, ParamInfo]] = None,
                    device=None) -> Params:
    """The JAX package's flat params or state (``{name: numpy array}``, e.g.
    from its ``Program.init``) as torch tensors on ``device`` (the CUDA
    card by default), with the same names, shapes and dtypes. bfloat16
    arrays (ml_dtypes) travel through their 16-bit pattern, so no value is
    rounded. With ``param_info`` (a port Program's), the names, shapes and
    dtypes are checked against it."""
    dev = default_device(device, "params_from_jax")
    out = {}
    for name, a in flat.items():
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()) \
                .view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        out[name] = t.to(dev)
    if param_info is not None:
        check_params(out, param_info, "params_from_jax")
    return out


def check_params(params: Params, param_info: Dict[str, ParamInfo], what: str) -> None:
    """Raise unless ``params`` holds exactly the params of ``param_info``,
    each with its shape and dtype."""
    missing = sorted(set(param_info) - set(params))
    extra = sorted(set(params) - set(param_info))
    enforce(not missing and not extra,
            f"{what}: missing params {missing}, params not in the program {extra}")
    for name, info in param_info.items():
        t = params[name]
        enforce(tuple(t.shape) == tuple(info.shape) and t.dtype == info.dtype,
                f"{what}: {name} is {tuple(t.shape)} {t.dtype}, the program has "
                f"{tuple(info.shape)} {info.dtype}")


# --------------------------------------------------------------------------
# ambient switches: layout, remat, pipeline, sequence parallelism
# --------------------------------------------------------------------------

_layout_mode = threading.local()


@contextlib.contextmanager
def layout_mode(data_format: str = "NHWC"):
    """Image-layout switch: conv/pool/BN layers whose ``data_format`` is
    left unspecified follow it. Under "NHWC" images are logically
    ``[b, H, W, C]`` and reach cuDNN as channels-last views (see
    ``layers.nn``). Inside a running program it sets the program run's
    layout (its context's); outside, this thread's default for programs
    built in the block."""
    enforce(data_format in ("NCHW", "NHWC"), f"layout_mode({data_format!r})")
    holder = current_context() or _layout_mode
    old = getattr(holder, "layout", None)
    holder.layout = data_format
    try:
        yield
    finally:
        holder.layout = old


def current_layout(explicit=None) -> str:
    """Resolve a layer's data_format: explicit argument wins, then the
    running program's layout (recorded on its context), then the ambient
    :func:`layout_mode`, then the reference default NCHW."""
    if explicit is not None:
        return explicit
    ctx = current_context()
    if ctx is not None:
        return ctx.layout
    return getattr(_layout_mode, "layout", None) or "NCHW"


_remat_mode = threading.local()

_aten = torch.ops.aten
# the matrix products a policy may keep: torch.matmul reaches mm/addmm
# for a product with no batch dimensions (a [.., d] activation times a
# [d, e] weight is folded to 2-D) and bmm/baddbmm for one with them
_PRODUCTS_NO_BATCH = frozenset((_aten.mm.default, _aten.addmm.default))
_PRODUCTS_BATCH = frozenset((_aten.bmm.default, _aten.baddbmm.default))


def _saving(ops):
    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in ops else CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def nothing_saveable(ctx, op, *args, **kwargs):
    """Keep nothing inside the block: full recompute (also what policy
    None gives)."""
    return CheckpointPolicy.PREFER_RECOMPUTE


def everything_saveable(ctx, op, *args, **kwargs):
    """Keep everything: :func:`maybe_remat` then runs the block as it is,
    with no checkpoint at all."""
    return CheckpointPolicy.MUST_SAVE


dots_saveable = _saving(_PRODUCTS_NO_BATCH | _PRODUCTS_BATCH)
dots_saveable.__doc__ = "Keep the output of every matrix product."
dots_with_no_batch_dims_saveable = _saving(_PRODUCTS_NO_BATCH)
dots_with_no_batch_dims_saveable.__doc__ = ("Keep the output of the matrix products "
                                            "with no batch dimensions (mm, addmm).")

_REMAT_POLICIES = {
    "nothing": nothing_saveable,
    "everything": everything_saveable,
    "dots": dots_saveable,
    "dots_no_batch": dots_with_no_batch_dims_saveable,
}


def resolve_remat_policy(policy):
    """A policy name as the selective-checkpoint policy it stands for
    (``torch.utils.checkpoint``'s ``(ctx, op, *args, **kwargs) ->
    CheckpointPolicy``, the analog of ``jax.checkpoint_policies``); a
    callable passes through, None is full recompute. The ops a policy
    sees are those the block dispatches: the flash kernels launch from
    inside their ``autograd.Function`` into ``torch.empty`` outputs, so no
    policy keeps them and a recomputed block launches them again (the
    Pallas call is no ``dot_general`` to ``jax.checkpoint`` either)."""
    if policy is None or callable(policy):
        return policy
    enforce(policy in _REMAT_POLICIES,
            f"unknown remat policy {policy!r}; options: {sorted(_REMAT_POLICIES)}"
            " or a torch.utils.checkpoint selective-checkpoint policy callable")
    return _REMAT_POLICIES[policy]


@contextlib.contextmanager
def remat_mode(enabled: bool = True, policy=None):
    """Ambient rematerialization switch (memory_optimization_transpiler
    analog): blocks wrapped in :func:`maybe_remat` keep only their inputs
    (and what ``policy`` keeps, a name of :func:`resolve_remat_policy` or
    a callable) and recompute the rest in the backward
    (``torch.utils.checkpoint``). ``Trainer`` enters it when
    ``DistStrategy.remat`` is set."""
    resolved = resolve_remat_policy(policy)  # may raise: before any write
    old = (getattr(_remat_mode, "on", False), getattr(_remat_mode, "policy", None))
    _remat_mode.on, _remat_mode.policy = bool(enabled), resolved
    try:
        yield
    finally:
        _remat_mode.on, _remat_mode.policy = old


def remat_enabled() -> bool:
    return getattr(_remat_mode, "on", False)


def remat_policy():
    return getattr(_remat_mode, "policy", None)


def maybe_remat(fn: Callable, enabled: Optional[bool] = None, policy=None) -> Callable:
    """Wrap ``fn`` in ``torch.utils.checkpoint`` when remat is requested —
    explicitly (``enabled=True``) or ambiently (``enabled=None`` and
    :func:`remat_enabled`). Never wraps during init. ``policy`` (else the
    ambient :func:`remat_policy`) chooses what the block keeps: None and
    ``"nothing"`` recompute it whole, ``"everything"`` keeps it whole (no
    checkpoint), other policies run as selective checkpointing
    (``create_selective_checkpoint_contexts``).

    The backward's recompute runs ``fn`` again with the context's name
    counters, name stack and layout as they were when the forward entered
    it, and draws from a side generator of the run's :class:`RngStream`
    set at the state the forward's draws started from
    (:meth:`RngStream.fork`), so it fetches the same parameters, draws
    the same random numbers and lays out its images the same way, on
    whichever thread autograd runs it, eagerly or in a captured step.
    The process-wide generators are not stashed (``preserve_rng_state``
    off): the port draws from its streams only, and a captured step
    could not read them."""
    ctx = current_context()
    if ctx is not None and ctx.mode == "init":
        return fn
    if not (enabled or (enabled is None and remat_enabled())):
        return fn
    policy = resolve_remat_policy(policy) or remat_policy()
    if policy is everything_saveable:
        return fn
    context_fn = noop_context_fn if policy in (None, nothing_saveable) else \
        functools.partial(create_selective_checkpoint_contexts, policy)

    def run(*args, **kwargs):
        ctx = current_context()
        if ctx is None:
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                              context_fn=context_fn, **kwargs)
        fork = None if ctx.stream is None else ctx.stream.fork(ctx.gen_index)
        start = (dict(ctx.namer.ids), list(ctx.name_stack), ctx.layout)
        after = {}

        def replay(*a, **kw):
            # the first call is the forward, which draws on from the run's
            # generator; a later one is the recompute, which draws from
            # the fork
            saved = (dict(ctx.namer.ids), ctx.name_stack, ctx.layout, ctx.gen_index)
            ctx.namer.ids.clear()
            ctx.namer.ids.update(start[0])
            ctx.name_stack = list(start[1])
            ctx.layout = start[2]
            if "names" in after:
                ctx.gen_index = fork
            try:
                with _use_ctx(ctx):
                    out = fn(*a, **kw)
                after.setdefault("names", dict(ctx.namer.ids))
                return out
            finally:
                ctx.namer.ids.clear()
                ctx.namer.ids.update(saved[0])
                ctx.name_stack, ctx.layout, ctx.gen_index = saved[1:]

        out = checkpoint(replay, *args, use_reentrant=False, preserve_rng_state=False,
                         context_fn=context_fn, **kwargs)
        ctx.namer.ids.clear()
        ctx.namer.ids.update(after["names"])
        return out

    return run


_pipeline_mode = threading.local()


@contextlib.contextmanager
def pipeline_mode(mesh, microbatches: int, axis: str = "pp", interleave: int = 1,
                  param_layout: str = "stacked"):
    """Ambient pipeline-parallel switch (framework.py:649). The Trainer
    enters it around a training forward when ``DistStrategy.
    pp_microbatches`` is set and the mesh has a ``pp`` axis larger than 1;
    ``layers.stacked.apply_stacked`` consumes it and runs
    ``parallel.pipeline.pipeline_apply`` in place of its layer loop.
    ``interleave`` > 1 selects the virtual-stage schedule;
    ``param_layout="interleaved"`` declares that the stacked rows already
    rest in the rank-major chunk order (``parallel.pipeline.
    interleave_perm``, as ``Trainer.startup`` stores them)."""
    old = getattr(_pipeline_mode, "cfg", None)
    cfg = {"mesh": mesh, "microbatches": int(microbatches), "axis": axis,
           "interleave": max(1, int(interleave)), "param_layout": param_layout,
           "consumed": False}
    _pipeline_mode.cfg = cfg
    try:
        yield cfg
    finally:
        _pipeline_mode.cfg = old


def pipeline_config() -> Optional[dict]:
    """The active pipeline context, or None. A program initialising always
    sees None: its parameters are created whole, outside any schedule."""
    ctx = current_context()
    if ctx is not None and ctx.mode == "init":
        return None
    cfg = getattr(_pipeline_mode, "cfg", None)
    if cfg is not None:
        cfg["consumed"] = True
    return cfg


_sp_mode = threading.local()


@contextlib.contextmanager
def sp_mode(mesh, axis: str = "sp", impl: str = "ring"):
    """Ambient sequence-parallel switch (framework.py:692). The Trainer
    enters it around a training forward when ``DistStrategy.
    sequence_parallel`` is set and the mesh has an ``sp`` axis; sp-aware
    models (models/gpt.py) then run their attention as ring attention
    (``impl="ring"``, zigzag layout) or as Ulysses all-to-all attention
    (``impl="ulysses"``) over that axis."""
    enforce(impl in ("ring", "ulysses"),
            f"unknown sequence-parallel impl {impl!r} (ring|ulysses)")
    enforce(mesh is not None and axis in getattr(mesh, "axis_names", ()),
            f"sp_mode needs a parallel.Mesh with an {axis!r} axis, got {mesh!r}")
    old = getattr(_sp_mode, "cfg", None)
    cfg = {"mesh": mesh, "axis": axis, "impl": impl, "consumed": False}
    _sp_mode.cfg = cfg
    try:
        yield cfg
    finally:
        _sp_mode.cfg = old


def sp_config() -> Optional[dict]:
    """The active sequence-parallel context, or None (always None while a
    program initialises, as in the JAX package)."""
    ctx = current_context()
    if ctx is not None and ctx.mode == "init":
        return None
    cfg = getattr(_sp_mode, "cfg", None)
    if cfg is not None:
        cfg["consumed"] = True
    return cfg


# --------------------------------------------------------------------------
# default-program registry (program_guard)
# --------------------------------------------------------------------------

_default_programs: List[Program] = []


def default_main_program() -> Optional[Program]:
    """The innermost program_guard program (or None outside any guard)."""
    return _default_programs[-1] if _default_programs else None


def default_startup_program() -> Optional[Program]:
    """Startup = the init run of the same Program."""
    return default_main_program()


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Optional[Program] = None):
    """framework.py program_guard analog."""
    _default_programs.append(main_program)
    try:
        yield main_program
    finally:
        _default_programs.pop()


class WeightNormParamAttr(ParamAttr):
    """param_attr.py WeightNormParamAttr: weight-norm reparameterization
    w = g·v/‖v‖ along ``dim``. create_parameter returns the
    reparameterized weight; the stored trainables are v (under the
    layer's name) and g ("<name>@wn_g", initialised to ‖v_init‖ so the
    first forward equals the plain init)."""

    def __init__(self, dim: Optional[int] = None, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim


def _weight_norm_reparam(p: torch.Tensor, attr: WeightNormParamAttr, full: str,
                         ctx: BuildContext) -> torch.Tensor:
    # dim=None: the norm over ALL axes (a scalar g); an integer dim keeps
    # one g per slice along it
    dim = attr.dim
    shape = [1] * p.dim()
    if dim is None:
        axes = tuple(range(p.dim()))
    else:
        axes = tuple(a for a in range(p.dim()) if a != dim)
        shape[dim] = p.shape[dim]
    gname = full + "@wn_g"
    sq = p * p
    norm = torch.sqrt((sq.sum(dim=axes) if axes else sq) + 1e-12)
    if ctx.mode == "init" and gname not in ctx.params:
        ctx.params[gname] = norm.clone()
        ctx.param_info[gname] = ParamInfo(
            shape=tuple(norm.shape), dtype=norm.dtype, trainable=attr.trainable,
            learning_rate=attr.learning_rate, regularizer=None, is_distributed=False)
    g = ctx.params[gname]
    return p / norm.reshape(shape) * g.reshape(shape)


__all__ = [
    "BuildContext", "LayerHelper", "ParamAttr", "ParamInfo", "Program",
    "WeightNormParamAttr", "amp_guard", "assign_variable", "build", "cast_compute",
    "check_params", "compute_dtype", "create_parameter", "create_variable",
    "current_context", "current_device", "current_layout", "default_main_program",
    "default_startup_program", "in_training", "layout_mode", "maybe_remat",
    "RngStream", "as_stream", "name_scope", "next_rng_key", "params_from_jax",
    "pipeline_config", "pipeline_mode", "program_guard", "remat_enabled", "remat_mode", "remat_policy",
    "resolve_remat_policy", "reuse_names", "rng_derived", "rng_fold", "rng_scope",
    "seeded_generator",
    "sp_config", "sp_mode",
]
