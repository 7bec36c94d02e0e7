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
  the device nor on the order of the other layers; ``next_rng_key``
  returns a ``torch.Generator`` on the program's device, seeded from the
  key and a per-run counter.
- The compute dtype of mixed precision is recorded on the context when
  ``init``/``apply`` starts (the active :func:`amp_guard`'s dtype, else the
  ``default_compute_dtype`` flag); layers read it from there through
  :func:`compute_dtype`, never from a process global.
  :func:`cast_compute` takes it as an explicit argument, as the GPT
  modules call it.
- ``trainable=False`` detaches the parameter: its grad is None where the
  JAX package's ``stop_gradient`` gives zeros; the optimizer skips both.
- Not carried yet, each raising :class:`NotYetPorted`: ``Program.desc``
  and ``desc_flat`` (jaxprs; an FX form comes with ROADMAP queue 1 item
  25), ``pipeline_mode`` and ``sp_mode`` (the multi-GPU slice), and remat
  policies other than None.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .core import unique_name as _unique_name
from .core.config import get_flag
from .core.dtypes import convert_dtype
from .core.errors import EnforceError, NotFoundError, NotYetPorted, enforce
from .core.place import default_device
from .initializer import mix_seed, param_generator

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


class BuildContext:
    """Per-run context: parameter scope, name generator, rng, mode, the
    device and the compute dtype.

    Mode 'init' creates parameters (the startup program); mode 'apply'
    fetches them. Name generation is context-local, so the init and apply
    runs of one function agree."""

    def __init__(self, mode: str, params: Params, state: State, rng: Optional[int],
                 training: bool, param_info: Dict[str, ParamInfo],
                 device: torch.device, compute_dtype: torch.dtype):
        enforce(mode in ("init", "apply"), f"BuildContext mode {mode!r}")
        self.mode = mode
        self.params = params
        self.state = state
        self.new_state: State = {}
        self.rng = rng
        self._rng_count = 0
        self.training = training
        self.param_info = param_info
        self.device = device
        self.compute_dtype = compute_dtype
        self.namer = _unique_name.UniqueNameGenerator()
        self.name_stack: List[str] = []

    # -- naming ------------------------------------------------------------
    def unique_name(self, key: str) -> str:
        return self.namer(key)

    def full_name(self, suffix: str) -> str:
        return "/".join(self.name_stack + [suffix]) if self.name_stack else suffix

    # -- rng ---------------------------------------------------------------
    def next_rng_key(self) -> torch.Generator:
        enforce(self.rng is not None,
                "This program needs an RNG (dropout/random op) but none was "
                "passed; call apply(..., rng=seed).")
        self._rng_count += 1
        return torch.Generator(device=self.device).manual_seed(
            mix_seed(self.rng, self._rng_count))

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
    return _ctx().next_rng_key()


@contextlib.contextmanager
def rng_fold(tag: int):
    """Mix ``tag`` into the running program's rng for the block, so a body
    run once per layer draws other numbers in each. No-op when no program
    or no rng is active."""
    ctx = current_context()
    if ctx is None or ctx.rng is None:
        yield
        return
    old = ctx.rng
    ctx.rng = mix_seed(old, int(tag))
    try:
        yield
    finally:
        ctx.rng = old


@contextlib.contextmanager
def rng_scope(key: Optional[int]):
    """REPLACE the running program's rng with ``key`` for the block. No-op
    when ``key`` is None or no program is active."""
    ctx = current_context()
    if ctx is None or key is None:
        yield
        return
    old = ctx.rng
    ctx.rng = int(key)
    try:
        yield
    finally:
        ctx.rng = old


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
                           compute_dtype=_ambient_compute_dtype())
        args = tuple(_as_input(a, device) for a in args)
        kwargs = {k: _as_input(v, device) for k, v in kwargs.items()}
        with torch.no_grad(), _use_ctx(ctx), layout_mode(self.layout):
            self.fn(*args, **kwargs)
        return params, state

    def apply(self, params: Params, state: Optional[State], *args, training: bool = False,
              rng: Optional[int] = None, place=None, **kwargs) -> Tuple[Any, State]:
        """Run the program on ``params``. Returns (outputs, new_state).

        The program runs on ``place`` when given, else on the device of
        the first tensor among the params and inputs, else on the CUDA
        card; the inputs go there (numpy ones as tensors)."""
        device = _run_device(place, "Program.apply", params, args, kwargs)
        args = tuple(_as_input(a, device) for a in args)
        kwargs = {k: _as_input(v, device) for k, v in kwargs.items()}
        ctx = BuildContext("apply", params, state or {}, rng, training,
                           dict(self.param_info), device, _ambient_compute_dtype())
        with _use_ctx(ctx), layout_mode(self.layout):
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
    """Ambient image-layout switch: conv/pool/BN layers whose
    ``data_format`` is left unspecified follow it (``channels_last`` on the
    card comes with the conv slice)."""
    enforce(data_format in ("NCHW", "NHWC"), f"layout_mode({data_format!r})")
    old = getattr(_layout_mode, "fmt", None)
    _layout_mode.fmt = data_format
    try:
        yield
    finally:
        _layout_mode.fmt = old


def current_layout(explicit=None) -> str:
    """Resolve a layer's data_format: explicit argument wins, then the
    ambient :func:`layout_mode`, then the reference default NCHW."""
    if explicit is not None:
        return explicit
    return getattr(_layout_mode, "fmt", None) or "NCHW"


_remat_mode = threading.local()


def _no_remat_policy(policy):
    if policy is not None:
        raise NotYetPorted(f"remat policy {policy!r}: only full recompute "
                           "(policy=None) is ported (ROADMAP queue 1, item 17)")


@contextlib.contextmanager
def remat_mode(enabled: bool = True, policy=None):
    """Ambient rematerialization switch (memory_optimization_transpiler
    analog): blocks wrapped in :func:`maybe_remat` keep only their inputs
    and recompute the rest in the backward (``torch.utils.checkpoint``)."""
    _no_remat_policy(policy)
    old = getattr(_remat_mode, "on", False)
    _remat_mode.on = bool(enabled)
    try:
        yield
    finally:
        _remat_mode.on = old


def remat_enabled() -> bool:
    return getattr(_remat_mode, "on", False)


def maybe_remat(fn: Callable, enabled: Optional[bool] = None,
                policy: Optional[Callable] = None) -> Callable:
    """Wrap ``fn`` in ``torch.utils.checkpoint`` when remat is requested —
    explicitly (``enabled=True``) or ambiently (``enabled=None`` and
    :func:`remat_enabled`). Never wraps during init.

    The backward's recompute runs ``fn`` again with the context's name
    counters, name stack and rng counter as they were when the forward
    entered it, so it fetches the same parameters and draws the same
    random numbers."""
    _no_remat_policy(policy)
    ctx = current_context()
    if ctx is not None and ctx.mode == "init":
        return fn
    if not (enabled or (enabled is None and remat_enabled())):
        return fn

    def run(*args, **kwargs):
        ctx = current_context()
        if ctx is None:
            return checkpoint(fn, *args, use_reentrant=False, **kwargs)
        start = (dict(ctx.namer.ids), list(ctx.name_stack), ctx._rng_count)
        after = {}

        def replay(*a, **kw):
            saved = (dict(ctx.namer.ids), ctx.name_stack, ctx._rng_count)
            ctx.namer.ids.clear()
            ctx.namer.ids.update(start[0])
            ctx.name_stack, ctx._rng_count = list(start[1]), start[2]
            try:
                with _use_ctx(ctx):
                    out = fn(*a, **kw)
                after.setdefault("state", (dict(ctx.namer.ids), ctx._rng_count))
                return out
            finally:
                ctx.namer.ids.clear()
                ctx.namer.ids.update(saved[0])
                ctx.name_stack, ctx._rng_count = saved[1], saved[2]

        out = checkpoint(replay, *args, use_reentrant=False, **kwargs)
        ctx.namer.ids.clear()
        ctx.namer.ids.update(after["state"][0])
        ctx._rng_count = after["state"][1]
        return out

    return run


def pipeline_mode(mesh, microbatches: int, axis: str = "pp", interleave: int = 1,
                  param_layout: str = "stacked"):
    raise NotYetPorted("pipeline_mode: pipeline parallelism comes with the "
                       "multi-GPU slice (ROADMAP queue 1, item 21)")


def sp_mode(mesh, axis: str = "sp", impl: str = "ring"):
    raise NotYetPorted("sp_mode: sequence parallelism comes with the "
                       "multi-GPU slice (ROADMAP queue 1, item 21)")


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
    "name_scope", "next_rng_key", "params_from_jax", "pipeline_mode",
    "program_guard", "remat_enabled", "remat_mode", "reuse_names", "rng_fold",
    "rng_scope", "sp_mode",
]
