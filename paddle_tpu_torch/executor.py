"""Executor, Trainer and fit (counterpart of ``paddle_tpu.executor``).

The JAX package jit-compiles ``Program.apply`` (Executor.run) and
value_and_grad plus the optimizer update (Trainer.step) into one donated
program each. PyTorch runs eagerly, so here a run is the program's
forward under ``torch.no_grad``, and a step is the forward, ``backward()``
and the optimizer's pure update, whose results are copied into the
parameters in place (the analog of buffer donation). The grads of the
last step stay on the parameters (``param.grad``) until the next step.

``Trainer`` takes a ``Program`` built by :func:`framework.build` — its
params and state live in ``trainer.scope`` under their JAX names — or an
``nn.Module`` whose ``forward(**feed)`` returns a dict of tensors and
which owns its params (``models.gpt.make_model``). ``fit`` drives a
Trainer from a reader: DataFeeder → DeviceFeeder (the prefetch on the
card) or a plain put → ``step``, with the JAX package's events.

Not carried yet, each raising :class:`NotYetPorted` with the slice that
brings it: meshes and sharding rules, ``DistStrategy`` (pipeline,
sequence parallelism, loss scaling, ZeRO), the NaN/Inf guard policy (the
``check_nan_inf`` flag is honoured), feed wire formats, on-device
augmentation, ``run_steps`` and fit's fused steps, checkpoints and
resume, elastic resizes, preemption, the HBM dataset cache and interval
profile events.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from .core.config import get_flag
from .core.errors import NotYetPorted, enforce
from .core.place import default_device
from .framework import Program, check_params
from .initializer import mix_seed

Feed = Dict[str, Any]


class Scope:
    """Name→value runtime store (scope.h:41 analog). ``params`` are the
    program's parameters themselves, under their JAX names."""

    def __init__(self):
        self.params: Dict[str, torch.Tensor] = {}
        self.state: Dict[str, torch.Tensor] = {}
        self.opt_state: Optional[Dict[str, Any]] = None



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
    """FLAGS_check_nan_inf analog: raise if a floating tensor of ``tree``
    holds a NaN or an Inf. Reads one flag back from the device: the only
    host sync a step may make, and only when the flag is on."""
    flags = [torch.isfinite(t).all() for t in _floating(tree)]
    if flags and not bool(torch.stack(flags).all()):
        raise FloatingPointError(f"NaN/Inf detected in {where} (FLAGS_check_nan_inf analog)")


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree


def _put(value, device: torch.device) -> torch.Tensor:
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(np.ascontiguousarray(value))
    return torch.as_tensor(value).to(device, non_blocking=True)


class Executor:
    """Forward/eval executor with a held scope (executor.py:256 analog).

    ``place`` is where it runs: the CUDA card unless the caller passes
    ``CPUPlace()`` (no card: :class:`NoCudaDevice`)."""

    def __init__(self, place=None):
        self.device = default_device(place, "Executor")
        self.place = self.device
        self.scope = Scope()

    def startup(self, program: Program, seed: Optional[int] = None, *example_args,
                **example_kwargs) -> Scope:
        """Run the startup program on the example inputs (on this
        executor's device): initialise params and state into the scope.
        ``seed`` None takes the ``seed`` flag."""
        args = [_put(a, self.device) for a in example_args]
        kwargs = {k: _put(v, self.device) for k, v in example_kwargs.items()}
        params, state = program.init(seed, *args, place=self.device, **kwargs)
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
    """Eager train loop on one device: forward, backward and the optimizer
    update per :meth:`step`.

    ``program`` is a :class:`framework.Program` or an ``nn.Module`` (see
    the module docstring). ``place`` (the JAX package's argument) or
    ``device`` is where it runs: the CUDA card unless the caller passes
    the CPU (no card: :class:`NoCudaDevice`). ``fetch_list`` prunes what
    ``step`` returns to those outputs and the loss."""

    def __init__(self, program, optimizer, loss_name: str = "loss", place=None,
                 mesh=None, sharding_rules=None, strategy=None,
                 fetch_list: Optional[Sequence[str]] = None, guard=None, feed_wire=None,
                 augment=None, device=None):
        unported = {"mesh": mesh, "sharding_rules": sharding_rules,
                    "strategy": strategy, "feed_wire": feed_wire,
                    "augment": augment}
        if guard:  # None and False both mean no guard
            unported["guard"] = guard
        for name, value in unported.items():
            if value is not None:
                raise NotYetPorted(f"Trainer({name}=...): a later slice "
                                   "(ROADMAP queue 1)")
        if place is not None and device is not None:
            enforce(torch.device(place) == torch.device(device),
                    f"Trainer(place={place}, device={device}): two devices")
        self.device = default_device(device if device is not None else place, "Trainer")
        self.place = self.device
        self.is_program = isinstance(program, Program)
        self.program = program if self.is_program else program.to(self.device)
        self.optimizer = optimizer
        self.loss_name = loss_name
        self.fetch_list = list(fetch_list) if fetch_list is not None else None
        self.scope = Scope()
        self.global_step = 0

    # ------------------------------------------------------------------
    def startup(self, seed: Optional[int] = None, sample_feed: Optional[Feed] = None,
                params: Optional[Dict[str, Any]] = None):
        """Initialise the params and build the optimizer state.

        A ``Program`` runs its init on zeros of ``sample_feed``'s shapes
        and dtypes on this trainer's device; an ``nn.Module`` initialises
        its own params (``init_params``; its shapes come from its config).
        ``params`` ({JAX name: tensor}, e.g. from ``params_from_jax``)
        replaces the initial values; they are copied, so training never
        writes to the caller's tensors. ``seed`` None takes the ``seed``
        flag."""
        seed = get_flag("seed") if seed is None else int(seed)
        if self.is_program:
            example = {k: torch.zeros_like(_put(v, "cpu"), device=self.device)
                       for k, v in (sample_feed or {}).items()}
            fresh, state = self.program.init(seed, place=self.device, **example)
            if params is not None:
                check_params(params, self.program.param_info, "Trainer.startup(params=)")
                fresh = {k: params[k].detach().to(self.device, copy=True) for k in fresh}
            for p in fresh.values():
                p.requires_grad_(p.is_floating_point())
            self.scope.params, self.scope.state = fresh, state
        else:
            if params is not None:
                self.program.load_params(params)
            else:
                self.program.init_params(seed)
            self.scope.params = self.program.flat_params()
        with torch.no_grad():
            self.scope.opt_state = self.optimizer.init(
                {k: p.detach() for k, p in self.scope.params.items()})
        self.global_step = 0
        return self

    def _put_feed(self, feed: Feed) -> Feed:
        return {k: _put(v, self.device) for k, v in feed.items()}

    def _run(self, feed: Feed, training: bool):
        """(outputs as a dict, new state) of one run of the program."""
        if self.is_program:
            # the step's rng, as the JAX package derives it (executor.py:1310)
            rng = mix_seed(get_flag("seed") + 1, self.global_step) if training else None
            out, new_state = self.program.apply(self.scope.params, self.scope.state,
                                                training=training, rng=rng,
                                                place=self.device, **feed)
        else:
            self.program.train(training)
            out, new_state = self.program(**feed), self.scope.state
        if not isinstance(out, dict):
            out = {self.loss_name: out}
        return out, new_state

    def _fetch(self, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        keys = list(out) if self.fetch_list is None else \
            list(dict.fromkeys(self.fetch_list + [self.loss_name]))
        return {k: out[k].detach() for k in keys}

    def step(self, feed: Feed) -> Dict[str, torch.Tensor]:
        """One optimization step; returns the fetched outputs, computed
        before the update. With the ``check_nan_inf`` flag a non-finite
        output or grad raises ``FloatingPointError`` before the update."""
        enforce(self.scope.opt_state is not None, "call startup() before step()")
        feed = self._put_feed(feed)
        params = self.scope.params
        for p in params.values():
            p.grad = None
        # profiler ranges (``trainer.forward`` ...): a profiled step splits
        # its device time by them; about a microsecond each when no
        # profiler runs
        with record_function("trainer.forward"):
            out, new_state = self._run(feed, training=True)
        with record_function("trainer.backward"):
            out[self.loss_name].backward()
        grads = {k: p.grad for k, p in params.items()}
        if self.is_program:
            # jax.grad gives every param a grad, zeros where the program did
            # not reach it (a frozen param is detached); its regularizer and a
            # global-norm clip see those zeros, and the update skips frozen ones
            grads = {k: torch.zeros_like(params[k]) if g is None else g
                     for k, g in grads.items()}
        if get_flag("check_nan_inf"):
            _check_nan_inf({"outputs": out, "grads": [g for g in grads.values()
                                                      if g is not None]},
                           f"step {self.global_step} of {self.loss_name!r}")
        with torch.no_grad(), record_function("trainer.update"):
            values = {k: p.detach() for k, p in params.items()}
            new_params, self.scope.opt_state = self.optimizer.update(
                grads, self.scope.opt_state, values,
                self.program.param_info if self.is_program else None)
            for k, p in values.items():
                if new_params[k] is not p:  # a param with no update keeps its value
                    p.copy_(new_params[k])
        self.scope.state = {k: v.detach() for k, v in new_state.items()}
        self.global_step += 1
        if get_flag("benchmark") and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self._fetch(out)

    def eval(self, feed: Feed) -> Dict[str, torch.Tensor]:
        """Forward pass in inference mode (no dropout), no update; returns
        every output."""
        feed = self._put_feed(feed)
        try:
            with torch.no_grad():
                out, _ = self._run(feed, training=False)
        finally:
            if not self.is_program:
                self.program.train(True)
        return {k: v.detach() for k, v in out.items()}


class Event:
    """Training events (contrib.trainer BeginEpochEvent/EndStepEvent…):
    ``kind`` is begin_epoch, begin_step, end_step or end_epoch; ``step``
    the trainer's global step when it fired; ``metrics`` the step's
    fetched outputs on end_step; ``num_steps`` the steps an event covers
    (1 until the fused-step slice)."""

    def __init__(self, kind: str, epoch: int, step: int, metrics=None,
                 num_steps: int = 1):
        self.kind = kind
        self.epoch = epoch
        self.step = step
        self.metrics = metrics or {}
        self.num_steps = num_steps


# fit's arguments of later slices: (default, the slice that brings it)
_FIT_LATER = {
    "checkpoint_config": (None, "checkpoints, ROADMAP queue 1 item 8"),
    "resume": (False, "checkpoints, ROADMAP queue 1 item 8"),
    "elastic": (False, "elastic training, ROADMAP queue 1 item 22"),
    "resize": (None, "elastic training, ROADMAP queue 1 item 22"),
    "preemption": (None, "checkpoints, ROADMAP queue 1 item 8"),
    "steps_per_dispatch": (1, "fused steps, ROADMAP queue 1 item 18"),
    "feed_wire": (None, "data extras, ROADMAP queue 1 item 23"),
    "device_cache": (None, "data extras, ROADMAP queue 1 item 23"),
    "augment": (None, "data extras, ROADMAP queue 1 item 23"),
    "profile_interval_steps": (0, "observability, ROADMAP queue 1 item 24"),
}


def fit(trainer: Trainer, reader, num_epochs: int, feed_names: Sequence[str],
        dtypes: Optional[Sequence[Any]] = None, event_handler=None,
        checkpoint_config=None, prefetch: bool = True, steps_per_dispatch: int = 1,
        resume: bool = False, elastic: bool = False, preemption: Optional[bool] = None,
        resize=None, feed_wire=None, profile_interval_steps: int = 0,
        device_cache=None, augment=None):
    """High-level train loop (contrib.trainer.Trainer.train analog):
    reader → DataFeeder → DeviceFeeder (``prefetch=True``: batches copied
    to the card on a side stream while the step runs) or a plain put →
    ``trainer.step``, with begin_epoch / begin_step / end_step / end_epoch
    events in the JAX package's order and with its step counts. A trainer
    on the CPU has nothing to prefetch to: pass ``prefetch=False`` there."""
    from .data.feeder import DataFeeder, DeviceFeeder

    given = {"checkpoint_config": checkpoint_config, "resume": resume,
             "elastic": elastic, "resize": resize, "preemption": preemption,
             "steps_per_dispatch": steps_per_dispatch, "feed_wire": feed_wire,
             "device_cache": device_cache, "augment": augment,
             "profile_interval_steps": profile_interval_steps}
    given["preemption"] = preemption or None  # False asks for nothing either
    for name, (default, later) in _FIT_LATER.items():
        if given[name] != default:
            raise NotYetPorted(f"fit({name}=...): {later}")
    feeder = DataFeeder(feed_names, dtypes)

    def batches():
        for samples in reader():
            yield feeder.feed(samples)

    def emit(*args, **kw):
        if event_handler:
            event_handler(Event(*args, **kw))

    for epoch in range(num_epochs):
        emit("begin_epoch", epoch, trainer.global_step)
        device_feeder = DeviceFeeder(batches, device=trainer.device) if prefetch else None
        feeds = iter(device_feeder) if prefetch else map(trainer._put_feed, batches())
        try:
            for feed in feeds:
                emit("begin_step", epoch, trainer.global_step)
                out = trainer.step(feed)
                emit("end_step", epoch, trainer.global_step, out)
        finally:
            # an abandoned epoch (exception, early exit) stops the fill thread
            if device_feeder is not None:
                device_feeder.close()
        emit("end_epoch", epoch, trainer.global_step)
    return trainer


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


__all__ = ["Event", "Executor", "Scope", "Trainer",
           "fit", "global_scope", "scope_guard"]
