"""Scope and the single-device Trainer (counterpart of the training half
of ``paddle_tpu.executor``).

The JAX ``Trainer`` jit-compiles value_and_grad plus the optimizer
update into one donated step program. PyTorch runs eagerly, so here a
step is the module's forward, ``loss.backward()`` and the optimizer's
pure update, whose results are copied into the module's parameters in
place (the analog of the JAX package's buffer donation). The grads of
the last step stay on the parameters (``param.grad``) until the next
step starts.

The program is an ``nn.Module`` whose ``forward(**feed)`` returns a dict
of tensors, such as ``models.gpt.make_model``'s, in place of a
``Program`` built by ``pt.build``. Not carried yet, each raising
:class:`NotYetPorted`: meshes and sharding rules, ``DistStrategy``
(pipeline, sequence parallelism, loss scaling, ZeRO), the NaN/Inf guard,
feed wire formats and on-device augmentation, ``run_steps`` and
checkpoints (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from .core.errors import NotYetPorted, enforce
from .core.place import default_device

Feed = Dict[str, Any]


class Scope:
    """Name→value runtime store (scope.h:41 analog). ``params`` are the
    program's parameters themselves, under their JAX names."""

    def __init__(self):
        self.params: Dict[str, torch.Tensor] = {}
        self.state: Dict[str, torch.Tensor] = {}
        self.opt_state: Optional[Dict[str, Any]] = None


class Trainer:
    """Eager train loop on one device: forward, backward and the
    optimizer update per :meth:`step`.

    ``device`` is where the program runs: the CUDA card unless the
    caller passes ``device="cpu"`` (no card: :class:`NoCudaDevice`). The
    program is moved there."""

    def __init__(self, program: torch.nn.Module, optimizer,
                 loss_name: str = "loss", mesh=None, sharding_rules=None,
                 strategy=None, fetch_list: Optional[Sequence[str]] = None,
                 guard=None, feed_wire=None, augment=None, device=None):
        unported = {"mesh": mesh, "sharding_rules": sharding_rules,
                    "strategy": strategy, "feed_wire": feed_wire,
                    "augment": augment}
        if guard:  # None and False both mean no guard
            unported["guard"] = guard
        for name, value in unported.items():
            if value is not None:
                raise NotYetPorted(f"Trainer({name}=...): a later slice "
                                   "(ROADMAP queue 1)")
        self.device = default_device(device, "Trainer")
        self.program = program.to(self.device)
        self.optimizer = optimizer
        self.loss_name = loss_name
        self.fetch_list = list(fetch_list) if fetch_list is not None else None
        self.scope = Scope()
        self.global_step = 0

    # ------------------------------------------------------------------
    def startup(self, seed: int = 0, sample_feed: Optional[Feed] = None,
                params: Optional[Dict[str, Any]] = None):
        """Initialise the params (``program.init_params(seed)``), or take
        carried-over ones (``params``: {JAX name: tensor}, through
        ``program.load_params``), and build the optimizer state.
        ``sample_feed`` is accepted for the JAX signature; the module's
        shapes come from its config, so it is not traced."""
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
        out = {}
        for k, v in feed.items():
            if isinstance(v, np.ndarray):
                v = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = torch.as_tensor(v).to(self.device, non_blocking=True)
        return out

    def _fetch(self, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        keys = self.fetch_list if self.fetch_list is not None else list(out)
        return {k: out[k].detach() for k in keys}

    def step(self, feed: Feed) -> Dict[str, torch.Tensor]:
        """One optimization step; returns the fetched outputs (the
        ``fetch_list`` entries, or every output), computed before the
        update."""
        enforce(self.scope.opt_state is not None, "call startup() before step()")
        feed = self._put_feed(feed)
        params = self.scope.params
        for p in params.values():
            p.grad = None
        self.program.train(True)
        # profiler ranges (``trainer.forward`` ...): a profiled step splits
        # its device time by them; about a microsecond each when no
        # profiler runs
        with record_function("trainer.forward"):
            out = self.program(**feed)
        with record_function("trainer.backward"):
            out[self.loss_name].backward()
        with torch.no_grad(), record_function("trainer.update"):
            grads = {k: p.grad for k, p in params.items()}
            values = {k: p.detach() for k, p in params.items()}
            new_params, self.scope.opt_state = self.optimizer.update(
                grads, self.scope.opt_state, values)
            for k, p in values.items():
                if new_params[k] is not p:  # a param with no grad keeps its value
                    p.copy_(new_params[k])
        self.global_step += 1
        return self._fetch(out)

    def eval(self, feed: Feed) -> Dict[str, torch.Tensor]:
        """Forward pass without dropout and without an update."""
        feed = self._put_feed(feed)
        self.program.train(False)
        try:
            with torch.no_grad():
                return self._fetch(self.program(**feed))
        finally:
            self.program.train(True)


__all__ = ["Scope", "Trainer"]
