"""Optimizers (counterpart of ``paddle_tpu.optimizer``): the base class,
SGD, Adam and AdamW.

Each optimizer is the JAX package's pure transform over dicts of tensors
keyed by parameter name: ``init(params) -> opt_state`` builds the
accumulators and ``update(grads, opt_state, params) -> (new_params,
new_opt_state)`` computes the step. The state keeps the JAX layout,
``{"step", "global": {...}, "accums": {name: {slot: tensor}}}``, so it
moves between the packages leaf by leaf. The update math runs in f32 and
each new param is cast back to its param's dtype. ``Trainer.step`` writes
the new values into the module's parameters in place.

Not carried yet, each raising :class:`NotYetPorted` unless left at its
default: regularization, gradient clipping and a reduced ``state_dtype``
(ROADMAP queue 1, item 6). Momentum, Adagrad and the rest come with the
slices whose models use them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .core.errors import NotYetPorted

Params = Dict[str, torch.Tensor]
Grads = Dict[str, Optional[torch.Tensor]]
OptState = Dict[str, Any]


def _f32(x, device) -> torch.Tensor:
    """x as a 0-d f32 tensor on ``device``; a Python number is filled in
    on the device (no host-to-device copy, which would wait on the
    stream)."""
    if isinstance(x, (int, float)):
        return torch.full((), x, dtype=torch.float32, device=device)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class Optimizer:
    """Base optimizer (optimizer.py:33). Subclasses define
    ``_create_accumulators``, ``_apply_dense`` and the global-state
    hooks, as in the JAX package."""

    def __init__(self, learning_rate, regularization=None, grad_clip=None,
                 name=None):
        if regularization is not None:
            raise NotYetPorted("optimizer regularization (regularizer.py: the "
                               "MNIST slice, ROADMAP queue 1 item 6)")
        if grad_clip is not None:
            raise NotYetPorted("gradient clipping (clip.py: the MNIST slice, "
                               "ROADMAP queue 1 item 6)")
        self._lr = learning_rate
        self.name = name

    def set_state_dtype(self, dtype) -> "Optimizer":
        """Accumulators stay float32: None is the only dtype so far."""
        if dtype is not None:
            raise NotYetPorted("Optimizer.set_state_dtype: reduced-precision "
                               "optimizer state (a later slice)")
        return self

    # -- subclass interface -------------------------------------------------
    def _create_accumulators(self, param: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _apply_dense(self, lr, param, grad, acc, state
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def _init_global(self, device) -> Dict[str, torch.Tensor]:
        return {}

    def _update_global(self, g: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return g

    # -- public API -----------------------------------------------------------
    def init(self, params: Params) -> OptState:
        device = next(iter(params.values())).device if params else None
        return {
            "step": torch.zeros((), dtype=torch.int32, device=device),
            "global": self._init_global(device),
            "accums": {k: self._create_accumulators(v) for k, v in params.items()},
        }

    def learning_rate(self, step: torch.Tensor) -> torch.Tensor:
        """The rate at ``step`` (a 0-d int32 tensor) as a 0-d f32 tensor;
        a callable rate is called with the step."""
        lr = self._lr(step) if callable(self._lr) else self._lr
        return _f32(lr, step.device)

    def update(self, grads: Grads, opt_state: OptState, params: Params
               ) -> Tuple[Params, OptState]:
        """One step: (new_params, new_opt_state). A param whose grad is
        None keeps its value and accumulators. Bias corrections read the
        global state from before this step's update."""
        step = opt_state["step"]
        lr = self.learning_rate(step)
        new_state: OptState = {"step": step + 1,
                               "global": self._update_global(opt_state["global"]),
                               "accums": {}}
        new_params: Params = {}
        state_for_param = {"step": step, "global": opt_state["global"]}
        for k, p in params.items():
            g = grads.get(k)
            if g is None:
                new_params[k] = p
                new_state["accums"][k] = opt_state["accums"][k]
                continue
            np_, nacc = self._apply_dense(lr, p, g.float(), opt_state["accums"][k],
                                          state_for_param)
            new_params[k] = np_.to(p.dtype)
            new_state["accums"][k] = nacc
        return new_params, new_state


class SGD(Optimizer):
    """SGDOptimizer (optimizer.py:177)."""

    def _apply_dense(self, lr, p, g, acc, state):
        return p.float() - lr * g, acc


class Adam(Optimizer):
    """AdamOptimizer (optimizer.py:248): bias correction through the
    global beta1^t / beta2^t accumulators, as in the reference."""

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 lazy_mode: bool = False, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _init_global(self, device):
        return {"beta1_pow": _f32(self.beta1, device),
                "beta2_pow": _f32(self.beta2, device)}

    def _update_global(self, g):
        return {"beta1_pow": g["beta1_pow"] * self.beta1,
                "beta2_pow": g["beta2_pow"] * self.beta2}

    def _create_accumulators(self, p):
        return {"moment1": torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                "moment2": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}

    def _apply_dense(self, lr, p, g, acc, state):
        b1p = state["global"]["beta1_pow"]
        b2p = state["global"]["beta2_pow"]
        m1 = self.beta1 * acc["moment1"] + (1 - self.beta1) * g
        m2 = self.beta2 * acc["moment2"] + (1 - self.beta2) * g * g
        lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
        p = p.float() - lr_t * m1 / (torch.sqrt(m2) + self.epsilon)
        return p, {"moment1": m1, "moment2": m2}


class AdamW(Adam):
    """Adam with decoupled weight decay (optimizer.py:279): the decay is
    applied to the param directly, not through the grad."""

    def __init__(self, learning_rate=0.001, weight_decay: float = 0.01, **kw):
        super().__init__(learning_rate, **kw)
        self.weight_decay = weight_decay

    def _apply_dense(self, lr, p, g, acc, state):
        p2, nacc = super()._apply_dense(lr, p, g, acc, state)
        return p2 - lr * self.weight_decay * p.float(), nacc


__all__ = ["Adam", "AdamW", "Optimizer", "SGD"]
