"""Optimizers (counterpart of ``paddle_tpu.optimizer``): the base class,
SGD, Adam and AdamW.

Each optimizer is the JAX package's pure transform over dicts of tensors
keyed by parameter name: ``init(params) -> opt_state`` builds the
accumulators and ``update(grads, opt_state, params, param_info) ->
(new_params, new_opt_state)`` computes the step. The state keeps the JAX
layout, ``{"step", "global": {...}, "accums": {name: {slot: tensor}}}``,
so it moves between the packages leaf by leaf. ``update`` runs the JAX
package's order: regularization (a parameter's own regularizer wins over
the optimizer's), clipping, the per-parameter learning-rate multiplier,
and no update for a parameter without a grad or not trainable. The update
math runs in f32 and each new param is cast back to its param's dtype.
``Trainer.step`` writes the new values into the parameters in place.

Not carried yet: a reduced ``state_dtype`` (raises :class:`NotYetPorted`);
Momentum comes with the ResNet slice, Adagrad and the rest with the
slices whose models use them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .core.errors import NotYetPorted, enforce

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
        enforce(regularization is None or callable(getattr(regularization, "apply", None)),
                f"regularization={regularization!r}: expected a regularizer with "
                "apply(param, grad), e.g. regularizer.L2Decay")
        enforce(grad_clip is None or callable(grad_clip),
                f"grad_clip={grad_clip!r}: expected a clip such as "
                "clip.GradientClipByGlobalNorm")
        self._lr = learning_rate
        self.regularization = regularization
        self.grad_clip = grad_clip
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

    def update(self, grads: Grads, opt_state: OptState, params: Params,
               param_info: Optional[Dict[str, Any]] = None) -> Tuple[Params, OptState]:
        """One step: (new_params, new_opt_state). A param whose grad is
        None, or whose ``param_info`` says it is not trainable, keeps its
        value and accumulators. Bias corrections read the global state
        from before this step's update."""
        param_info = param_info or {}
        step = opt_state["step"]
        lr = self.learning_rate(step)

        # 1. regularization: the param's own regularizer wins
        reg_grads: Grads = {}
        for k, g in grads.items():
            info = param_info.get(k)
            reg = (info.regularizer if info is not None and info.regularizer is not None
                   else self.regularization)
            if reg is not None and g is not None:
                g = reg.apply(params[k], g)
            reg_grads[k] = g

        # 2. clipping, over the grads there are
        if self.grad_clip is not None:
            reg_grads.update(self.grad_clip(
                {k: g for k, g in reg_grads.items() if g is not None}, params))

        # 3. per-param updates at the per-param rate
        new_state: OptState = {"step": step + 1,
                               "global": self._update_global(opt_state["global"]),
                               "accums": {}}
        new_params: Params = {}
        state_for_param = {"step": step, "global": opt_state["global"]}
        for k, p in params.items():
            g = reg_grads.get(k)
            info = param_info.get(k)
            if g is None or (info is not None and not info.trainable):
                new_params[k] = p
                new_state["accums"][k] = opt_state["accums"][k]
                continue
            plr = lr * (info.learning_rate if info is not None else 1.0)
            np_, nacc = self._apply_dense(plr, p, g.float(), opt_state["accums"][k],
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
