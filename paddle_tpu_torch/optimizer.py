"""Optimizers (counterpart of ``paddle_tpu.optimizer``): the base class,
SGD, Momentum, LarsMomentum, Adagrad, Adam, AdamW, Adamax,
DecayedAdagrad, Adadelta, RMSProp, Ftrl and Lamb; the parameter averages
ModelAverage and ExponentialMovingAverage; and the fluid-style aliases.

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

``set_state_dtype`` (or ``DistStrategy.opt_state_dtype``) stores the
float accumulators in a reduced dtype (bfloat16 halves their memory); the
update reads them as f32 and stores its results back in that dtype, so
only the storage precision changes. Every ``_apply_dense`` keeps the JAX
package's order of operations; the norms of LarsMomentum and Lamb are
reductions on the device, read back by nothing.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .core.dtypes import convert_dtype
from .core.errors import enforce

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

    state_dtype: Optional[torch.dtype] = None  # class default: f32 accumulators

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
        """Store float accumulators as ``dtype`` ('bfloat16', a torch or
        numpy dtype); None restores f32 (optimizer.py:72)."""
        self.state_dtype = convert_dtype(dtype)
        return self

    def _store_acc(self, acc: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.state_dtype is None:
            return acc
        return {k: v.to(self.state_dtype) if v.is_floating_point() else v
                for k, v in acc.items()}

    def _compute_acc(self, acc: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.state_dtype is None:
            return acc
        return {k: v.float() if v.is_floating_point() else v for k, v in acc.items()}

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
            "accums": {k: self._store_acc(self._create_accumulators(v))
                       for k, v in params.items()},
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
            np_, nacc = self._apply_dense(plr, p, g.float(),
                                          self._compute_acc(opt_state["accums"][k]),
                                          state_for_param)
            new_params[k] = np_.to(p.dtype)
            new_state["accums"][k] = self._store_acc(nacc)
        return new_params, new_state

    def apply_gradients(self, params: Params, grads: Grads, opt_state: OptState,
                        param_info=None) -> Tuple[Params, OptState]:
        """``update`` with the (params, grads, opt_state) argument order."""
        return self.update(grads, opt_state, params, param_info)


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """sqrt(sum(x·x)) as the JAX package writes it (not ``linalg.norm``)."""
    return torch.sqrt(torch.sum(x * x))


class SGD(Optimizer):
    """SGDOptimizer (optimizer.py:177)."""

    def _apply_dense(self, lr, p, g, acc, state):
        return p.float() - lr * g, acc


class Momentum(Optimizer):
    """MomentumOptimizer (optimizer.py:184; momentum_op): an f32
    ``velocity`` per param, ``v = momentum·v + g``, then ``p −= lr·v``, or
    ``p −= lr·(g + momentum·v)`` with ``use_nesterov``."""

    def __init__(self, learning_rate, momentum: float = 0.9, use_nesterov: bool = False,
                 **kw):
        super().__init__(learning_rate, **kw)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def _create_accumulators(self, p):
        return {"velocity": _zeros(p)}

    def _apply_dense(self, lr, p, g, acc, state):
        v = self.momentum * acc["velocity"] + g
        step = g + self.momentum * v if self.use_nesterov else v
        return p.float() - lr * step, {"velocity": v}


class LarsMomentum(Optimizer):
    """LarsMomentumOptimizer (optimizer.py:204; lars_momentum_op):
    layer-wise adaptive rate scaling. The local rate is
    ``lr·coeff·‖p‖ / (‖g‖ + wd·‖p‖ + eps)`` where both norms are positive,
    else ``lr``; ``v = momentum·v + local_lr·(g + wd·p)``, ``p −= v``."""

    def __init__(self, learning_rate, momentum: float = 0.9, lars_coeff: float = 1e-3,
                 lars_weight_decay: float = 5e-4, epsilon: float = 0.0, **kw):
        super().__init__(learning_rate, **kw)
        self.momentum = momentum
        self.lars_coeff = lars_coeff
        self.lars_weight_decay = lars_weight_decay
        self.epsilon = epsilon

    def _create_accumulators(self, p):
        return {"velocity": _zeros(p)}

    def _apply_dense(self, lr, p, g, acc, state):
        p32 = p.float()
        pn, gn = _norm(p32), _norm(g)
        local_lr = torch.where(
            (pn > 0) & (gn > 0),
            lr * self.lars_coeff * pn / (gn + self.lars_weight_decay * pn + self.epsilon),
            lr)
        v = self.momentum * acc["velocity"] + local_lr * (g + self.lars_weight_decay * p32)
        return p32 - v, {"velocity": v}


class Adagrad(Optimizer):
    """AdagradOptimizer (optimizer.py:231; adagrad_op): ``m += g²``,
    ``p −= lr·g / (√m + eps)``; the moment starts at
    ``initial_accumulator_value``."""

    def __init__(self, learning_rate, epsilon: float = 1e-6,
                 initial_accumulator_value: float = 0.0, **kw):
        super().__init__(learning_rate, **kw)
        self.epsilon = epsilon
        self.init_acc = initial_accumulator_value

    def _create_accumulators(self, p):
        return {"moment": torch.full(p.shape, self.init_acc, dtype=torch.float32,
                                     device=p.device)}

    def _apply_dense(self, lr, p, g, acc, state):
        m = acc["moment"] + g * g
        return p.float() - lr * g / (torch.sqrt(m) + self.epsilon), {"moment": m}


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
        return {"moment1": _zeros(p), "moment2": _zeros(p)}

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


class Adamax(Optimizer):
    """AdamaxOptimizer (optimizer.py:292; adamax_op): the infinity-norm
    Adam, bias-corrected by the global beta1^t."""

    def __init__(self, learning_rate=0.001, beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _init_global(self, device):
        return {"beta1_pow": _f32(self.beta1, device)}

    def _update_global(self, g):
        return {"beta1_pow": g["beta1_pow"] * self.beta1}

    def _create_accumulators(self, p):
        return {"moment": _zeros(p), "inf_norm": _zeros(p)}

    def _apply_dense(self, lr, p, g, acc, state):
        b1p = state["global"]["beta1_pow"]
        m = self.beta1 * acc["moment"] + (1 - self.beta1) * g
        u = torch.maximum(self.beta2 * acc["inf_norm"], torch.abs(g) + self.epsilon)
        return p.float() - (lr / (1 - b1p)) * m / u, {"moment": m, "inf_norm": u}


class DecayedAdagrad(Optimizer):
    """DecayedAdagradOptimizer (optimizer.py:317; decayed_adagrad_op):
    ``m = decay·m + (1 − decay)·g²``."""

    def __init__(self, learning_rate, decay: float = 0.95, epsilon: float = 1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.decay, self.epsilon = decay, epsilon

    def _create_accumulators(self, p):
        return {"moment": _zeros(p)}

    def _apply_dense(self, lr, p, g, acc, state):
        m = self.decay * acc["moment"] + (1 - self.decay) * g * g
        return p.float() - lr * g / (torch.sqrt(m) + self.epsilon), {"moment": m}


class Adadelta(Optimizer):
    """AdadeltaOptimizer (optimizer.py:332; adadelta_op)."""

    def __init__(self, learning_rate=1.0, epsilon: float = 1e-6, rho: float = 0.95, **kw):
        super().__init__(learning_rate, **kw)
        self.epsilon, self.rho = epsilon, rho

    def _create_accumulators(self, p):
        return {"avg_squared_grad": _zeros(p), "avg_squared_update": _zeros(p)}

    def _apply_dense(self, lr, p, g, acc, state):
        sg = self.rho * acc["avg_squared_grad"] + (1 - self.rho) * g * g
        upd = (g * torch.sqrt(acc["avg_squared_update"] + self.epsilon)
               / torch.sqrt(sg + self.epsilon))
        su = self.rho * acc["avg_squared_update"] + (1 - self.rho) * upd * upd
        return p.float() - lr * upd, {"avg_squared_grad": sg, "avg_squared_update": su}


class RMSProp(Optimizer):
    """RMSPropOptimizer (optimizer.py:350; rmsprop_op) with the momentum
    and centered variants: ``mom = momentum·mom + lr·g / denom``,
    ``p −= mom``."""

    def __init__(self, learning_rate, rho: float = 0.95, epsilon: float = 1e-6,
                 momentum: float = 0.0, centered: bool = False, **kw):
        super().__init__(learning_rate, **kw)
        self.rho, self.epsilon, self.momentum, self.centered = rho, epsilon, momentum, centered

    def _create_accumulators(self, p):
        return {"mean_square": _zeros(p), "mean_grad": _zeros(p), "momentum": _zeros(p)}

    def _apply_dense(self, lr, p, g, acc, state):
        ms = self.rho * acc["mean_square"] + (1 - self.rho) * g * g
        if self.centered:
            mg = self.rho * acc["mean_grad"] + (1 - self.rho) * g
            denom = torch.sqrt(ms - mg * mg + self.epsilon)
        else:
            mg = acc["mean_grad"]
            denom = torch.sqrt(ms + self.epsilon)
        mom = self.momentum * acc["momentum"] + lr * g / denom
        return p.float() - mom, {"mean_square": ms, "mean_grad": mg, "momentum": mom}


class Ftrl(Optimizer):
    """FtrlOptimizer (optimizer.py:376; ftrl_op), with the reference's
    square-root branch at ``lr_power == -0.5`` and ``pow`` otherwise."""

    def __init__(self, learning_rate, l1: float = 0.0, l2: float = 0.0,
                 lr_power: float = -0.5, **kw):
        super().__init__(learning_rate, **kw)
        self.l1, self.l2, self.lr_power = l1, l2, lr_power

    def _create_accumulators(self, p):
        return {"squared": _zeros(p), "linear": _zeros(p)}

    def _apply_dense(self, lr, p, g, acc, state):
        p32 = p.float()
        new_sq = acc["squared"] + g * g
        if self.lr_power == -0.5:
            sigma = (torch.sqrt(new_sq) - torch.sqrt(acc["squared"])) / lr
        else:
            sigma = (torch.pow(new_sq, -self.lr_power)
                     - torch.pow(acc["squared"], -self.lr_power)) / lr
        lin = acc["linear"] + g - sigma * p32
        if self.lr_power == -0.5:
            x = self.l2 + torch.sqrt(new_sq) / lr
        else:
            x = self.l2 + torch.pow(new_sq, -self.lr_power) / lr
        pre = torch.clamp(lin, -self.l1, self.l1) - lin
        new_p = torch.where(torch.abs(lin) > self.l1, pre / x, torch.zeros_like(p32))
        return new_p, {"squared": new_sq, "linear": lin}


class Lamb(Optimizer):
    """LAMB (optimizer.py:405): Adam's direction plus decoupled decay,
    scaled by the trust ratio ‖p‖/‖r‖ where both norms are positive;
    bias-corrected from the step count."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay: float = 0.01,
                 beta1: float = 0.9, beta2: float = 0.999, epsilon: float = 1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.wd, self.beta1, self.beta2, self.epsilon = lamb_weight_decay, beta1, beta2, epsilon

    def _create_accumulators(self, p):
        return {"moment1": _zeros(p), "moment2": _zeros(p)}

    def _apply_dense(self, lr, p, g, acc, state):
        t = state["step"].float() + 1.0
        p32 = p.float()
        m1 = self.beta1 * acc["moment1"] + (1 - self.beta1) * g
        m2 = self.beta2 * acc["moment2"] + (1 - self.beta2) * g * g
        m1h = m1 / (1 - torch.pow(self.beta1, t))
        m2h = m2 / (1 - torch.pow(self.beta2, t))
        r = m1h / (torch.sqrt(m2h) + self.epsilon) + self.wd * p32
        pn, rn = _norm(p32), _norm(r)
        trust = torch.where((pn > 0) & (rn > 0), pn / rn, 1.0)
        return p32 - lr * trust * r, {"moment1": m1, "moment2": m2}


class ModelAverage:
    """ModelAverageOptimizer (optimizer.py:432): a running average of the
    parameters for evaluation. Feed every post-update params dict to
    ``accumulate``; ``average_params`` gives the averages in the params'
    dtypes (keep the originals to restore). Past ``max_average_window``
    accumulations the window restarts from the current params; all of it
    on the device."""

    def __init__(self, average_window_rate: float = 0.15,
                 min_average_window: int = 10000, max_average_window: int = 10000):
        self.rate = average_window_rate
        self.min_w, self.max_w = min_average_window, max_average_window

    def init(self, params: Params) -> Dict[str, Any]:
        device = next(iter(params.values())).device if params else None
        return {"sum": {k: _zeros(p) for k, p in params.items()},
                "num": torch.zeros((), dtype=torch.float32, device=device)}

    def accumulate(self, avg_state, params: Params) -> Dict[str, Any]:
        num = avg_state["num"] + 1.0
        restart = num > self.max_w
        s = {k: torch.where(restart, p.float(), avg_state["sum"][k] + p.float())
             for k, p in params.items()}
        return {"sum": s, "num": torch.where(restart, torch.ones_like(num), num)}

    def average_params(self, avg_state, params: Params) -> Params:
        n = torch.clamp_min(avg_state["num"], 1.0)
        return {k: (avg_state["sum"][k] / n).to(v.dtype) for k, v in params.items()}


class ExponentialMovingAverage:
    """An exponential moving average of the parameters (optimizer.py:461;
    the fluid ExponentialMovingAverage), kept in f32."""

    def __init__(self, decay: float = 0.999):
        self.decay = decay

    def init(self, params: Params) -> Params:
        return {k: p.float().clone() for k, p in params.items()}

    def accumulate(self, ema: Params, params: Params) -> Params:
        return {k: self.decay * ema[k] + (1 - self.decay) * p.float()
                for k, p in params.items()}

    def average_params(self, ema: Params, params: Params) -> Params:
        return {k: ema[k].to(v.dtype) for k, v in params.items()}


# fluid-style aliases (optimizer.py:479-488)
SGDOptimizer = SGD
MomentumOptimizer = Momentum
LarsMomentumOptimizer = LarsMomentum
AdagradOptimizer = Adagrad
AdamOptimizer = Adam
AdamaxOptimizer = Adamax
DecayedAdagradOptimizer = DecayedAdagrad
AdadeltaOptimizer = Adadelta
RMSPropOptimizer = RMSProp
FtrlOptimizer = Ftrl

__all__ = ["Adadelta", "AdadeltaOptimizer", "Adagrad", "AdagradOptimizer", "Adam",
           "AdamOptimizer", "AdamW", "Adamax", "AdamaxOptimizer", "DecayedAdagrad",
           "DecayedAdagradOptimizer", "ExponentialMovingAverage", "Ftrl", "FtrlOptimizer",
           "Lamb", "LarsMomentum", "LarsMomentumOptimizer", "ModelAverage", "Momentum",
           "MomentumOptimizer", "Optimizer", "RMSProp", "RMSPropOptimizer", "SGD",
           "SGDOptimizer"]
