"""Autodiff surface (counterpart of ``paddle_tpu.backward``;
python/paddle/fluid/backward.py).

The reference's append_backward rewrites the program with grad ops; the
JAX package takes ``jax.value_and_grad`` of ``Program.apply``. Here it
is ``torch.autograd.grad`` of the same run, with the JAX package's
return shapes: ``(loss, [(name, grad)])`` and a dict of input grads. A
param or input the target does not reach gets a zero grad, as under
``jax.grad``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .framework import Program, _run_device


def _grads(target, wrt: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    got = torch.autograd.grad(target, list(wrt.values()), allow_unused=True)
    return {n: torch.zeros_like(v) if g is None else g
            for (n, v), g in zip(wrt.items(), got)}


def _leaf(v, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray) else torch.as_tensor(v)
    return t.detach().to(device).clone().requires_grad_(True)


def append_backward(program: Program, loss_name: str = "loss",
                    parameter_list: Optional[Sequence[str]] = None,
                    no_grad_set: Optional[set] = None) -> Callable:
    """Returns grad_fn(params, state, *args, **kwargs) -> (loss, [(name,
    grad)]) over ``parameter_list`` (default: every param) less
    ``no_grad_set``; the caller's params are not touched."""

    def grad_fn(params: Dict, state: Dict, *args, **kwargs):
        names = list(parameter_list) if parameter_list is not None else list(params.keys())
        if no_grad_set:
            names = [n for n in names if n not in no_grad_set]
        wrt = {n: params[n].detach().requires_grad_(True) for n in names}
        rest = {n: v for n, v in params.items() if n not in wrt}
        with torch.enable_grad():
            out, _ = program.apply({**rest, **wrt}, state, *args, **kwargs)
            loss = out[loss_name] if isinstance(out, dict) else out
            grads = _grads(loss, wrt)
        return loss.detach(), [(n, grads[n]) for n in names]

    return grad_fn


def calc_gradient(program: Program, target_name: str,
                  input_names: Sequence[str]) -> Callable:
    """backward.py calc_gradient analog: d(sum of target)/d(inputs) for
    feed inputs. Returns grad_fn(params, state, feed) -> {input name:
    grad}; the inputs go to the params' device."""

    def grad_fn(params: Dict, state: Dict, feed: Dict):
        device = _run_device(None, "calc_gradient", params, feed)
        wrt = {n: _leaf(feed[n], device) for n in input_names}
        rest = {n: v for n, v in feed.items() if n not in wrt}
        with torch.enable_grad():
            out, _ = program.apply(params, state, **{**rest, **wrt})
            t = out[target_name] if isinstance(out, dict) else out
            return _grads(t.sum(), wrt)

    return grad_fn


__all__ = ["append_backward", "calc_gradient"]
