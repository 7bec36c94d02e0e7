"""Learning-rate schedules (counterpart of ``paddle_tpu.lr_scheduler``).

Each schedule is a pure function of the optimizer's step, a 0-d int32
tensor on the device, and returns the rate as a 0-d f32 tensor there. The
arithmetic stays on the device: no schedule reads the step back to the
host (``.item()``), so a schedule costs the training step no host sync.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch


Schedule = Callable  # step (0-d int tensor) -> 0-d f32 tensor


def _as_f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def noam_decay(d_model: int, warmup_steps: int, learning_rate: float = 1.0) -> Schedule:
    def sched(step):
        s = torch.clamp_min(_as_f32(step), 1.0)
        return learning_rate * (d_model ** -0.5) * torch.minimum(
            s ** -0.5, s * warmup_steps ** -1.5)
    return sched


def exponential_decay(learning_rate: float, decay_steps: int, decay_rate: float,
                      staircase: bool = False) -> Schedule:
    def sched(step):
        p = _as_f32(step) / decay_steps
        if staircase:
            p = torch.floor(p)
        return learning_rate * torch.pow(torch.full_like(p, decay_rate), p)
    return sched


def natural_exp_decay(learning_rate: float, decay_steps: int, decay_rate: float,
                      staircase: bool = False) -> Schedule:
    def sched(step):
        p = _as_f32(step) / decay_steps
        if staircase:
            p = torch.floor(p)
        return learning_rate * torch.exp(-decay_rate * p)
    return sched


def inverse_time_decay(learning_rate: float, decay_steps: int, decay_rate: float,
                       staircase: bool = False) -> Schedule:
    def sched(step):
        p = _as_f32(step) / decay_steps
        if staircase:
            p = torch.floor(p)
        return learning_rate / (1.0 + decay_rate * p)
    return sched


def polynomial_decay(learning_rate: float, decay_steps: int, end_learning_rate: float = 1e-4,
                     power: float = 1.0, cycle: bool = False) -> Schedule:
    def sched(step):
        s = _as_f32(step)
        if cycle:
            ds = decay_steps * torch.clamp_min(torch.ceil(s / decay_steps), 1.0)
        else:
            ds = float(decay_steps)
            s = torch.clamp_max(s, ds)
        return ((learning_rate - end_learning_rate) * torch.pow(1 - s / ds, power)
                + end_learning_rate)
    return sched


def piecewise_decay(boundaries: Sequence[int], values: Sequence[float]) -> Schedule:
    """``values[i]`` where i is the number of boundaries the step has
    reached; built from ``torch.where`` on the Python constants, so no
    table is copied to the device on each step."""
    def sched(step):
        s = _as_f32(step)
        lr = torch.full_like(s, float(values[0]))
        for b, v in zip(boundaries, values[1:]):
            lr = torch.where(s >= b, float(v), lr)
        return lr
    return sched


def cosine_decay(learning_rate: float, step_each_epoch: int, epochs: int) -> Schedule:
    def sched(step):
        epoch = torch.floor(_as_f32(step) / step_each_epoch)
        return learning_rate * 0.5 * (torch.cos(epoch * math.pi / epochs) + 1.0)
    return sched


def cosine_decay_steps(learning_rate: float, total_steps: int, min_lr: float = 0.0) -> Schedule:
    def sched(step):
        frac = torch.clamp(_as_f32(step) / total_steps, 0.0, 1.0)
        return min_lr + (learning_rate - min_lr) * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return sched


def linear_lr_warmup(learning_rate, warmup_steps: int, start_lr: float, end_lr: float) -> Schedule:
    """Wraps a schedule (or constant) with linear warmup
    (learning_rate_scheduler.py linear_lr_warmup)."""
    def base(step):
        if callable(learning_rate):
            return learning_rate(step)
        return torch.full_like(_as_f32(step), float(learning_rate))

    def sched(step):
        s = _as_f32(step)
        warm = start_lr + (end_lr - start_lr) * (s / max(warmup_steps, 1))
        return torch.where(s < warmup_steps, warm, base(step))
    return sched


def append_LARS(params_grads, learning_rate, weight_decay: float = 0.0,
                epsilon: float = 1e-9):
    """Layer-wise adaptive rate scaling (learning_rate_scheduler.py
    append_LARS; lr_scheduler.py:110): for each (param, grad) pair the
    rate ``lr·‖p‖ / (‖g‖ + weight_decay·‖p‖ + epsilon)``, a 0-d tensor on
    the pair's device. ``LarsMomentum`` is the optimizer that applies it."""
    out = []
    for p, g in params_grads:
        pn = torch.sqrt(torch.sum(torch.square(p)))
        gn = torch.sqrt(torch.sum(torch.square(g)))
        out.append(learning_rate * pn / (gn + weight_decay * pn + epsilon))
    return out
