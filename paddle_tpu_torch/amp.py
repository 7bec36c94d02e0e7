"""Loss scaling for mixed precision (counterpart of ``paddle_tpu.amp``).

The compute-dtype half of mixed precision is ``framework.amp_guard`` (bf16
operands, f32 master params). This module is the other half: scale the
loss before the backward, unscale the grads, skip the optimizer step when
a grad is not finite, and (dynamic mode) grow or shrink the scale from
the overflow history. bf16 needs no scaling (its exponent range is
f32's); it exists for fp16-style training and as a guard that skips a
non-finite step instead of aborting.

Every piece of the class is branchless on the device, as in the JAX
package: the state ``{scale, good_steps, overflows}`` is three 0-d
tensors, and ``update`` and ``select`` read the ``finite`` flag as a
tensor. ``Trainer``'s step computes the update and selects the old
values back with ``select`` where a step is skipped, so it never reads the
flag on the host and can be captured as a CUDA graph.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

LossScaleState = Dict[str, torch.Tensor]


def _by_dtype(tensors: Dict[Any, torch.Tensor]) -> Dict[torch.dtype, List[Any]]:
    """The keys of ``tensors`` grouped by dtype (a multi-tensor launch
    takes one dtype)."""
    groups: Dict[torch.dtype, List[Any]] = {}
    for k, t in tensors.items():
        groups.setdefault(t.dtype, []).append(k)
    return groups


class LossScaler:
    """Static or dynamic loss scaling.

    Dynamic policy: on an overflow the scale is divided by ``factor`` and
    the count of good steps restarts; after ``growth_interval`` finite
    steps in a row the scale is multiplied by ``factor``; the scale stays
    within [``min_scale``, ``max_scale``]. Static: the scale is fixed, and
    an overflow still skips the step."""

    def __init__(self, init_scale: float = 2.0 ** 15, dynamic: bool = True,
                 growth_interval: int = 1000, factor: float = 2.0,
                 min_scale: float = 1.0, max_scale: float = 2.0 ** 24):
        self.init_scale = float(init_scale)
        self.dynamic = dynamic
        self.growth_interval = int(growth_interval)
        self.factor = float(factor)
        self.min_scale = float(min_scale)
        self.max_scale = float(max_scale)

    def init_state(self, device=None) -> LossScaleState:
        return {"scale": torch.full((), self.init_scale, dtype=torch.float32, device=device),
                "good_steps": torch.zeros((), dtype=torch.int32, device=device),
                "overflows": torch.zeros((), dtype=torch.int32, device=device)}

    @staticmethod
    def scale_loss(loss: torch.Tensor, ls: LossScaleState) -> torch.Tensor:
        return loss * ls["scale"].to(loss.dtype)

    @staticmethod
    def unscale(grads: Dict[str, torch.Tensor], ls: LossScaleState) -> Dict[str, torch.Tensor]:
        """Each grad times 1/scale in its own dtype: one ``_foreach_mul``
        per dtype of the grads."""
        inv = 1.0 / ls["scale"]
        out = {}
        for dtype, keys in _by_dtype(grads).items():
            out.update(zip(keys, torch._foreach_mul([grads[k] for k in keys],
                                                    inv.to(dtype))))
        return {k: out[k] for k in grads}

    @staticmethod
    def all_finite(grads) -> torch.Tensor:
        """0-d bool: every element of every tensor is finite. Per dtype,
        the tensors times 0 (NaN where an element is not finite, else 0)
        and their L1 norms (NaN propagates through a sum), so a few
        multi-tensor launches cover all the grads."""
        leaves = list(grads.values() if isinstance(grads, dict) else grads)
        if not leaves:
            return torch.ones((), dtype=torch.bool)
        flags = []
        for dtype, idx in _by_dtype(dict(enumerate(leaves))).items():
            zeros = torch._foreach_mul([leaves[i] for i in idx], 0.0)
            flags.append(torch.isfinite(torch.stack(torch._foreach_norm(zeros, 1))).all())
        return flags[0] if len(flags) == 1 else torch.stack(flags).all()

    def update(self, ls: LossScaleState, finite: torch.Tensor) -> LossScaleState:
        overflows = ls["overflows"] + (~finite).to(torch.int32)
        if not self.dynamic:
            return {"scale": ls["scale"],
                    "good_steps": ls["good_steps"] + finite.to(torch.int32),
                    "overflows": overflows}
        good = torch.where(finite, ls["good_steps"] + 1, 0)
        grow = good >= self.growth_interval
        scale = torch.where(finite,
                            torch.where(grow, ls["scale"] * self.factor, ls["scale"]),
                            ls["scale"] / self.factor)
        scale = scale.clamp(self.min_scale, self.max_scale)
        good = torch.where(grow, 0, good)
        return {"scale": scale, "good_steps": good.to(torch.int32), "overflows": overflows}

    @staticmethod
    def select(finite: torch.Tensor, new_tree: Any, old_tree: Any) -> Any:
        """``new_tree`` on a finite step, ``old_tree`` otherwise, leaf by
        leaf on the device (the step skip); a leaf that is the same tensor
        in both is passed through."""
        if isinstance(new_tree, dict):
            return {k: LossScaler.select(finite, v, old_tree[k]) if k in old_tree else v
                    for k, v in new_tree.items()}
        if new_tree is old_tree:
            return new_tree
        return torch.where(finite, new_tree, old_tree)


__all__ = ["LossScaleState", "LossScaler"]
