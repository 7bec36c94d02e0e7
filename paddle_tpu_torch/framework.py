"""The part of ``paddle_tpu.framework`` the ported slices need.

The JAX package reads its mixed-precision compute dtype from a global
flag (``default_compute_dtype``, set by ``amp_guard``); the port takes it
as an explicit ``compute_dtype`` argument instead, so two callers in one
process can never see each other's setting. ``build``/``Program`` and
the rest of the module come with a later slice (ROADMAP).
"""

from __future__ import annotations

import torch

from .core.dtypes import convert_dtype


def cast_compute(compute_dtype, *tensors):
    """Cast matmul operands to ``compute_dtype``; integer tensors pass
    through. Returns one tensor for one argument, else a tuple."""
    cd = convert_dtype(compute_dtype)
    out = tuple(t.to(cd) if torch.is_floating_point(t) else t for t in tensors)
    return out if len(out) > 1 else out[0]
