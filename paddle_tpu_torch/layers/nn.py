"""The part of ``paddle_tpu.layers.nn`` the GPT training slice needs:
``embedding`` and ``layer_norm``.

The JAX layers create their parameters through ``LayerHelper`` inside
``Program.init``; the port has no build context yet (ROADMAP queue 1,
item 3), so a module owns the parameters and passes them in. The
arithmetic is the JAX package's.
"""

from __future__ import annotations

import torch

from ..framework import cast_compute


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with the JAX gather's index rule: a negative id
    counts from the end, then ids are clamped into range (an out-of-range
    id must not fault the device)."""
    n = table.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)
    return table[ids]


def embedding(ids: torch.Tensor, table: torch.Tensor,
              compute_dtype) -> torch.Tensor:
    """Embedding lookup (layers/nn.py:93): the rows of ``table`` [vocab,
    dim] at ``ids``, cast to the compute dtype, with ``jnp.take``'s index
    rule: a negative id counts from the end, and an id outside [-vocab,
    vocab) gives a row of NaN (its "fill" mode; the generator's
    ``table[ids]`` clamps instead, see :func:`take_rows`). Not carried
    yet: ``padding_idx`` and ``is_sparse`` (the DeepFM slice)."""
    n = table.shape[0]
    ids = ids.long()
    rows = take_rows(table, ids)
    inside = ((ids >= -n) & (ids < n))[..., None]
    rows = torch.where(inside, rows, torch.full((), float("nan"), dtype=rows.dtype,
                                                device=rows.device))
    return cast_compute(compute_dtype, rows)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               begin_norm_axis: int = 1, epsilon: float = 1e-5) -> torch.Tensor:
    """Layer normalization over dims [begin_norm_axis, rank)
    (layers/nn.py:455): statistics and the affine map in f32, the output
    in x's dtype. The JAX layer creates ``scale`` and ``bias`` in x's
    dtype; here the caller owns them."""
    dims = tuple(range(begin_norm_axis, x.dim()))
    x32 = x.float()
    mean = x32.mean(dim=dims, keepdim=True)
    var = x32.var(dim=dims, keepdim=True, unbiased=False)
    out = (x32 - mean) * torch.rsqrt(var + epsilon)
    return (out * scale.float() + bias.float()).to(x.dtype)


__all__ = ["embedding", "layer_norm", "take_rows"]
