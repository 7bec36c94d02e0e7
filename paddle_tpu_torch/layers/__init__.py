"""Layers (counterpart of ``paddle_tpu.layers``): the ``fluid.layers``
names of the ported slices — ``fc`` and the losses, every activation,
the tensor ops, ``accuracy``, ``create_parameter`` and the learning-rate
decays, as the JAX package exports them; the attention layers; and the
modules of the GPT slices (stacked blocks, greedy search)."""

from . import attention, nn, ops, tensor
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .tensor import _sum_layer as sum  # noqa: A004  (reference API name)

from .attention import (ffn, multi_head_attention, padding_mask, positional_encoding,
                        scaled_dot_product_attention)

# names the reference's fluid.layers re-exports from sibling modules
from ..framework import create_parameter
from ..lr_scheduler import (
    append_LARS,
    cosine_decay,
    exponential_decay,
    inverse_time_decay,
    natural_exp_decay,
    noam_decay,
    piecewise_decay,
    polynomial_decay,
)
from ..metrics import accuracy
