"""Layers (counterpart of ``paddle_tpu.layers``): the ``fluid.layers``
names of the ported slices — ``fc`` and the losses, every activation,
the tensor ops, ``accuracy``, ``create_parameter`` and the learning-rate
decays, as the JAX package exports them; the attention layers; and the
modules of the GPT slices (stacked blocks, greedy search); and the
recurrent family: the dynamic LSTM/GRU, the sequence ops and
``LoDTensor``, the CRF, control flow and ``beam_search_decode_lod``."""

from . import attention, beam_search, control_flow, crf, nn, ops, rnn, sequence, tensor
from .beam_search import beam_search_decode, beam_search_decode_lod
from .control_flow import (
    DynamicRNN,
    IfElse,
    Print,
    StaticRNN,
    Switch,
    While,
    array_length,
    array_read,
    array_write,
    create_array,
)
from .crf import crf_decoding, linear_chain_crf
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .tensor import _sum_layer as sum  # noqa: A004  (reference API name)

from .attention import (ffn, multi_head_attention, padding_mask, positional_encoding,
                        scaled_dot_product_attention)
from .rnn import (
    dynamic_gru,
    dynamic_lstm,
    dynamic_lstmp,
    gru_unit,
    lstm_unit,
    rnn as rnn_scan,
)
from .sequence import (
    LoDTensor,
    create_lod_tensor,
    create_random_int_lodtensor,
    lod_reset,
    reorder_lod_tensor_by_rank,
    sequence_concat,
    sequence_conv,
    sequence_enumerate,
    sequence_expand,
    sequence_expand_as,
    sequence_first_step,
    sequence_last_step,
    sequence_mask,
    sequence_pad,
    sequence_pool,
    sequence_reshape,
    sequence_reverse,
    sequence_scatter,
    sequence_slice,
    sequence_softmax,
    sequence_unpad,
)

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
