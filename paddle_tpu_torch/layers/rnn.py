"""Recurrent layers (counterpart of ``paddle_tpu.layers.rnn``): the
dynamic LSTM, GRU and LSTMP over padded batches, their single-step units
and the generic :func:`rnn`.

The JAX package's ``lax.scan`` over time becomes a Python loop over the
steps, written to its math, not routed through ``torch.nn.LSTM``/``GRU``
or cuDNN, which compute other functions here: the LSTM adds
``forget_bias`` inside the forget gate's sigmoid; the GRU's reset gate
multiplies h *before* the candidate's product, ``tanh(c_x + (r·h)·W_c)``;
and a row past its ``sequence_length`` repeats its last state in the
outputs (``torch.where`` on the mask), where packed sequences give zeros.

Parameters keep the JAX package's names, shapes (``[in, out]``), f32
storage and creation order (``lstm_0/w_x``, ``w_h``, ``b`` ...); the
input projection of all steps is one GEMM before the loop, and the
operands are cast to the program's compute dtype. Each step reads its
input as a view (``unbind``), so the backward writes each step's grad
into the projection once; the per-step outputs are stacked at the end.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import initializer as init
from ..core.errors import enforce
from ..framework import LayerHelper, cast_compute, compute_dtype


def _tree_map2(fn, a, b):
    """``fn`` over the leaves of two trees of one structure (dicts, lists,
    tuples of tensors)."""
    if isinstance(a, dict):
        return {k: _tree_map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_tree_map2(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def _steps(t: int, is_reverse: bool):
    return range(t - 1, -1, -1) if is_reverse else range(t)


def _valid(idx: int, sequence_length) -> torch.Tensor:
    """[b, 1] bool: whether step ``idx`` lies inside each row."""
    return (sequence_length > idx)[:, None]


def lstm_cell_step(x_proj, h, c, w_h, forget_bias: float = 0.0):
    """One LSTM step from a precomputed input projection ``x_proj`` [b,
    4d]. Gate order (i, f, c, o), as lstm_op.cc."""
    gates = x_proj + torch.matmul(h, w_h)
    i, f, g, o = gates.chunk(4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f + forget_bias)
    g = torch.tanh(g)
    o = torch.sigmoid(o)
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return h_new, c_new


def _input_projection(helper, input, size: int, gates: int, param_attr, bias_attr,
                      extra=()):
    """Create ``w_x`` [d, gates·size], then ``extra`` ((suffix, shape) of
    further Xavier weights, in order), then ``b``; returns the input's
    projection [b, t, gates·size] in the compute dtype and the cast extra
    weights."""
    b, t, d = input.shape
    w_x = helper.create_parameter("w_x", (d, gates * size), torch.float32, attr=param_attr,
                                  initializer=init.Xavier())
    more = [helper.create_parameter(s, shape, torch.float32, attr=attr,
                                    initializer=init.Xavier()) for s, shape, attr in extra]
    bias = helper.create_parameter("b", (gates * size,), torch.float32, attr=bias_attr,
                                   initializer=init.Constant(0.0))
    input, w_x, *more = cast_compute(compute_dtype(), input, w_x, *more)
    x_proj = torch.matmul(input.reshape(b * t, d), w_x).reshape(b, t, gates * size) \
        + bias.to(input.dtype)
    return x_proj, more


def dynamic_lstm(input, size: int, sequence_length=None, is_reverse: bool = False,
                 forget_bias: float = 0.0, param_attr=None, bias_attr=None,
                 name: Optional[str] = None) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                                           torch.Tensor]]:
    """LSTM over a padded batch [b, t, d] (dynamic_lstm op analog).
    Returns (outputs [b, t, size], (h_last, c_last)). ``sequence_length``
    [b] holds a row's h and c past its end, so h_last/c_last are the
    states at each row's end; ``is_reverse`` runs from the last step to
    the first (outputs stay in input order)."""
    helper = LayerHelper("lstm", name=name)
    b, t, _ = input.shape
    x_proj, (w_h,) = _input_projection(helper, input, size, 4, param_attr, bias_attr,
                                       extra=[("w_h", (size, 4 * size), None)])
    xs = x_proj.unbind(1)
    h = torch.zeros((b, size), dtype=x_proj.dtype, device=x_proj.device)
    c = torch.zeros_like(h)
    outs = [None] * t
    for idx in _steps(t, is_reverse):
        h_new, c_new = lstm_cell_step(xs[idx], h, c, w_h, forget_bias)
        if sequence_length is not None:
            valid = _valid(idx, sequence_length)
            h_new = torch.where(valid, h_new, h)
            c_new = torch.where(valid, c_new, c)
        h, c = h_new, c_new
        outs[idx] = h
    return torch.stack(outs, dim=1), (h, c)


def _gru_step(x_proj, h, w_zr, w_c):
    size = h.shape[-1]
    zr_x, c_x = x_proj[..., :2 * size], x_proj[..., 2 * size:]
    z, r = torch.sigmoid(zr_x + torch.matmul(h, w_zr)).chunk(2, dim=-1)
    c = torch.tanh(c_x + torch.matmul(r * h, w_c))
    return (1 - z) * h + z * c


def gru_cell_step(x_proj, h, w_h):
    """One GRU step; gate order (update z, reset r, candidate), as
    gru_op.cc; the reset gate scales h before the candidate's product."""
    size = h.shape[-1]
    return _gru_step(x_proj, h, w_h[:, :2 * size], w_h[:, 2 * size:])


def dynamic_gru(input, size: int, sequence_length=None, is_reverse: bool = False,
                param_attr=None, bias_attr=None, name: Optional[str] = None):
    """GRU over a padded batch [b, t, d] (dynamic_gru op analog). Returns
    outputs [b, t, size]; masking and ``is_reverse`` as
    :func:`dynamic_lstm`."""
    helper = LayerHelper("gru", name=name)
    b, t, _ = input.shape
    x_proj, (w_h,) = _input_projection(helper, input, size, 3, param_attr, bias_attr,
                                       extra=[("w_h", (size, 3 * size), None)])
    # the two column blocks sliced once: each step's grads gather on them
    w_zr, w_c = w_h[:, :2 * size], w_h[:, 2 * size:]
    xs = x_proj.unbind(1)
    h = torch.zeros((b, size), dtype=x_proj.dtype, device=x_proj.device)
    outs = [None] * t
    for idx in _steps(t, is_reverse):
        h_new = _gru_step(xs[idx], h, w_zr, w_c)
        if sequence_length is not None:
            h_new = torch.where(_valid(idx, sequence_length), h_new, h)
        h = h_new
        outs[idx] = h
    return torch.stack(outs, dim=1)


def rnn(cell_fn, inputs, initial_state, sequence_length=None):
    """Generic RNN over axis 1 of ``inputs`` [b, t, ...] (StaticRNN/
    DynamicRNN analog): ``cell_fn(state, x_t) -> (new_state, out_t)``;
    ``state`` is a tensor or a nest of dicts, lists and tuples of them.
    With ``sequence_length`` a row keeps its state past its end (its
    ``out_t`` is the cell's). Returns (outputs [b, t, ...], last state)."""
    state = initial_state
    outs = []
    for idx, x_t in enumerate(inputs.unbind(1)):
        new_state, out = cell_fn(state, x_t)
        if sequence_length is not None:
            valid = sequence_length > idx
            new_state = _tree_map2(
                lambda n, o: torch.where(valid.reshape((-1,) + (1,) * (n.dim() - 1)), n, o),
                new_state, state)
        state = new_state
        outs.append(out)
    return torch.stack(outs, dim=1), state


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias: float = 0.0,
              param_attr=None, bias_attr=None, name=None):
    """A single LSTM step with its own weights (lstm_unit_op.cc): one
    [d+h, 4h] weight ``w`` over concat(x, h). Returns (hidden_t, cell_t)."""
    helper = LayerHelper("lstm_unit", name=name)
    d = x_t.shape[-1]
    size = hidden_t_prev.shape[-1]
    w = helper.create_parameter("w", (d + size, 4 * size), torch.float32, attr=param_attr,
                                initializer=init.Xavier())
    b = helper.create_parameter("b", (4 * size,), torch.float32, attr=bias_attr,
                                initializer=init.Constant(0.0))
    x_t, hidden_t_prev, cell_t_prev, w = cast_compute(compute_dtype(), x_t, hidden_t_prev,
                                                      cell_t_prev, w)
    x_proj = torch.matmul(x_t, w[:d]) + b.to(x_t.dtype)
    return lstm_cell_step(x_proj, hidden_t_prev, cell_t_prev, w[d:], forget_bias)


def gru_unit(input, hidden, size: int, param_attr=None, bias_attr=None,
             activation: str = "tanh", gate_activation: str = "sigmoid", name=None):
    """A single GRU step (gru_unit_op.cc; ``size`` is 3×dim, as fluid
    passes it) on an input already projected to [b, 3·dim]. Returns
    (new_hidden, reset_hidden_pre, gate), as the reference."""
    enforce(activation == "tanh" and gate_activation == "sigmoid",
            "gru_unit: only tanh/sigmoid activations (reference defaults) supported")
    dim = size // 3
    helper = LayerHelper("gru_unit", name=name)
    w_h = helper.create_parameter("w_h", (dim, 3 * dim), torch.float32, attr=param_attr,
                                  initializer=init.Xavier())
    b = helper.create_parameter("b", (3 * dim,), torch.float32, attr=bias_attr,
                                initializer=init.Constant(0.0))
    input, hidden, w_h = cast_compute(compute_dtype(), input, hidden, w_h)
    xp = input + b.to(input.dtype)
    zr_x, c_x = xp[..., :2 * dim], xp[..., 2 * dim:]
    z, r = torch.sigmoid(zr_x + torch.matmul(hidden, w_h[:, :2 * dim])).chunk(2, dim=-1)
    reset_hidden_pre = r * hidden
    c = torch.tanh(c_x + torch.matmul(reset_hidden_pre, w_h[:, 2 * dim:]))
    new_hidden = (1 - z) * hidden + z * c
    return new_hidden, reset_hidden_pre, torch.cat([z, r, c], dim=-1)


def dynamic_lstmp(input, size: int, proj_size: int, sequence_length=None,
                  is_reverse: bool = False, forget_bias: float = 0.0,
                  proj_clip: Optional[float] = None, cell_clip: Optional[float] = None,
                  param_attr=None, bias_attr=None, name=None):
    """LSTM with a recurrent projection (lstmp_op.cc): the state fed back
    into the gates is r = h·w_p [proj_size]; ``cell_clip`` clips c and
    ``proj_clip`` clips r. Returns (projected outputs [b, t, proj_size],
    (r_last, c_last)); masking and ``is_reverse`` as :func:`dynamic_lstm`."""
    helper = LayerHelper("lstmp", name=name)
    b, t, _ = input.shape
    x_proj, (w_r, w_p) = _input_projection(
        helper, input, size, 4, param_attr, bias_attr,
        extra=[("w_r", (proj_size, 4 * size), param_attr),
               ("w_p", (size, proj_size), param_attr)])
    xs = x_proj.unbind(1)
    r = torch.zeros((b, proj_size), dtype=x_proj.dtype, device=x_proj.device)
    c = torch.zeros((b, size), dtype=x_proj.dtype, device=x_proj.device)
    outs = [None] * t
    for idx in _steps(t, is_reverse):
        i, f, g, o = (xs[idx] + torch.matmul(r, w_r)).chunk(4, dim=-1)
        i = torch.sigmoid(i)
        f = torch.sigmoid(f + forget_bias)
        g = torch.tanh(g)
        o = torch.sigmoid(o)
        c_new = f * c + i * g
        if cell_clip is not None:
            c_new = torch.clamp(c_new, -cell_clip, cell_clip)
        r_new = torch.matmul(o * torch.tanh(c_new), w_p)
        if proj_clip is not None:
            r_new = torch.clamp(r_new, -proj_clip, proj_clip)
        if sequence_length is not None:
            valid = _valid(idx, sequence_length)
            r_new = torch.where(valid, r_new, r)
            c_new = torch.where(valid, c_new, c)
        r, c = r_new, c_new
        outs[idx] = r
    return torch.stack(outs, dim=1), (r, c)


__all__ = ["dynamic_gru", "dynamic_lstm", "dynamic_lstmp", "gru_cell_step", "gru_unit",
           "lstm_cell_step", "lstm_unit", "rnn"]
