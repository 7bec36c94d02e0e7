"""The port's recurrent layers against ``paddle_tpu.layers.rnn`` on the CPU:
``lstm_cell_step``, ``dynamic_lstm``, ``gru_cell_step``, ``dynamic_gru``,
``rnn``, ``lstm_unit``, ``gru_unit`` and ``dynamic_lstmp`` (with
``proj_clip``/``cell_clip``), with ragged lengths, ``is_reverse`` and
``forget_bias``, from the JAX package's init carried across by
``params_from_jax``; and ``core/flops.py``'s recurrent counts.

Tolerances, all f32: outputs and last states within 1e-5 (rtol and atol:
the same sigmoid/tanh arithmetic, whose f32 library functions may differ
in the last bits, through a few steps of recurrence); grads, by
``torch.autograd`` against ``jax.grad`` of one weighted sum of every
output, within 1e-5 of each grad's largest element. The GRU's reset gate
order is held against a numpy formula exactly as written, and shown to
differ from cuDNN's order."""

import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as jpt
from paddle_tpu.core import flops as jflops
from paddle_tpu.layers import rnn as jR

import paddle_tpu_torch as tpt
from paddle_tpu_torch.core import flops as tflops
from paddle_tpu_torch.framework import params_from_jax
from paddle_tpu_torch.layers import rnn as tR

CPU = tpt.CPUPlace()
OUT_TOL, GRAD_TOL = 1e-5, 1e-5
B, T, D, H = 3, 6, 4, 5
LENGTHS = np.array([6, 2, 4], np.int32)  # ragged: one full row, two short ones


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check_against_jax(make, inputs, seed=0):
    """``make(R)`` -> fn(*inputs) -> output tree over rnn module ``R``.
    Holds the port's outputs and the grads of one weighted sum of them
    (params and float inputs) against the JAX package's."""
    jprog = jpt.build(make(jR))
    jparams, _ = jprog.init(jax.random.PRNGKey(seed), *inputs)
    jparams = {k: np.asarray(v) for k, v in jparams.items()}
    jout, _ = jprog.apply(jparams, {}, *inputs)
    rng = np.random.RandomState(seed + 1)
    cots = [rng.randn(*np.shape(x)).astype(np.float32) for x in _leaves(jout)]
    floats = [i for i, x in enumerate(inputs) if np.asarray(x).dtype == np.float32]

    def jloss(params, *fx):
        args = list(inputs)
        for i, x in zip(floats, fx):
            args[i] = x
        out, _ = jprog.apply(params, {}, *args)
        return sum(jnp.sum(o * c) for o, c in zip(_leaves(out), cots))

    jgrads = jax.grad(jloss, argnums=tuple(range(1 + len(floats))))(
        jparams, *[jnp.asarray(inputs[i]) for i in floats])

    prog = tpt.build(make(tR))
    prog.init(0, *inputs, place=CPU)
    assert sorted(prog.param_info) == sorted(jparams)
    params = params_from_jax(jparams, prog.param_info, device="cpu")
    for p in params.values():
        p.requires_grad_(True)
    targs = [torch.from_numpy(np.array(x)) for x in inputs]
    for i in floats:
        targs[i].requires_grad_(True)
    out, _ = prog.apply(params, {}, *targs, place=CPU)
    outs = _leaves(out)
    assert len(outs) == len(cots)
    for got, want in zip(outs, _leaves(jout)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=OUT_TOL, atol=OUT_TOL)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)).backward()
    named = [(k, params[k].grad, jgrads[0][k]) for k in jparams]
    named += [(f"input {i}", targs[i].grad, g) for i, g in zip(floats, jgrads[1:])]
    for name, got, want in named:
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(_np(got) - want).max()) / scale
        assert err <= GRAD_TOL, (name, err)
    return out


def _x(seed=0, shape=(B, T, D)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("lengths", [None, "ragged"])
@pytest.mark.parametrize("is_reverse", [False, True])
@pytest.mark.parametrize("forget_bias", [0.0, 1.0])
def test_dynamic_lstm_matches_jax(lengths, is_reverse, forget_bias):
    lens = LENGTHS if lengths else None

    def make(R):
        def fn(x, *seq):
            return R.dynamic_lstm(x, H, sequence_length=seq[0] if seq else None,
                                  is_reverse=is_reverse, forget_bias=forget_bias)
        return fn

    inputs = (_x(),) + ((lens,) if lens is not None else ())
    out, (h, c) = _check_against_jax(make, inputs)
    if lens is not None and not is_reverse:
        # a row's last state is its state at its own end, repeated past it
        for i, n in enumerate(LENGTHS):
            np.testing.assert_array_equal(_np(h[i]), _np(out[i, n - 1]))
            np.testing.assert_array_equal(_np(out[i, n:]), np.broadcast_to(
                _np(out[i, n - 1]), out[i, n:].shape))


@pytest.mark.parametrize("lengths", [None, "ragged"])
@pytest.mark.parametrize("is_reverse", [False, True])
def test_dynamic_gru_matches_jax(lengths, is_reverse):
    lens = LENGTHS if lengths else None

    def make(R):
        def fn(x, *seq):
            return R.dynamic_gru(x, H, sequence_length=seq[0] if seq else None,
                                 is_reverse=is_reverse)
        return fn

    _check_against_jax(make, (_x(),) + ((lens,) if lens is not None else ()))


@pytest.mark.parametrize("clips", [(None, None), (0.3, 0.5)])
@pytest.mark.parametrize("is_reverse", [False, True])
def test_dynamic_lstmp_matches_jax(clips, is_reverse):
    proj_clip, cell_clip = clips

    def make(R):
        def fn(x, seq):
            return R.dynamic_lstmp(x, H, 3, sequence_length=seq, is_reverse=is_reverse,
                                   forget_bias=0.5, proj_clip=proj_clip,
                                   cell_clip=cell_clip)
        return fn

    _check_against_jax(make, (_x(), LENGTHS))


def test_lstm_unit_and_gru_unit_match_jax():
    x, h, c = _x(1, (B, D)), _x(2, (B, H)), _x(3, (B, H))
    _check_against_jax(lambda R: lambda x, h, c: R.lstm_unit(x, h, c, forget_bias=1.0),
                       (x, h, c))
    _check_against_jax(lambda R: lambda x, h: R.gru_unit(x, h, 3 * H),
                       (_x(4, (B, 3 * H)), h))


def test_cell_steps_match_jax():
    xp, h, c = _x(1, (B, 4 * H)), _x(2, (B, H)), _x(3, (B, H))
    w4, w3 = _x(4, (H, 4 * H)), _x(5, (H, 3 * H))
    want = jR.lstm_cell_step(xp, h, c, w4, 0.7)
    got = tR.lstm_cell_step(*(torch.from_numpy(a) for a in (xp, h, c, w4)), 0.7)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=OUT_TOL, atol=OUT_TOL)
    want = jR.gru_cell_step(xp[:, :3 * H], h, w3)
    got = tR.gru_cell_step(*(torch.from_numpy(np.ascontiguousarray(a))
                             for a in (xp[:, :3 * H], h, w3)))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=OUT_TOL, atol=OUT_TOL)


def test_gru_resets_h_before_the_candidate_product():
    """tanh(c_x + (r·h)·W_c), the reference's order (rnn.py:105), computed
    in numpy as written, and not cuDNN's tanh(c_x + r·(h·W_c + b))."""
    xp, h, w = _x(1, (B, 3 * H)).astype(np.float64), _x(2, (B, H)), _x(3, (H, 3 * H))
    h, w = h.astype(np.float64), w.astype(np.float64)
    sig = lambda v: 1 / (1 + np.exp(-v))  # noqa: E731
    z, r = np.split(sig(xp[:, :2 * H] + h @ w[:, :2 * H]), 2, axis=-1)
    ours = (1 - z) * h + z * np.tanh(xp[:, 2 * H:] + (r * h) @ w[:, 2 * H:])
    cudnn = (1 - z) * h + z * np.tanh(xp[:, 2 * H:] + r * (h @ w[:, 2 * H:]))
    got = tR.gru_cell_step(*(torch.from_numpy(a) for a in (xp, h, w)))
    np.testing.assert_allclose(_np(got), ours, rtol=1e-12, atol=1e-12)
    assert np.abs(ours - cudnn).max() > 1e-3


@pytest.mark.parametrize("lengths", [None, "ragged"])
def test_generic_rnn_matches_jax(lengths):
    """rnn() with a (h, c) tuple state and an LSTM cell over weights given
    as inputs: each row's state held past its end."""
    lens = LENGTHS if lengths else None

    def make(R):
        def fn(x, h0, w_h, *seq):
            def cell(state, x_t):
                nh, nc = R.lstm_cell_step(x_t, state[0], state[1], w_h)
                return (nh, nc), nh * 2.0
            return R.rnn(cell, x, (h0, h0 * 0.5), sequence_length=seq[0] if seq else None)
        return fn

    inputs = (_x(0, (B, T, 4 * H)), _x(1, (B, H)), _x(2, (H, 4 * H)))
    inputs += (lens,) if lens is not None else ()
    _check_against_jax(make, inputs)


def test_recurrence_is_written_by_hand():
    """The port routes no recurrence through torch.nn.LSTM/GRU, torch._VF or
    cuDNN's RNN."""
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "paddle_tpu_torch")
    bad = re.compile(r"nn\.(LSTM|GRU|RNN)|_VF|cudnn_rnn|lstm_cell\(|gru_cell\(|"
                     r"pack_padded_sequence")
    for rel in ("layers/rnn.py", "models/lstm.py", "models/seq2seq.py", "models/srl.py",
                "layers/control_flow.py", "layers/crf.py"):
        with open(os.path.join(root, rel)) as f:
            code = re.sub(r'"""[\s\S]*?"""|#[^\n]*', "", f.read())
        assert not bad.search(code), rel


def test_recurrent_flops_match_jax():
    for args in ((64, 128, 512, 2), (256, 128, 1280, 2), (8, 16, 32, 3, 24)):
        assert tflops.lstm_train_flops(*args) == jflops.lstm_train_flops(*args)
    for args in ((128, 30, 30, 512, 512, 30000), (4, 7, 5, 16, 32, 50)):
        assert tflops.seq2seq_train_flops(*args) == jflops.seq2seq_train_flops(*args)
    # bench.py's three rows (0.206, 5.15 and 0.518 TFLOP a step)
    assert abs(tflops.lstm_train_flops(64, 128, 512, 2) / 1e12 - 0.2062) < 1e-4
    assert abs(tflops.lstm_train_flops(256, 128, 1280, 2) / 1e12 - 5.1540) < 1e-4
    assert abs(tflops.seq2seq_train_flops(128, 30, 30, 512, 512, 30000) / 1e12
               - 0.5180) < 1e-4
