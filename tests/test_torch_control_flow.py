"""The port's control-flow ops against ``paddle_tpu.layers.control_flow``
on the CPU, on the same numpy inputs: ``while_loop``/``While``, ``cond``,
``case``/``Switch``, ``switch_case`` (in range, out of range, with and
without a default), ``IfElse``, ``Print``, the array ops, and
``StaticRNN``/``DynamicRNN`` over ragged lengths.

The results are equal exactly (the same f32 arithmetic on each branch;
the selection picks values, it computes none), the RNNs within 1e-5.
Under a CUDA graph capture (stood in for on the CPU) the ops that must
read a tensor on the host raise ``HostReadUnderCapture``, and the
selecting ops run without a host read."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.layers import control_flow as jCF
from paddle_tpu.layers import rnn as jR

from paddle_tpu_torch.layers import control_flow as tCF
from paddle_tpu_torch.layers import rnn as tR

RNN_TOL = 1e-5


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _same(got, want):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    g, w = _np(got), np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_array_equal(g, w)


X = np.random.RandomState(0).randn(3, 4).astype(np.float32)


def _branches(ops):
    # exact f32 arithmetic in both packages (no library transcendental)
    return (lambda x: ops.abs(x) * 2.0, lambda x: x - 1.0, lambda x: x * x)


def test_while_loop_and_while_match_jax():
    def make(ops):
        cond_fn = lambda v: v[0] < 5  # noqa: E731
        body = lambda v: (v[0] + 1, v[1] * 1.5 + v[0])  # noqa: E731
        return cond_fn, body

    jc, jb = make(jnp)
    tc, tb = make(torch)
    want = jCF.while_loop(jc, jb, (jnp.asarray(0), jnp.asarray(X)))
    _same(tCF.while_loop(tc, tb, (_t(np.int32(0)), _t(X))), want)
    _same(tCF.While(tc)(tb, (_t(np.int32(0)), _t(X))), want)


@pytest.mark.parametrize("pred", [True, False])
@pytest.mark.parametrize("as_tensor", [True, False])
def test_cond_matches_jax(pred, as_tensor):
    jt, jf, _ = _branches(jnp)
    tt, tf, _ = _branches(torch)
    want = jCF.cond(jnp.asarray(pred), jt, jf, jnp.asarray(X))
    got = tCF.cond(torch.tensor(pred) if as_tensor else pred, tt, tf, _t(X))
    _same(got, want)


def test_cond_takes_nested_results():
    want = jCF.cond(jnp.asarray(False), lambda x: {"a": x, "b": (x + 1, x * 2)},
                    lambda x: {"a": -x, "b": (x - 1, x / 2)}, jnp.asarray(X))
    got = tCF.cond(torch.tensor(False), lambda x: {"a": x, "b": (x + 1, x * 2)},
                   lambda x: {"a": -x, "b": (x - 1, x / 2)}, _t(X))
    _same([got["a"], *got["b"]], [want["a"], *want["b"]])


@pytest.mark.parametrize("preds", [(False, True, True), (False, False, False),
                                   (True, False, False)])
@pytest.mark.parametrize("with_default", [True, False])
def test_case_and_switch_match_jax(preds, with_default):
    x = X
    jfns = [(lambda f: (lambda: f(jnp.asarray(x))))(f) for f in _branches(jnp)]
    tfns = [(lambda f: (lambda: f(_t(x))))(f) for f in _branches(torch)]
    jdef = (lambda: jnp.asarray(x) * 0.0 + 7.0) if with_default else None
    tdef = (lambda: _t(x) * 0.0 + 7.0) if with_default else None
    want = jCF.case([(jnp.asarray(p), f) for p, f in zip(preds, jfns)], jdef)
    got = tCF.case([(torch.tensor(p), f) for p, f in zip(preds, tfns)], tdef)
    _same(got, want)
    sw = tCF.Switch()
    for p, f in zip(preds, tfns):
        sw.case(torch.tensor(p), f)
    if tdef is not None:
        sw.default(tdef)
    _same(sw(), want)


@pytest.mark.parametrize("index", [-1, 0, 1, 2, 3, 9])
@pytest.mark.parametrize("with_default", [True, False])
def test_switch_case_matches_jax(index, with_default):
    jfns = [(lambda f: (lambda: f(jnp.asarray(X))))(f) for f in _branches(jnp)]
    tfns = [(lambda f: (lambda: f(_t(X))))(f) for f in _branches(torch)]
    jdef = (lambda: jnp.asarray(X) + 100.0) if with_default else None
    tdef = (lambda: _t(X) + 100.0) if with_default else None
    want = jCF.switch_case(jnp.asarray(index), jfns, jdef)
    _same(tCF.switch_case(torch.tensor(index), tfns, tdef), want)


def test_if_else_matches_jax():
    rows = np.array([True, False, True])
    jt, jf, _ = _branches(jnp)
    tt, tf, _ = _branches(torch)
    want = jCF.IfElse(jnp.asarray(rows))(jt, jf, jnp.asarray(X))
    _same(tCF.IfElse(_t(rows))(tt, tf, _t(X)), want)
    _same(tCF.IfElse(_t(rows[:, None]))(tt, tf, _t(X)), want)


def test_array_ops_match_jax():
    jarr, tarr = jCF.create_array(4, (2,)), tCF.create_array(4, (2,), device="cpu")
    _same(tarr, jarr)
    for i, v in ((1, [1.0, 2.0]), (3, [5.0, 6.0]), (7, [9.0, 9.0]), (-2, [3.0, 4.0])):
        jarr = jCF.array_write(jarr, jnp.asarray(i), jnp.asarray(v, jnp.float32))
        tarr = tCF.array_write(tarr, torch.tensor(i), torch.tensor(v))
        _same(tarr, jarr)
    for i in (0, 1, 3, 8, -1):
        _same(tCF.array_read(tarr, torch.tensor(i)), jCF.array_read(jarr, jnp.asarray(i)))
    _same(tCF.array_length(tarr), jCF.array_length(jarr))
    _same(tCF.increment(_t(np.float32(2.0)), 3), jCF.increment(jnp.asarray(2.0), 3))
    _same(tCF.less_than(_t(X), _t(X * 0.5)),
          jCF.less_than(jnp.asarray(X), jnp.asarray(X * 0.5)))


def test_print_returns_its_input(capsys):
    y = tCF.Print(_t(X), message="x is")
    assert y is not None and torch.equal(y, _t(X))
    assert "x is" in capsys.readouterr().out


def test_host_reads_raise_under_a_capture(monkeypatch):
    """Inside a CUDA graph capture the while loop's and Print's host reads
    raise; cond, case, switch_case and IfElse select on the device and run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(tCF.HostReadUnderCapture, match="while_loop"):
        tCF.while_loop(lambda v: v < 3, lambda v: v + 1, torch.tensor(0))
    with pytest.raises(tCF.HostReadUnderCapture, match="Print"):
        tCF.Print(_t(X))
    # a Python bool is no host read
    assert int(tCF.while_loop(lambda v: False, lambda v: v + 1, torch.tensor(4))) == 4
    tt, tf, tsq = _branches(torch)
    _same(tCF.cond(torch.tensor(True), tt, tf, _t(X)), tt(_t(X)))
    _same(tCF.switch_case(torch.tensor(2), [lambda: tt(_t(X)), lambda: tf(_t(X)),
                                            lambda: tsq(_t(X))]), tsq(_t(X)))
    _same(tCF.case([(torch.tensor(False), lambda: tt(_t(X)))], lambda: tf(_t(X))),
          tf(_t(X)))
    _same(tCF.IfElse(torch.tensor([True, False, True]))(tt, tf, _t(X)),
          torch.where(torch.tensor([True, False, True])[:, None], tt(_t(X)), tf(_t(X))))


@pytest.mark.parametrize("dynamic", [False, True])
def test_static_and_dynamic_rnn_match_jax(dynamic):
    rng = np.random.RandomState(1)
    xs, h0, w = (rng.randn(3, 5, 8).astype(np.float32), rng.randn(3, 2).astype(np.float32),
                 rng.randn(2, 8).astype(np.float32))
    lens = np.array([5, 2, 3], np.int32)

    def cell(R, w):
        def step(state, x_t):
            h, c = R.lstm_cell_step(x_t, state[0], state[1], w)
            return (h, c), h + c
        return step

    jstate = (jnp.asarray(h0), jnp.asarray(h0) * 0)
    tstate = (_t(h0), _t(h0) * 0)
    if dynamic:
        want = jCF.DynamicRNN()(cell(jR, jnp.asarray(w)), jnp.asarray(xs), jstate,
                                sequence_length=jnp.asarray(lens))
        got = tCF.DynamicRNN()(cell(tR, _t(w)), _t(xs), tstate, sequence_length=_t(lens))
    else:
        want = jCF.StaticRNN()(cell(jR, jnp.asarray(w)), jnp.asarray(xs), jstate)
        got = tCF.StaticRNN()(cell(tR, _t(w)), _t(xs), tstate)
    for g, v in zip([got[0], *got[1]], [want[0], *want[1]]):
        np.testing.assert_allclose(_np(g), np.asarray(v), rtol=RNN_TOL, atol=RNN_TOL)
