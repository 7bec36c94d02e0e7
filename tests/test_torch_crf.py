"""The port's linear-chain CRF against ``paddle_tpu.layers.crf`` on the CPU:
``linear_chain_crf`` (its parameter from the JAX package's init, carried
across), ``crf_nll`` and ``crf_decoding``, with ragged lengths, a length
of 1 and ties.

Tolerances: the nll within 1e-5 (rtol and atol: f32 logsumexp in another
order); its grads (emission and transition, by ``torch.autograd`` against
``jax.grad``) within 1e-5 of the largest; the decoded tags equal exactly,
ties included (both take the first maximum)."""

import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as jpt
from paddle_tpu.layers import crf as jC

import paddle_tpu_torch as tpt
from paddle_tpu_torch.framework import params_from_jax
from paddle_tpu_torch.layers import crf as tC

CPU = tpt.CPUPlace()
TOL, GRAD_TOL = 1e-5, 1e-5
B, T, N = 4, 6, 5
LENGTHS = np.array([6, 3, 1, 5], np.int32)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    emission = rng.randn(B, T, N).astype(np.float32)
    label = rng.randint(0, N, (B, T)).astype(np.int32)
    transition = (0.5 * rng.randn(N + 2, N)).astype(np.float32)
    return emission, label, transition


def test_linear_chain_crf_matches_jax():
    emission, label, _ = _inputs()

    def make(C):
        return lambda e, y, l: C.linear_chain_crf(e, y, l, name="crf")[0]

    jprog = jpt.build(make(jC))
    jin = [jnp.asarray(a) for a in (emission, label, LENGTHS)]
    jparams, _ = jprog.init(jax.random.PRNGKey(0), *jin)
    jparams = {k: np.asarray(v) for k, v in jparams.items()}
    prog = tpt.build(make(tC))
    tparams, _ = prog.init(0, _t(emission), _t(label), _t(LENGTHS), place=CPU)
    assert sorted(tparams) == sorted(jparams) == ["crf/transition"]
    assert tparams["crf/transition"].shape == (N + 2, N)
    assert float(tparams["crf/transition"].abs().max()) <= 0.1  # Uniform(-0.1, 0.1)
    jout, _ = jprog.apply(jparams, {}, *jin)
    out, _ = prog.apply(params_from_jax(jparams, prog.param_info, device="cpu"), {},
                        _t(emission), _t(label), _t(LENGTHS), place=CPU)
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crf_nll_and_its_grads_match_jax(seed):
    emission, label, transition = _inputs(seed)
    cot = np.random.RandomState(seed + 10).randn(B).astype(np.float32)

    def jloss(e, tr):
        return jnp.sum(jC.crf_nll(e, jnp.asarray(label), jnp.asarray(LENGTHS), tr) * cot)

    want = jC.crf_nll(jnp.asarray(emission), jnp.asarray(label), jnp.asarray(LENGTHS),
                      jnp.asarray(transition))
    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(emission), jnp.asarray(transition))
    e, tr = _t(emission).requires_grad_(True), _t(transition).requires_grad_(True)
    got = tC.crf_nll(e, _t(label), _t(LENGTHS), tr)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL, atol=TOL)
    (got * _t(cot)).sum().backward()
    for g, w in ((e.grad, jg[0]), (tr.grad, jg[1])):
        w = np.asarray(w)
        assert float(np.abs(_np(g) - w).max()) / float(np.abs(w).max()) <= GRAD_TOL


def test_crf_nll_is_the_brute_force_nll():
    """Exp-sum over every path of a short sequence, in float64."""
    emission, label, transition = _inputs(3)
    start, end, trans = transition[0], transition[1], transition[2:]
    n = int(LENGTHS[1])
    em, lab = emission[1, :n].astype(np.float64), label[1, :n]

    def score(path):
        s = start[path[0]] + end[path[-1]] + sum(em[i, p] for i, p in enumerate(path))
        return s + sum(trans[a, b] for a, b in zip(path[:-1], path[1:]))

    logz = np.log(sum(np.exp(score(p)) for p in itertools.product(range(N), repeat=n)))
    got = tC.crf_nll(_t(emission), _t(label), _t(LENGTHS), _t(transition))
    np.testing.assert_allclose(float(got[1]), logz - score(lab), rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_crf_decoding_ids_equal_jax(seed):
    emission, _, transition = _inputs(seed)
    want = jC.crf_decoding(jnp.asarray(emission), jnp.asarray(LENGTHS),
                           jnp.asarray(transition))
    got = tC.crf_decoding(_t(emission), _t(LENGTHS), _t(transition))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert (_np(got)[np.arange(T)[None, :] >= LENGTHS[:, None]] == 0).all()


def test_crf_decoding_breaks_ties_as_jax():
    """Integer scores and a flat transition make many paths tie: both
    packages take the first maximum at every step."""
    rng = np.random.RandomState(7)
    emission = rng.randint(0, 2, (B, T, N)).astype(np.float32)
    transition = np.zeros((N + 2, N), np.float32)
    transition[2:, 1] = 1.0
    want = jC.crf_decoding(jnp.asarray(emission), jnp.asarray(LENGTHS),
                           jnp.asarray(transition))
    got = tC.crf_decoding(_t(emission), _t(LENGTHS), _t(transition))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_crf_decoding_is_the_best_path():
    emission, _, transition = _inputs(4)
    start, end, trans = transition[0], transition[1], transition[2:]
    n = int(LENGTHS[3])
    em = emission[3, :n].astype(np.float64)

    def score(path):
        s = start[path[0]] + end[path[-1]] + sum(em[i, p] for i, p in enumerate(path))
        return s + sum(trans[a, b] for a, b in zip(path[:-1], path[1:]))

    best = max(itertools.product(range(N), repeat=n), key=score)
    got = tC.crf_decoding(_t(emission), _t(LENGTHS), _t(transition))
    assert tuple(_np(got)[3, :n]) == best
