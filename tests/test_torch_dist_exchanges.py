"""The gradient exchanges of the port's ``Trainer(mesh=)`` other than the
default one, the loss scaler and batch norm on a sharded batch, and
``fit``/``eval`` on a mesh, against the JAX ``Trainer`` on a mesh of the
same shape and against the port's single-rank ``Trainer``.

Five Momentum steps of the MNIST MLP (batch 16) at dp=4: two
microbatches through the default exchange (``accum_steps=2``) and
through the hoisted one (``accum_exchange="hoisted"``), and the int8
exchange with error feedback (blocks of 64), each against the JAX
package; against the port's single-rank Trainer only: the int8 exchange
with stochastic rounding and the int4 exchange, a dynamic loss scaler
with an infinite pixel in one rank's rows (the skip agreed on every
rank), MNIST's conv_net (batch norm's statistics over the global batch),
and ``fit``/``eval``. Both packages start from the JAX package's initial
params. The port's side runs on one spawned gloo world of 4 ranks
(``torch_dist_worker.py``, suite "exchanges"); the JAX side on 4 of
``conftest``'s 8 virtual CPU devices.

Tolerances. Exact paths: losses 1e-5 relative, params and program state
1e-5 of the largest magnitude (f32 sums in another order). The hoisted
exchange is held against a single-rank run with ``accum_steps=2`` (the
same total grad: the mean of equal-sized microbatch means). The int8
exchange against the JAX int8 exchange: the codec is bit-equal
(test_torch_mesh_sharding.py), but its inputs, the local grads, differ
in their last bits, so a value within f32 rounding of a rounding boundary
takes the neighbouring code: that element's exchanged grad moves by one
quantum (its block's max / 127, over 4 ranks) for one step, and error
feedback hands the difference back at the next step instead of letting
it grow. So the params are held to 1% of each param's total move over
the five steps (measured: 0.41% at most, fc_0/w), and the losses to 1e-4
relative (measured 1.3e-6). Against the single-rank run (no quantization
at all) the int8 exchange is held to the quantization error itself:
losses within 1e-3 relative; int4's quantum is 127/7 = 18x int8's, so
its losses are held at 2e-2."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as W  # noqa: E402
from torch_dist_jax import jax_run, write_initial_params  # noqa: E402

CASES = W.EXCHANGE_CASES
JAX_EXACT = ["mnist_dp_accum", "mnist_hoisted"]
EXACT = JAX_EXACT + ["conv_dp", "mnist_inf_scaler"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("exchanges_world"))
    write_initial_params(d)
    return dict(np.load(W.spawn_world("exchanges", d, d)), _dir=d)


@pytest.fixture(scope="module")
def jax_results():
    return {name: jax_run(*CASES[name]) for name in JAX_EXACT + ["mnist_int8"]}


def _params(res, name, key="param"):
    pre = f"{name}/{key}/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


def _close_params(got, want, tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=tol * max(np.abs(want[k]).max(), 1e-30), err_msg=k)


@pytest.mark.parametrize("name", JAX_EXACT)
def test_exchange_matches_paddle_tpu(world, jax_results, name):
    losses, params = jax_results[name]
    np.testing.assert_allclose(world[f"{name}/losses"], losses, rtol=1e-5)
    _close_params(_params(world, name), params, 1e-5)


@pytest.mark.parametrize("name", EXACT)
def test_exchange_matches_the_single_rank_trainer(world, name):
    np.testing.assert_allclose(world[f"{name}/losses"], world[f"{name}/single_losses"],
                               rtol=1e-5)
    _close_params(_params(world, name), _params(world, name, "single_param"), 1e-5)
    # program state (batch norm's moving statistics, conv_dp) over the
    # global batch, as on one device
    _close_params(_params(world, name, "state"), _params(world, name, "single_state"), 1e-5)


def test_a_nonfinite_row_skips_the_step_on_every_rank(world):
    """One rank's batch slice holds an infinite pixel at step 3: the loss
    scaler's finiteness is global, so the step is skipped (the scale
    halved, the params kept) as on one device, not on one rank alone."""
    scales = world["mnist_inf_scaler/scales"]
    np.testing.assert_array_equal(scales, world["mnist_inf_scaler/single_scales"])
    assert scales[2] == scales[1] / 2 and scales[1] == scales[0]


def test_batch_norm_statistics_are_global(world):
    state = _params(world, "conv_dp", "state")
    assert state and any("mean" in k for k in state)


def test_int8_exchange_matches_paddle_tpu(world, jax_results):
    losses, params = jax_results["mnist_int8"]
    np.testing.assert_allclose(world["mnist_int8/losses"], losses, rtol=1e-4)
    p0 = dict(np.load(os.path.join(world["_dir"], "params_mnist.npz")))
    got = _params(world, "mnist_int8")
    for k in params:
        move = np.abs(params[k] - p0[k]).max()
        assert np.abs(got[k] - params[k]).max() <= 0.01 * move, k
    # and it is not the exact exchange: the wire is int8, within its error
    single = world["mnist_int8/single_losses"]
    np.testing.assert_allclose(world["mnist_int8/losses"], single, rtol=1e-3)
    assert not np.array_equal(world["mnist_int8/losses"], single)


@pytest.mark.parametrize("name, tol", [("mnist_int8_sr", 1e-3), ("mnist_int4", 2e-2)])
def test_other_wires_stay_within_their_quantization(world, name, tol):
    """Stochastic rounding (int8) and int4 codes against the exact exchange
    on one rank; each parts from the deterministic int8 run."""
    np.testing.assert_allclose(world[f"{name}/losses"], world[f"{name}/single_losses"],
                               rtol=tol)
    assert not np.array_equal(world[f"{name}/losses"], world["mnist_int8/losses"])


def test_wire_bytes_of_the_exchanges(world):
    fp32, int8 = world["mnist_int8/wire_bytes"]
    assert fp32 == world["mnist_hoisted/wire_bytes"][1] == world["mnist_hoisted/wire_bytes"][0]
    # int8 codes plus one f32 scale per 64 codes: a little under 4x less
    assert 3.5 < fp32 / int8 < 4.0
    fp32_4, int4 = world["mnist_int4/wire_bytes"]
    assert fp32_4 == fp32 and 7.0 < fp32 / int4 < 8.0


def test_fit_and_eval_on_a_mesh(world):
    """``fit`` over the same batches takes the step loop's steps; ``eval``
    gives the single-rank Trainer's loss from the same params."""
    assert int(world["fit/global_step"]) == W.STEPS
    got, want = _params(world, "fit"), _params(world, "loop")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    a, b = world["eval/loss"]
    np.testing.assert_allclose(a, b, rtol=1e-5)
