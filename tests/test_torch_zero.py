"""ZeRO (``DistStrategy(zero_sharding=True)``) and ZeRO-aware checkpoints
of the port against the JAX package.

On one spawned gloo world of 4 ranks (``torch_dist_worker.py``, suite
"zero"): five Momentum steps of the MNIST MLP and of a 2-layer GPT at
dp=4 with ZeRO, against the JAX ZeRO Trainer on 4 virtual CPU devices
and against the port's single-rank Trainer; the (N, k) row layout and the
all-gather byte count; a port ZeRO checkpoint (per-shard
``*.zero{i}.npz``) restored at the same layout, bit for bit; the layout
gate and the gather on ``allow_reshard``; a ZeRO checkpoint written by
``paddle_tpu`` restored in the port; and an fsdp trainer's checkpoint,
which is saved unsharded.

Tolerances: losses 1e-5 relative and params 1e-5 of each param's largest
magnitude (the reduce-scatter and all-gather sum in another order than
the JAX program and than one device); the same-layout restore and the
JAX checkpoint's params bit-equal (npz rows copied as they are)."""

import os
import sys

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import io as jio

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as W  # noqa: E402
from torch_dist_jax import jax_run, jax_trainer, write_initial_params  # noqa: E402

CASES = W.ZERO_CASES
EXACT = ["gpt_zero", "mnist_zero"]


def _jax_checkpoint(d):
    """A JAX ZeRO trainer's checkpoint after one step, its logical params
    then, and the loss of the step it takes next (on feeds[2])."""
    model, axes, rules, skw = CASES["mnist_zero"]
    tr = jax_trainer(model, axes, rules, skw)
    feeds = W.mnist_feeds()
    tr.step(feeds[0])
    jio.save_trainer(os.path.join(d, "jax_zero_ck"), tr)
    params = {k: np.asarray(v) for k, v in tr._logical_params().items()}
    return params, float(tr.step(feeds[2])["loss"])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("zero_world"))
    write_initial_params(d)
    jck = _jax_checkpoint(d)
    world = dict(np.load(W.spawn_world("zero", d, d)))
    return world, jck, d


@pytest.fixture(scope="module")
def world(setup):
    return setup[0]


def _params(res, name, key="param"):
    pre = f"{name}/{key}/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


def _close(got, want, tol=1e-5):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=tol * max(np.abs(want[k]).max(), 1e-30), err_msg=k)


@pytest.mark.parametrize("name", EXACT)
def test_zero_training_matches_paddle_tpu(world, name):
    losses, params = jax_run(*CASES[name])
    np.testing.assert_allclose(world[f"{name}/losses"], losses, rtol=1e-5)
    _close(_params(world, name), params)


def test_zero_with_the_int8_exchange_matches_paddle_tpu(setup):
    """ZeRO composed with the int8 exchange (error feedback, blocks of 64)
    against the JAX package's composition, at the int8 exchange's
    tolerance (test_torch_dist_training.py states it: losses 1e-4
    relative, params 1% of each param's move)."""
    world, _, d = setup
    losses, params = jax_run(*CASES["mnist_zero_int8"])
    np.testing.assert_allclose(world["mnist_zero_int8/losses"], losses, rtol=1e-4)
    p0 = dict(np.load(os.path.join(d, "params_mnist.npz")))
    got = _params(world, "mnist_zero_int8")
    for k in params:
        assert np.abs(got[k] - params[k]).max() <= 0.01 * np.abs(params[k] - p0[k]).max(), k


@pytest.mark.parametrize("name", EXACT)
def test_zero_training_matches_the_single_rank_trainer(world, name):
    np.testing.assert_allclose(world[f"{name}/losses"], world[f"{name}/single_losses"],
                               rtol=1e-5)
    _close(_params(world, name), _params(world, name, "single_param"))


@pytest.mark.parametrize("name", sorted(CASES))
def test_row_layout_and_allgather_bytes(world, name):
    """Each rank keeps one (1, k) row a param; the top-of-step all-gather
    moves (N-1)·k·itemsize a param (zero.allgather_bytes_per_step)."""
    from paddle_tpu.parallel import zero as jzero
    params = _params(world, name)
    n = 4
    sizes = [int(np.prod(v.shape)) for v in params.values()]
    assert int(world[f"{name}/allgather_bytes"]) == sum((n - 1) * -(-s // n) * 4
                                                        for s in sizes)
    first = next(iter(params.values()))
    assert world[f"{name}/row_shape"].tolist() == [1, -(-first.size // n)]
    assert jzero.row_size(first.shape, n) == -(-first.size // n)


def test_same_layout_restore_is_bit_equal(world):
    assert float(world["restore/bit_equal"][0]) == 1.0
    a, b = world["restore/next_loss"]
    assert a == b
    files = set(world["restore/files"].tolist())
    assert {f"params.zero{i}.npz" for i in range(4)} <= files
    assert {f"opt_state.zero{i}.npz" for i in range(4)} <= files
    assert "params.npz" not in files and "manifest.json" in files


def test_layout_change_is_gated_and_gathers_on_request(world):
    assert int(world["restore/gated"]) == 1
    assert int(world["restore/gathered_equal"]) == 1


def test_a_paddle_tpu_zero_checkpoint_restores_in_the_port(setup):
    world, (params, next_loss), d = setup
    got = _params(world, "jax_ck")
    assert set(got) == set(params)
    for k in params:
        np.testing.assert_array_equal(got[k], params[k], err_msg=k)
    assert int(world["jax_ck/global_step"]) == 1
    np.testing.assert_allclose(float(world["jax_ck/next_loss"]), next_loss, rtol=1e-5)
    # and the JAX package reads the port's: the same files, gathered
    p, _, _, meta = jio.load_persistables(os.path.join(d, "port_zero_ck"))
    assert meta["zero"]["shards"] == 4 and meta["zero_axes"] == {"dp": 4}
    assert set(p) == set(params)


def test_a_mesh_checkpoint_is_saved_unsharded(setup):
    world, _, d = setup
    assert eval(str(world["fsdp_ck/mesh_axes"])) == {"fsdp": 4}
    p, _, _, meta = jio.load_persistables(os.path.join(d, "port_fsdp_ck"))
    init = dict(np.load(os.path.join(d, "params_gpt.npz")))
    assert {k: v.shape for k, v in p.items()} == {k: v.shape for k, v in init.items()}
    for k, v in p.items():
        np.testing.assert_array_equal(np.asarray(v), init[k], err_msg=k)
    assert pt.io is jio
