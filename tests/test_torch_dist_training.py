"""``Trainer(mesh=, sharding_rules=)`` of the port against the JAX
``Trainer`` on a mesh of the same shape, and against the port's own
single-rank ``Trainer``: the default exchange under each rule table.

Five Momentum steps of the MNIST MLP (batch 16) and of a 2-layer GPT (d
64, 4 heads of 16, seq 64, batch 8, f32, flash attention and the chunked
CE, labels with pads) at dp=4, fsdp=4 (``fsdp(64)``) and dp2×tp2
(``transformer_tp_rules``); and each param's placements on the mesh
against the JAX spec of its name. Both packages start from the JAX
package's initial params (written here, read by the ranks). The port's
side runs on one spawned gloo world of 4 ranks (``torch_dist_worker.py``,
suite "training"); the JAX side on 4 of ``conftest``'s 8 virtual CPU
devices. The other exchanges are in test_torch_dist_exchanges.py.

Tolerances: losses 1e-5 relative; final params 1e-5 of the param's
largest magnitude (f32 sums in another order: the all-reduce, DTensor's
matmul shards). The single-rank Trainer on the whole batch computes the
same global mean, so the mesh is held to it at 1e-5 too."""

import os
import sys

import numpy as np
import pytest

import jax

import paddle_tpu as pt
from paddle_tpu.parallel import fsdp as jfsdp
from paddle_tpu.parallel import transformer_tp_rules as jtp

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as W  # noqa: E402
from torch_dist_jax import jax_run, write_initial_params  # noqa: E402

CASES = W.TRAIN_CASES


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("training_world"))
    write_initial_params(d)
    return dict(np.load(W.spawn_world("training", d, d)), _dir=d)


@pytest.fixture(scope="module")
def jax_results():
    return {name: jax_run(*case) for name, case in CASES.items()}


def _params(res, name, key="param"):
    pre = f"{name}/{key}/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


def _close_params(got, want, tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=tol * max(np.abs(want[k]).max(), 1e-30), err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_training_matches_paddle_tpu(world, jax_results, name):
    losses, params = jax_results[name]
    np.testing.assert_allclose(world[f"{name}/losses"], losses, rtol=1e-5)
    _close_params(_params(world, name), params, 1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_training_matches_the_single_rank_trainer(world, name):
    np.testing.assert_allclose(world[f"{name}/losses"], world[f"{name}/single_losses"],
                               rtol=1e-5)
    _close_params(_params(world, name), _params(world, name, "single_param"), 1e-5)


@pytest.mark.parametrize("name", ["gpt_fsdp", "gpt_dp_tp"])
def test_params_are_placed_by_the_rules(world, name):
    """Each param's DTensor placements are the JAX spec of its name on the
    mesh, and its local shard the matching slice."""
    from paddle_tpu_torch.parallel import sharding as tsh

    _, axes, rules, _ = CASES[name]
    jmesh = pt.make_mesh(axes, devices=jax.devices()[:4])
    jr = {"fsdp": jfsdp(W.FSDP_MIN), "tp": jtp()}[rules].adapted_to(jmesh)
    specs = {k[len(f"{name}/spec/"):]: str(v) for k, v in world.items()
             if k.startswith(f"{name}/spec/")}
    sharded = 0
    for k, got in specs.items():
        shape = tuple(world[f"{name}/param/{k}"].shape)
        want = tuple(jr.spec_for(k, shape, jmesh))
        want = want + (None,) * (len(shape) - len(want))
        assert got == repr(tsh.P(*want)), k
        local = list(shape)
        for i, entry in enumerate(tuple(want)):
            for a in ((entry,) if isinstance(entry, str) else (entry or ())):
                local[i] //= axes[a]
        assert world[f"{name}/local_shape/{k}"].tolist() == local, k
        sharded += local != list(shape)
    assert sharded >= 4
