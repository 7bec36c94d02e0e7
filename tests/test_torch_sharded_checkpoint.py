"""The port's sharded checkpoints (``io.save_sharded``, ``load_sharded``,
``wait_for_checkpoints``, ``save_trainer_sharded``,
``load_trainer_sharded`` on ``torch.distributed.checkpoint``) on the CPU,
case for case with tests/test_orbax_checkpoint.py:29-69.

The JAX package writes orbax's files and the port DCP's, and neither reads
the other's: the trainer case holds the port's restored state against the
JAX package's restored state, from the same initial params
(``params_from_jax``) and the same feeds, the params at rtol 1e-6 and the
next step's loss at rtol 1e-6 (three Adam steps of a 6→3 head in f32 on
both packages). The port's own Trainer writes its params and moments in
place, so an async save that a step follows at once must still write the
values from before that step. The restore across a mesh reshape
(tests/test_orbax_checkpoint.py:71-91) runs in the world of 4 ranks of
tests/test_torch_elastic.py."""

import numpy as np
import pytest

import jax.numpy as jnp

import paddle_tpu as jpt
from paddle_tpu import io as jio
from paddle_tpu import layers as jL
from paddle_tpu import optimizer as jopt

import torch

import paddle_tpu_torch as tpt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import layers as tL
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import params_from_jax

CPU = tpt.CPUPlace()


def _feed(rng):
    x = rng.randn(8, 6).astype(np.float32)
    y = rng.randint(0, 3, (8, 1)).astype(np.int64)
    return {"x": x, "label": y}


def _jtrainer():
    prog = jpt.build(lambda x, label: {
        "loss": jL.mean(jL.softmax_with_cross_entropy(jL.fc(x, 3, name="head"), label))})
    return jpt.Trainer(prog, jopt.Adam(1e-2), loss_name="loss")


def _head(x, label):
    return {"loss": tL.mean(tL.softmax_with_cross_entropy(tL.fc(x, 3, name="head"), label))}


def _ttrainer(params=None):
    tr = tpt.Trainer(tpt.build(_head), topt.Adam(1e-2), loss_name="loss", place=CPU)
    return tr.startup(0, sample_feed=_feed(np.random.RandomState(0)), params=params)


def test_save_load_sharded_roundtrip(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4, dtype=torch.int32)}}
    d = str(tmp_path / "ck")
    tio.save_sharded(d, tree, async_save=False)
    back = tio.load_sharded(d, device="cpu")
    assert torch.equal(back["a"], tree["a"]) and back["a"].device.type == "cpu"
    assert back["b"]["c"].dtype == torch.int32 and bool((back["b"]["c"] == 1).all())
    # into a target of the caller's, in place
    target = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4, dtype=torch.int32)}}
    a_before = target["a"]
    assert tio.load_sharded(d, target) is target and target["a"] is a_before
    assert torch.equal(target["a"], tree["a"])


def test_async_save_with_barrier(tmp_path):
    tree = {"w": torch.full((128, 128), 3.0)}
    d = str(tmp_path / "ck_async")
    fut = tio.save_sharded(d, tree, async_save=True)
    tio.wait_for_checkpoints()
    assert fut.done()
    back = tio.load_sharded(d, device="cpu")
    assert bool((back["w"] == 3.0).all())
    tio.wait_for_checkpoints()  # nothing in flight: returns at once


def test_async_save_holds_the_values_before_the_next_step(tmp_path):
    """The port's step writes params and Adam's moments in place: an async
    save followed at once by a step must still write what the trainer held
    when the save was called."""
    rng = np.random.RandomState(3)
    tr = _ttrainer()
    for _ in range(2):
        tr.step(_feed(rng))
    want = {k: v.detach().clone() for k, v in tr.scope.params.items()}
    want_m = {k: a["moment1"].clone() for k, a in tr.scope.opt_state["accums"].items()}
    d = str(tmp_path / "ck")
    tio.save_trainer_sharded(d, tr, async_save=True)
    tr.step(_feed(rng))  # writes the same tensors in place, at once
    assert not torch.equal(tr.scope.params["head/w"], want["head/w"])
    tio.wait_for_checkpoints()
    back = _ttrainer()
    tio.load_trainer_sharded(d, back)
    assert back.global_step == 2
    assert all(torch.equal(back.scope.params[k], v) for k, v in want.items())
    assert all(torch.equal(back.scope.opt_state["accums"][k]["moment1"], v)
               for k, v in want_m.items())


def test_trainer_sharded_checkpoint_roundtrip(tmp_path):
    """Both packages train from the same params on the same feeds, save
    sharded (orbax, DCP) and restore into fresh trainers: the port's
    restored params and next loss against the JAX package's."""
    rng = np.random.RandomState(0)
    feeds = [_feed(rng) for _ in range(5)]
    jtr = _jtrainer()
    jtr.startup(sample_feed=feeds[0])
    init = {k: np.asarray(v) for k, v in jtr.scope.params.items()}
    ttr = _ttrainer(params_from_jax(init, device="cpu"))
    for f in feeds[1:4]:
        jtr.step(f)
        ttr.step(f)
    jd, td = str(tmp_path / "jax_ck"), str(tmp_path / "port_ck")
    jio.save_trainer_sharded(jd, jtr, async_save=True)
    jio.wait_for_checkpoints()
    tio.save_trainer_sharded(td, ttr, async_save=True)
    tio.wait_for_checkpoints()

    jback = _jtrainer()
    jback.startup(sample_feed=feeds[0])
    jio.load_trainer_sharded(jd, jback)
    tback = _ttrainer()
    tio.load_trainer_sharded(td, tback)
    assert tback.global_step == ttr.global_step == jback.global_step == 3
    for k in init:
        assert torch.equal(tback.scope.params[k], ttr.scope.params[k]), k
        np.testing.assert_allclose(tback.scope.params[k].detach().numpy(),
                                   np.asarray(jback.scope.params[k]), rtol=1e-6, atol=0)
    # training goes on from the restored state as from the saved one
    f = _feed(np.random.RandomState(42))
    l_saved, l_back = float(ttr.step(f)["loss"]), float(tback.step(f)["loss"])
    assert l_saved == l_back
    np.testing.assert_allclose(l_back, float(jback.step(f)["loss"]), rtol=1e-6)


def test_load_sharded_without_target_keeps_dotted_keys(tmp_path):
    """With no target the tree is built from the checkpoint's metadata:
    the key paths DCP's planner recorded, never a flat key split on '.'."""
    tree = {"a.b": torch.arange(3.0), "c": {"d.e": torch.ones(2, dtype=torch.int32),
                                            "f": {"g": torch.zeros(2, 2)}},
            "meta": {"global_step": 7}}
    d = str(tmp_path / "ck")
    tio.save_sharded(d, tree)
    back = tio.load_sharded(d, device="cpu")
    assert sorted(back) == ["a.b", "c", "meta"] and sorted(back["c"]) == ["d.e", "f"]
    assert torch.equal(back["a.b"], tree["a.b"]) and torch.equal(back["c"]["d.e"],
                                                               tree["c"]["d.e"])
    assert back["c"]["f"]["g"].shape == (2, 2) and back["meta"] == {"global_step": 7}


def test_orbax_checkpoint_tree_matches_the_jax_packages(tmp_path):
    """The trees the two packages write hold the same entries: params,
    state, opt_state and meta.global_step; the formats differ, and the port
    does not read orbax's."""
    rng = np.random.RandomState(1)
    jtr = _jtrainer()
    jtr.startup(sample_feed=_feed(rng))
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    jio.save_trainer_sharded(jd, jtr, async_save=False)
    tio.save_trainer_sharded(td, _ttrainer(), async_save=False)
    jtree = jio.load_sharded(jd)
    ttree = tio.load_sharded(td, device="cpu")
    # DCP records no entry for an empty subtree (this model has no state),
    # so a tree built from its metadata has none; a target supplies it
    assert sorted(jtree) == ["meta", "opt_state", "params", "state"] and jtree["state"] == {}
    assert sorted(ttree) == ["meta", "opt_state", "params"]
    assert sorted(ttree["params"]) == sorted(jtree["params"])
    assert int(jnp.asarray(jtree["meta"]["global_step"])) == ttree["meta"]["global_step"] == 0
    with pytest.raises(Exception):
        tio.load_sharded(jd, device="cpu")  # orbax's files are not DCP's
