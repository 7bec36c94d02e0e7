"""Elastic training of the port (``resilience.reshard_restore``,
``restore_latest(elastic=True)``, ``ResizeRequest``, ``fit(elastic=,
resize=)``) against ``paddle_tpu`` on the CPU: tests/test_elastic_reshard.py
:106-388 (its nine tests and the four dp N→M cases), the three resize
tests of tests/test_resilience.py:543-626, and the sharded restore across
a mesh reshape of tests/test_orbax_checkpoint.py:71-91.

Two spawned gloo worlds run the port's meshes (``torch_dist_worker.py``,
suites "elastic4" then "elastic2"); the one-device side runs in this
process. A flow that would need a third world takes its other side from
the JAX package, which writes that checkpoint from its trainer on
``conftest``'s virtual devices (the dp=2 sources of the world of 4:
Momentum, amp, param-sharded rules, the batch-6 fit and the K=2 run that
crashes at step 4); the two packages share the npz checkpoint format. Each
restore of the port is held bit for bit against the JAX package's restore
of the same directory at the same mesh (params, the flat optimizer state,
the loss-scale state), each ``ReshardError`` text against the JAX
package's, and each elastic rejoin's losses bit for bit against the port's
own bare-step continuation of the same checkpoint and at rtol 1e-5 against
the JAX package's."""

import os
import shutil
import signal
import sys

import numpy as np
import pytest

import jax

import paddle_tpu as jpt
from paddle_tpu import io as jio
from paddle_tpu import optimizer as jopt
from paddle_tpu import layers as jL
from paddle_tpu import resilience as jres
from paddle_tpu.data.feeder import DataFeeder as JFeeder
from paddle_tpu.parallel import DistStrategy as JStrategy
from paddle_tpu.parallel import ShardingRules as JRules
from paddle_tpu.testing import faults
from jax.sharding import PartitionSpec as JP

import torch

import paddle_tpu_torch as tpt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import resilience as tres

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as W  # noqa: E402


def _jnet(x, label):
    h = jL.fc(x, 16, name="fc1")
    logits = jL.fc(h, W.E_CLASSES, name="fc2")
    return {"loss": jL.mean(jL.softmax_with_cross_entropy(logits, label))}


def _jt(n=1, momentum=False, strategy=None, rules=None):
    mesh = jpt.make_mesh({"dp": n}, devices=jax.devices()[:n]) if n > 1 else None
    tr = jpt.Trainer(jpt.build(_jnet), jopt.Momentum(0.1, 0.9) if momentum else jopt.SGD(0.1),
                     loss_name="loss", mesh=mesh, sharding_rules=rules, strategy=strategy)
    tr.startup(sample_feed=W.E_FEED)
    return tr


def _jfit(tr, root, reader=None, epochs=2, handler=None, step_interval=0, **kw):
    cfg = jpt.CheckpointConfig(root, epoch_interval=0, step_interval=step_interval,
                               max_num_checkpoints=3)
    return jpt.fit(tr, reader or W.e_reader(), num_epochs=epochs, feed_names=["x", "label"],
                   dtypes=["float32", "int64"], checkpoint_config=cfg, event_handler=handler,
                   **kw)


def _jmanual(tr, meta, epochs=2):
    feeder = JFeeder(["x", "label"], ["float32", "int64"])
    losses = []
    for epoch in range(int(meta.get("epoch", 0)), epochs):
        skip = int(meta.get("epoch_step", 0)) if epoch == int(meta.get("epoch", 0)) else 0
        for i, samples in enumerate(W.e_reader()()):
            if i >= skip:
                losses.append(float(tr.step(feeder.feed(samples))["loss"]))
    return losses


def _jstate(tr):
    """The JAX trainer's state as the worlds record the port's."""
    out = {f"param/{k}": np.asarray(v) for k, v in jax.device_get(tr.scope.params).items()}
    out.update({f"opt/{k}": v for k, v in
                jio._flatten(jax.device_get(tr.scope.opt_state or {})).items()})
    ls = getattr(tr.scope, "loss_scale_state", None) or {}
    out.update({f"ls/{k}": np.asarray(v) for k, v in jax.device_get(ls).items()})
    return out


def _held(res, name, jtr):
    """The port's recorded restore ``name`` bit for bit against the JAX
    trainer's restore of the same directory."""
    want = _jstate(jtr)
    got = {k[len(name) + 1:]: v for k, v in res.items()
           if k.startswith(f"{name}/") and k.split("/")[1] in ("param", "opt", "ls")}
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    assert int(res[f"{name}/global_step"]) == jtr.global_step


def _jax_sources(d):
    """The dp=2 checkpoints the world of 4 restores, from the JAX package."""
    src = _jt(2, momentum=True)
    src.step(W.E_FEED)
    src.step(W.E_FEED)
    jio.save_trainer(os.path.join(d, "j2_mom_ck"), src)
    amp = _jt(2, strategy=JStrategy(**W.E_AMP))
    amp.step(W.E_FEED)
    jio.save_trainer(os.path.join(d, "j2_amp_ck"), amp)
    ruled = _jt(2, rules=JRules([(r".*/w$", JP(None, "dp"))]))
    ruled.step(W.E_FEED)
    jio.save_trainer(os.path.join(d, "j2_rules_ck"), ruled)
    plain = _jt(2)
    plain.step(W.E_FEED)
    jio.save_trainer(os.path.join(d, "j2_sgd_ck"), plain)
    _jfit(_jt(2), os.path.join(d, "j_fit6"), reader=W.e_reader(4, seed=5, bs=6), epochs=1,
          step_interval=2)
    with pytest.raises(faults.InjectedCrash):
        _jfit(_jt(2), os.path.join(d, "j_k2"), epochs=1, step_interval=2,
              steps_per_dispatch=2, handler=faults.crash_at_step(4))
    newest = jres.list_checkpoints(os.path.join(d, "j_k2"))[-1]
    assert newest.global_step == 2
    shutil.copytree(newest.path, os.path.join(d, "j_k2_ref"))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("elastic_worlds"))
    src = W.e_trainer(1, momentum=True)
    src.step(W.E_FEED)
    src.step(W.E_FEED)
    tio.save_trainer(os.path.join(d, "p1_mom_ck"), src)
    one = W.e_trainer(1)
    one.step(W.E_FEED)
    tio.save_trainer(os.path.join(d, "p1_sgd_ck"), one)
    _jax_sources(d)
    res4 = dict(np.load(W.spawn_world("elastic4", d, d)))
    res2 = dict(np.load(W.spawn_world("elastic2", d, d, world=2)))
    return d, res4, res2


# -- bit-exact reshard restores, dp N→M (tests/test_elastic_reshard.py:105-126) -----


@pytest.mark.parametrize("n,m", [(2, 1), (1, 2), (4, 2), (2, 4)])
def test_reshard_restore_bit_exact_params_and_optstate(worlds, n, m):
    d, res4, res2 = worlds
    ck = {(2, 1): "p2_mom_ck", (1, 2): "p1_mom_ck", (4, 2): "p4_mom_ck",
          (2, 4): "j2_mom_ck"}[(n, m)]
    ck = os.path.join(d, ck)
    if m == 1:  # the one-device side, here
        tgt = W.e_trainer(1, momentum=True)
        rep = tres.reshard_restore(ck, tgt, sample_feed=W.E_FEED)
        res = {}
        W._record_state(res, "here", tgt)
        res["here/next_loss"] = np.array(float(tgt.step(W.E_FEED)["loss"]))
        name, report = "here", (rep["saved_axes"], rep["target_axes"], rep["global_step"],
                                rep["bytes_moved"] > 0)
        assert report == ({"dp": 2}, None, 2, True)
    else:
        res, name = (res2, f"r{n}to{m}") if m == 2 else (res4, f"r{n}to{m}")
        saved = None if n == 1 else {"dp": n}
        assert str(res[f"{name}/report"]) == repr((saved, {"dp": m}, 2, True))
    jtr = _jt(m, momentum=True)
    jres.reshard_restore(ck, jtr, sample_feed=W.E_FEED)
    _held(res, name, jtr)
    want = jio.load_persistables(ck)[0]
    for k, v in want.items():
        assert np.array_equal(res[f"{name}/param/{k}"], np.asarray(v)), k
    assert np.isfinite(float(res[f"{name}/next_loss"]))


def test_reshard_restore_amp_dynamic_loss_scale(worlds):
    d, res4, _ = worlds
    jtr = _jt(4, strategy=JStrategy(**W.E_AMP))
    jres.reshard_restore(os.path.join(d, "j2_amp_ck"), jtr, sample_feed=W.E_FEED)
    _held(res4, "amp", jtr)
    ls = jio.load_persistables(os.path.join(d, "j2_amp_ck"))[3]["loss_scale_state"]
    assert {k: float(res4[f"amp/ls/{k}"]) for k in ls} == {k: float(v) for k, v in ls.items()}
    assert np.isfinite(float(res4["amp/next_loss"]))


def test_reshard_restore_param_sharded_rules(worlds):
    d, res4, _ = worlds
    jtr = _jt(4, rules=JRules([(r".*/w$", JP(None, "dp"))]))
    jres.reshard_restore(os.path.join(d, "j2_rules_ck"), jtr, sample_feed=W.E_FEED)
    _held(res4, "rules", jtr)
    assert tuple(jtr.scope.params["fc1/w"].sharding.spec) == (None, "dp")
    # the target is really sharded: each rank holds a quarter of the columns
    assert str(res4["rules/spec"]) == "P(None, 'dp')"
    assert tuple(res4["rules/local_shape"]) == (W.E_DIM, 4)
    assert np.isfinite(float(res4["rules/next_loss"]))


# -- structured errors on the implicit paths (:171-270) -------------------------------


def test_mesh_mismatch_is_structured_not_device_put(worlds):
    d, _, res2 = worlds
    root = os.path.join(d, "mm_root")
    with pytest.raises(jres.ReshardError) as ei:
        jio.load_trainer(os.path.join(root, "step_3"), _jt(2))
    assert str(res2["mm_load/error"]) == str(ei.value)
    assert str(res2["mm_load/axes"]) == repr(({"dp": 4}, {"dp": 2}))
    assert "reshard_restore" in str(res2["mm_load/error"])
    # resume scanning re-raises instead of falling back to step_1
    assert str(res2["mm_latest/error"]) == str(ei.value)
    # elastic scanning reshards the newest checkpoint instead
    assert int(res2["mm_elastic/global_step"]) == 3 == int(res2["mm_elastic/meta_step"])


def test_fit_resume_without_elastic_surfaces_cleanly(worlds):
    d, _, res2 = worlds
    with pytest.raises(jres.ReshardError, match="elastic=True") as ei:
        _jfit(_jt(2), os.path.join(d, "fit4"), resume=True)
    assert "elastic=True" in str(res2["fit_resume/error"])
    assert str(res2["fit_resume/error"]) == str(ei.value)
    assert "EnforceError" in str(res2["fit_elastic_alone"])
    assert "elastic" in str(res2["fit_elastic_alone"]).split(":", 1)[1]


@pytest.fixture
def world_of_one():
    """A gloo world of one in this process (a {dp: 1} mesh), taken down
    after the test."""
    import socket
    import torch.distributed as dist
    from paddle_tpu_torch import parallel as par

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    par.initialize(place=tpt.CPUPlace(), init_method=f"tcp://127.0.0.1:{port}",
                   world_size=1, rank=0)
    try:
        yield par.make_mesh({"dp": 1})
    finally:
        dist.destroy_process_group()


def test_size_one_axes_do_not_trip_the_gate(tmp_path, world_of_one):
    """{"dp": 1} and no mesh place alike: plain load_trainer both ways,
    as in the JAX package."""
    from paddle_tpu_torch import optimizer
    src = W.e_trainer(1)
    src.step(W.E_FEED)
    ck = str(tmp_path / "ck1")
    tio.save_trainer(ck, src)
    one = tpt.Trainer(tpt.build(W._e_net), optimizer.SGD(0.1), loss_name="loss",
                      mesh=world_of_one).startup(0, sample_feed=W.E_FEED)
    tio.save_trainer(str(tmp_path / "ck2"), one)
    assert tres.read_manifest(str(tmp_path / "ck2"))["meta"]["mesh_axes"] == {"dp": 1}
    tio.load_trainer(str(tmp_path / "ck2"), src)
    tio.load_trainer(ck, one)
    assert torch.equal(one.scope.params["fc1/w"].full_tensor(), src.scope.params["fc1/w"])
    # the JAX package passes the same pair through its gate
    jone = jpt.Trainer(jpt.build(_jnet), jopt.SGD(0.1), loss_name="loss",
                       mesh=jpt.make_mesh({"dp": 1}, devices=jax.devices()[:1]))
    jone.startup(sample_feed=W.E_FEED)
    jio.load_trainer(ck, jone)


def test_single_device_checkpoint_is_gated_at_mesh_restore(worlds):
    d, _, res2 = worlds
    ck = os.path.join(d, "p1_sgd_ck")
    assert tres.read_manifest(ck)["meta"]["mesh_axes"] == {}
    assert str(res2["single_gate/axes"]) == repr((None, {"dp": 2}))
    with pytest.raises(jres.ReshardError) as ei:
        jio.load_trainer(ck, _jt(2))
    assert str(res2["single_gate/error"]) == str(ei.value)
    jtr = _jt(2)
    jres.reshard_restore(ck, jtr, sample_feed=W.E_FEED)
    _held(res2, "single_to2", jtr)


def test_infeasible_reshard_raises_before_touching_state(worlds):
    """dp=2 → dp=4 with a batch of 2 (the JAX test's dp=8 with 4: a world
    of 8 is not spawned here)."""
    d, res4, _ = worlds
    small = {"x": np.zeros((2, W.E_DIM), np.float32), "label": np.zeros((2, 1), np.int64)}
    jtr = _jt(4)
    with pytest.raises(jres.ReshardError, match="does not divide") as ei:
        jres.reshard_restore(os.path.join(d, "j2_sgd_ck"), jtr, sample_feed=small)
    assert str(res4["infeasible/error"]) == str(ei.value)
    assert str(ei.value).endswith(str(res4["infeasible/finding"]))
    assert int(res4["infeasible/untouched"]) == 1


def test_elastic_fit_infeasible_batch_is_structured(worlds):
    d, res4, _ = worlds
    with pytest.raises(jres.ReshardError, match="does not divide") as ei:
        _jfit(_jt(4), os.path.join(d, "j_fit6"), reader=W.e_reader(4, seed=5, bs=6),
              epochs=1, resume=True, elastic=True)
    assert str(res4["fit6/error"]) == str(ei.value)


# -- elastic fit: kill and rejoin at another N (:276-328) ------------------------------


def test_elastic_fit_kill_and_rejoin_continuity(worlds):
    d, res4, res2 = worlds
    assert int(res4["kill/global_step"]) == 5
    assert int(res2["rejoin/global_step"]) == 2 * W.E_BATCHES
    losses = res2["rejoin/losses"]
    np.testing.assert_array_equal(losses, res2["rejoin/ref_losses"])
    assert int(res2["rejoin/params_equal"]) == 1
    ref = _jt(2)
    rep = jres.reshard_restore(os.path.join(d, "kill", "step_5"), ref, sample_feed=W.E_FEED)
    np.testing.assert_allclose(losses, _jmanual(ref, rep["meta"]), rtol=1e-5)


def test_elastic_fit_rejoin_with_different_steps_per_dispatch(worlds):
    d, res4, _ = worlds
    assert int(res4["k3/global_step"]) == W.E_BATCHES
    losses = res4["k3/losses"]
    np.testing.assert_array_equal(losses, res4["k3/ref_losses"])
    assert int(res4["k3/params_equal"]) == 1
    ref = _jt(4)
    rep = jres.reshard_restore(os.path.join(d, "j_k2_ref"), ref, sample_feed=W.E_FEED)
    np.testing.assert_allclose(losses, _jmanual(ref, rep["meta"], epochs=1), rtol=1e-5)


# -- the sharded restore across a mesh reshape (tests/test_orbax_checkpoint.py:71) --


def test_restore_across_mesh_reshape(worlds):
    """dp=4 saves sharded (async, a step after it at once); dp2×fsdp2 with
    the fsdp rules restores: each param equal to the saved one, its weight
    really sharded over fsdp, and the next step finite."""
    _, res4, _ = worlds
    assert int(res4["reshape/equal"]) == 1
    assert str(res4["reshape/spec"]) == "P('fsdp', None)"
    assert tuple(res4["reshape/local_shape"]) == (W.E_DIM // 2, 4)
    assert int(res4["reshape/global_step"]) == 1
    assert np.isfinite(float(res4["reshape/next_loss"]))


# -- scheduled resize (tests/test_resilience.py:543-626) -------------------------------


def _fit_here(tr, root, handler=None, **kw):
    return W.e_fit(tr, root, handler=handler, **kw)


def test_resize_request_file_watch_and_consume(tmp_path):
    path = str(tmp_path / "resize.json")
    rz = tres.ResizeRequest(path)
    assert not rz.requested
    rz.request({"dp": 4})
    assert rz.requested and rz.target == {"dp": 4}
    with open(path, "w") as f:
        f.write("not json")
    assert rz.requested and rz.target == {}
    with open(path, "w") as f:
        f.write("[1, 2]")
    assert rz.target == {}
    rz.request({"dp": 2})
    assert rz.consume() == {"dp": 2}
    assert not rz.requested and not os.path.exists(path)
    assert rz.consume() == {}
    # a signal sets the flag where the handler is installed (the main thread)
    with tres.ResizeRequest(path, signal_num=signal.SIGUSR1) as rs:
        assert rs.installed and not rs.requested
        os.kill(os.getpid(), signal.SIGUSR1)
        assert rs.requested
    assert not rs.installed


def test_fit_resize_boundary_checkpoint_and_clean_exit(tmp_path):
    root = str(tmp_path / "ck")
    rz = tres.ResizeRequest(str(tmp_path / "resize.json"))
    events = []

    def handler(e):
        events.append(e)
        if e.kind == "end_step" and e.step == 5:
            rz.request({"dp": 2})

    tr = _fit_here(W.e_trainer(1), root, handler=handler, resize=rz)
    assert tr.global_step == 5 and events[-1].kind == "resized"
    assert [c.global_step for c in tres.list_checkpoints(root)] == [5]
    assert rz.consume() == {"dp": 2}
    tr2 = W.e_trainer(1)
    assert tres.restore_latest(root, tr2) is not None and tr2.global_step == 5
    tr2 = _fit_here(tr2, root, resize=rz)
    assert tr2.global_step == 5 + 2 * W.E_BATCHES


def test_sigterm_wins_over_concurrent_resize(tmp_path):
    path = str(tmp_path / "resize.json")
    events = []

    def handler(e):
        events.append(e.kind)
        if e.kind == "end_step" and e.step == 5:
            tres.ResizeRequest(path).request({"dp": 2})
            os.kill(os.getpid(), signal.SIGTERM)

    tr = _fit_here(W.e_trainer(1), str(tmp_path), handler=handler, resize=path)
    assert tr.global_step == 5 and events[-1] == "preempted" and "resized" not in events
    assert [c.global_step for c in tres.list_checkpoints(str(tmp_path))] == [5]
