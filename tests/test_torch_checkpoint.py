"""Checkpoints, resume and preemption of the port, on the CPU.

The first part mirrors tests/test_resilience.py case for case on the
port's ``io``/``resilience``/``fit``: the manifest validates, a crash at
each phase of ``save_trainer`` leaves the previous checkpoint loadable, a
corrupt checkpoint raises ``CheckpointCorrupt``, a legacy one without a
manifest loads, stale tmp dirs are swept, resume reproduces the
uninterrupted run bit for bit and falls back over a corrupt newest
checkpoint, an empty directory starts fresh, rotation is rebuilt across
restarts and never deletes foreign tags, and SIGTERM gives a boundary
checkpoint from which the run resumes to completion.

The second part holds the port to ``paddle_tpu`` on the same files: each
package loads the other's ``save_trainer`` directory of ``mnist.mlp``
under Adam with params, moments, beta powers and step bit-identical, and
validates the other's manifest; a bf16 GPT trainer (2 layers, d 64)
round-trips and its next two losses equal the uninterrupted run's bit for
bit (the same CPU arithmetic on the same bits); a checkpoint saved on a
mesh raises ``ReshardError``."""

import contextlib
import json
import os
import signal

import numpy as np
import pytest

import jax
import torch

import paddle_tpu as jpt
from paddle_tpu import io as jio
from paddle_tpu import optimizer as jopt
from paddle_tpu import resilience as jres
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.testing import faults

import paddle_tpu_torch as tpt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import layers as tL
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch.core.errors import NotYetPorted
from paddle_tpu_torch.framework import params_from_jax
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import mnist as tmnist

CPU = tpt.CPUPlace()
DIM, CLASSES, BS, N_BATCHES = 6, 4, 4, 8


def _net(x, label):
    h = tL.fc(x, 16, name="fc1")
    logits = tL.fc(h, CLASSES, name="fc2")
    return {"loss": tL.mean(tL.softmax_with_cross_entropy(logits, label))}


_PROG = tpt.build(_net)
_FEED = {"x": np.zeros((BS, DIM), np.float32), "label": np.zeros((BS, 1), np.int64)}


def _trainer():
    tr = tpt.Trainer(_PROG, topt.SGD(0.1), loss_name="loss", place=CPU)
    tr.startup(sample_feed=_FEED)
    return tr


def _reader(n_batches=N_BATCHES, seed=7):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n_batches):
            x = rng.randn(BS, DIM).astype(np.float32)
            y = rng.randint(0, CLASSES, (BS,)).astype(np.int64)
            yield [(x[j], y[j:j + 1]) for j in range(BS)]
    return reader


def _fit(tr, cfg=None, epochs=2, handler=None, **kw):
    return tpt.fit(tr, _reader(), num_epochs=epochs, feed_names=["x", "label"],
                   dtypes=["float32", "int64"], checkpoint_config=cfg,
                   event_handler=handler, prefetch=False, **kw)


def _params_equal(a, b):
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


@contextlib.contextmanager
def _crashing(tag):
    """Arm the port's crash point ``tag`` for the block."""
    tres.crash_points.add(tag)
    try:
        yield
    finally:
        tres.crash_points.discard(tag)


def _crash_at_step(step):
    def handler(event):
        if event.kind == "end_step" and event.step >= step:
            raise tres.InjectedCrash(f"scripted crash at step {event.step}")
    return handler


def _sigterm_at_step(step, events=None):
    def handler(e):
        if events is not None:
            events.append(e.kind)
        if e.kind == "end_step" and e.step == step:
            os.kill(os.getpid(), signal.SIGTERM)
    return handler


def _losses(log):
    return lambda e: log.append(float(e.metrics["loss"])) if e.kind == "end_step" else None


# -- atomic validated checkpoints -------------------------------------------


def test_manifest_written_and_validates(tmp_path):
    tr = _trainer()
    tr.step(_FEED)
    d = str(tmp_path / "ck")
    tio.save_trainer(d, tr)
    man = tres.validate_checkpoint(d)
    assert man["format_version"] == tres.MANIFEST_VERSION
    assert man["global_step"] == 1
    assert set(man["files"]) >= {"params.npz", "meta.json"}
    assert man["arrays"]["params.npz"]["fc1/w"] == {"shape": [DIM, 16], "dtype": "float32"}
    assert man["meta"]["mesh_axes"] == {}
    # the JAX package reads the same manifest
    assert jres.validate_checkpoint(d) == man


@pytest.mark.parametrize("phase", ["save_trainer:files-written",
                                   "save_trainer:manifest-written"])
def test_kill_mid_save_keeps_previous_checkpoint_loadable(tmp_path, phase):
    tr = _trainer()
    tr.step(_FEED)
    tio.save_trainer(str(tmp_path / "step_1"), tr)
    tr.step(_FEED)
    ck2 = str(tmp_path / "step_2")
    with _crashing(phase):
        with pytest.raises(tres.InjectedCrash):
            tio.save_trainer(ck2, tr)
    assert not os.path.isdir(ck2)
    assert [c.tag for c in tres.list_checkpoints(str(tmp_path))] == ["step_1"]
    tr2 = _trainer()
    meta = tres.restore_latest(str(tmp_path), tr2)
    assert meta is not None and tr2.global_step == 1


def test_corrupt_checkpoint_raises_structured(tmp_path):
    tr = _trainer()
    tr.step(_FEED)
    d = str(tmp_path / "ck")
    tio.save_trainer(d, tr)
    flipped = faults.flip_byte(d)
    with pytest.raises(tres.CheckpointCorrupt) as ei:
        tio.load_trainer(d, _trainer())
    assert flipped in str(ei.value) and "checksum" in str(ei.value)
    assert ei.value.path == d
    tio.save_trainer(d, tr)  # an atomic overwrite repairs the tag
    tio.load_trainer(d, _trainer())
    truncated = faults.truncate_file(d)
    with pytest.raises(tres.CheckpointCorrupt) as ei:
        tio.load_trainer(d, _trainer())
    assert truncated in str(ei.value)


def test_legacy_checkpoint_without_manifest_still_loads(tmp_path):
    tr = _trainer()
    tr.step(_FEED)
    d = str(tmp_path / "legacy")
    tio.save_persistables(d, tr.scope.params, tr.scope.state, tr.scope.opt_state,
                          meta={"global_step": 1})
    assert tres.validate_checkpoint(d) is None
    tr2 = _trainer()
    tio.load_trainer(d, tr2)
    assert tr2.global_step == 1 and _params_equal(tr.scope.params, tr2.scope.params)


def test_stale_tmp_dirs_swept(tmp_path):
    tr = _trainer()
    tr.step(_FEED)
    with _crashing("save_trainer:manifest-written"):
        with pytest.raises(tres.InjectedCrash):
            tio.save_trainer(str(tmp_path / "step_1"), tr)
    assert any(tres.TMP_MARKER in n for n in os.listdir(tmp_path))
    tio.save_trainer(str(tmp_path / "step_1"), tr)  # the same tag sweeps its own
    assert os.listdir(tmp_path) == ["step_1"]
    with _crashing("save_trainer:files-written"):
        with pytest.raises(tres.InjectedCrash):
            tio.save_trainer(str(tmp_path / "step_2"), tr)
    cfg = tpt.CheckpointConfig(str(tmp_path), epoch_interval=0, step_interval=0,
                               max_num_checkpoints=2)
    _fit(_trainer(), cfg, epochs=1)  # fit's start sweeps the other tags' tmp
    assert not any(tres.TMP_MARKER in n for n in os.listdir(tmp_path))


def test_loaded_params_are_fresh_trainable_tensors(tmp_path):
    """Loaded leaves are new tensors that own their memory (nothing aliases
    the npz reader), params require grad as startup sets them, and a
    stateless optimizer's empty accumulators come back."""
    tr = _trainer()
    tr.step(_FEED)
    d = str(tmp_path / "ck")
    tio.save_trainer(d, tr)
    tr2 = _trainer()
    tio.load_trainer(d, tr2)
    for k, p in tr2.scope.params.items():
        assert p.requires_grad and p.is_leaf and p.data_ptr() != tr.scope.params[k].data_ptr()
    assert tr2.scope.opt_state["accums"] == {k: {} for k in tr2.scope.params}
    assert tr2.scope.opt_state["global"] == {}
    assert tr2.scope.opt_state["step"].dtype == torch.int32
    before = {k: p.detach().clone() for k, p in tr2.scope.params.items()}
    tr2.step(_FEED)
    assert not torch.equal(before["fc2/b"], tr2.scope.params["fc2/b"])


def test_drifted_params_raise_corrupt(tmp_path):
    tr = _trainer()
    d = str(tmp_path / "ck")
    tio.save_trainer(d, tr)

    def wider(x, label):
        h = tL.fc(x, 17, name="fc1")
        return {"loss": tL.mean(tL.softmax_with_cross_entropy(tL.fc(h, CLASSES, name="fc2"),
                                                              label))}

    other = tpt.Trainer(tpt.build(wider), topt.SGD(0.1), place=CPU)
    other.startup(sample_feed=_FEED)
    with pytest.raises(tres.CheckpointCorrupt, match="drifted"):
        tio.load_trainer(d, other)


# -- resumable fit -----------------------------------------------------------


def test_resume_reproduces_uninterrupted_run_bit_exactly(tmp_path):
    cfg = tpt.CheckpointConfig(str(tmp_path), epoch_interval=0, step_interval=4,
                               max_num_checkpoints=3)
    ref_losses = []
    ref = _fit(_trainer(), handler=_losses(ref_losses))
    with pytest.raises(tres.InjectedCrash):
        _fit(_trainer(), cfg, handler=_crash_at_step(7))
    assert [c.tag for c in tres.list_checkpoints(str(tmp_path))] == ["step_4"]
    resumed_losses = []
    res = _fit(_trainer(), cfg, resume=True, handler=_losses(resumed_losses))
    assert res.global_step == ref.global_step == 2 * N_BATCHES
    assert resumed_losses == ref_losses[-len(resumed_losses):]
    assert len(resumed_losses) == 2 * N_BATCHES - 4
    assert _params_equal(ref.scope.params, res.scope.params)


def test_resume_falls_back_over_corrupt_newest(tmp_path):
    cfg = tpt.CheckpointConfig(str(tmp_path), epoch_interval=0, step_interval=4,
                               max_num_checkpoints=4)
    _fit(_trainer(), cfg)
    ckpts = tres.list_checkpoints(str(tmp_path))
    assert len(ckpts) >= 2
    faults.flip_byte(ckpts[-1].path)
    tr = _trainer()
    assert tres.restore_latest(str(tmp_path), tr) is not None
    assert tr.global_step == ckpts[-2].global_step


def test_resume_with_empty_dir_starts_fresh(tmp_path):
    cfg = tpt.CheckpointConfig(str(tmp_path / "none"), epoch_interval=0, step_interval=0,
                               max_num_checkpoints=2)
    assert _fit(_trainer(), cfg, epochs=1, resume=True).global_step == N_BATCHES


def test_rotation_rebuilt_across_restarts(tmp_path):
    cfg = tpt.CheckpointConfig(str(tmp_path), epoch_interval=0, step_interval=2,
                               max_num_checkpoints=3)
    _fit(_trainer(), cfg, epochs=1)  # 8 steps: saves at 2, 4, 6, 8
    assert len(os.listdir(str(tmp_path))) == 3
    _fit(_trainer(), cfg, epochs=1)  # a restart: the old tags rotate out
    assert len(os.listdir(str(tmp_path))) == 3
    assert sorted(c.global_step for c in tres.list_checkpoints(str(tmp_path))) == [4, 6, 8]


def test_rotation_never_deletes_foreign_checkpoints(tmp_path):
    tr = _trainer()
    tr.step(_FEED)
    tio.save_trainer(str(tmp_path / "best"), tr)
    cfg = tpt.CheckpointConfig(str(tmp_path), epoch_interval=0, step_interval=2,
                               max_num_checkpoints=2)
    _fit(_trainer(), cfg, epochs=1)
    assert os.path.isdir(tmp_path / "best")
    tags = [c.tag for c in tres.list_checkpoints(str(tmp_path))]
    assert "best" in tags and len(tags) == 3


def test_epoch_interval_saves_tag_each_epoch(tmp_path):
    cfg = tpt.CheckpointConfig(str(tmp_path), epoch_interval=1, step_interval=0,
                               max_num_checkpoints=5)
    _fit(_trainer(), cfg, epochs=2)
    ckpts = tres.list_checkpoints(str(tmp_path))
    assert [(c.tag, c.global_step) for c in ckpts] == [("epoch_0", 8), ("epoch_1", 16)]
    with open(os.path.join(ckpts[0].path, "meta.json")) as f:
        assert json.load(f) == {"global_step": 8, "mesh_axes": {}, "epoch": 1,
                                "epoch_step": 0}


# -- preemption --------------------------------------------------------------


def test_sigterm_boundary_checkpoint_and_clean_exit(tmp_path):
    cfg = tpt.CheckpointConfig(str(tmp_path), epoch_interval=0, step_interval=0,
                               max_num_checkpoints=3)
    events = []
    before = signal.getsignal(signal.SIGTERM)
    tr = _fit(_trainer(), cfg, handler=_sigterm_at_step(5, events))  # returns
    assert tr.global_step == 5
    assert events[-1] == "preempted"
    assert [c.global_step for c in tres.list_checkpoints(str(tmp_path))] == [5]
    tr2 = _trainer()
    assert tres.restore_latest(str(tmp_path), tr2) is not None
    assert tr2.global_step == 5
    assert signal.getsignal(signal.SIGTERM) == before  # the handler is restored


def test_preemption_saves_despite_stale_same_tag_dir(tmp_path):
    stale = _trainer()
    stale.global_step = 5  # a prior run's checkpoint under the same tag
    tio.save_trainer(str(tmp_path / "step_5"), stale)
    stale_probe = float(stale.eval(_FEED)["loss"])
    cfg = tpt.CheckpointConfig(str(tmp_path), epoch_interval=0, step_interval=0,
                               max_num_checkpoints=3)
    _fit(_trainer(), cfg, handler=_sigterm_at_step(5))
    tr2 = _trainer()
    assert tres.restore_latest(str(tmp_path), tr2) is not None
    assert tr2.global_step == 5
    assert float(tr2.eval(_FEED)["loss"]) != stale_probe


def test_preempted_run_resumes_to_completion(tmp_path):
    cfg = tpt.CheckpointConfig(str(tmp_path), epoch_interval=0, step_interval=0,
                               max_num_checkpoints=3)
    ref_losses, losses = [], []
    ref = _fit(_trainer(), handler=_losses(ref_losses))
    _fit(_trainer(), cfg, handler=lambda e: (_losses(losses)(e), _sigterm_at_step(5)(e)))
    res = _fit(_trainer(), cfg, resume=True, handler=_losses(losses))
    assert res.global_step == 2 * N_BATCHES
    assert losses == ref_losses
    assert _params_equal(ref.scope.params, res.scope.params)


def test_preemption_flag_without_a_checkpoint_config(tmp_path):
    """preemption=True with no checkpoint_config still stops at the step
    boundary and fires "preempted"; nothing is written."""
    events = []
    tr = _fit(_trainer(), None, handler=_sigterm_at_step(3, events), preemption=True)
    assert tr.global_step == 3 and events[-1] == "preempted"


def test_handler_is_inert_off_the_main_thread():
    import threading
    seen = []

    def run():
        with tres.PreemptionHandler() as ph:
            seen.append(ph.installed)
    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and seen == [False]


# -- what raises ---------------------------------------------------------------


def test_checkpoint_with_loss_scale_state_loads_with_a_warning(tmp_path):
    tr = _trainer()
    tr.step(_FEED)
    d = str(tmp_path / "scaled")
    tio.save_trainer(d, tr, extra_meta={"loss_scale_state": {
        "scale": 1024.0, "good_steps": 3, "overflows": 0}})
    tr2 = _trainer()
    with pytest.warns(UserWarning, match="no loss scaler"):
        tio.load_trainer(d, tr2)
    tr2.step(_FEED)
    assert tr2.global_step == 2


def test_mesh_checkpoint_raises_reshard_error(tmp_path):
    tr = _trainer()
    d = str(tmp_path / "dp2")
    tio.save_trainer(d, tr, extra_meta={"mesh_axes": {"dp": 2}})
    with pytest.raises(tres.ReshardError) as ei:
        tio.load_trainer(d, _trainer())
    assert ei.value.saved_axes == {"dp": 2} and ei.value.target_axes is None
    # restore_latest re-raises it instead of falling back past it
    with pytest.raises(tres.ReshardError):
        tres.restore_latest(str(tmp_path), _trainer())
    # a {"dp": 1} mesh places arrays as one device does
    d1 = str(tmp_path / "dp1")
    tio.save_trainer(d1, tr, extra_meta={"mesh_axes": {"dp": 1}})
    tio.load_trainer(d1, _trainer())


NOT_PORTED = {
    "frame_record": lambda d: tres.frame_record(b"x"),
}


@pytest.mark.parametrize("call", sorted(NOT_PORTED))
def test_later_slices_raise_not_yet_ported(tmp_path, call):
    d = str(tmp_path / "ck")
    tio.save_trainer(d, _trainer(), extra_meta={"zero": {"shards": 2}})
    with pytest.raises(NotYetPorted):
        NOT_PORTED[call](d)


def _restores(src):
    def check(tgt):
        assert tgt.global_step == 1 and _params_equal(tgt.scope.params, src.scope.params)
    return check


def _resize_request(d):
    rz = tres.ResizeRequest(d + ".resize")
    assert not rz.requested
    rz.request({"dp": 1})
    assert rz.requested and rz.consume() == {"dp": 1} and not rz.requested


ELASTIC = {
    "restore_latest_elastic": lambda d, ok: ok(_restored_latest(d)),
    "reshard_restore": lambda d, ok: ok(_resharded(d)),
    "ResizeRequest": lambda d, ok: _resize_request(d),
    "fit_elastic": lambda d, ok: _fit_elastic(d),
}


def _restored_latest(d):
    tgt = _trainer()
    assert tres.restore_latest(os.path.dirname(d), tgt, elastic=True)["global_step"] == 1
    return tgt


def _resharded(d):
    tgt = _trainer()
    rep = tres.reshard_restore(d, tgt, sample_feed=_FEED)
    assert (rep["saved_axes"], rep["target_axes"], rep["global_step"]) == ({"dp": 2}, None, 1)
    assert rep["bytes_moved"] > 0
    return tgt


def _fit_elastic(d):
    cfg = tpt.CheckpointConfig(os.path.dirname(d), epoch_interval=0, step_interval=0)
    assert _fit(_trainer(), cfg, resume=True, elastic=True).global_step == 2 * N_BATCHES


@pytest.mark.parametrize("call", sorted(ELASTIC))
def test_elastic_entry_points_restore_across_a_mesh_change(tmp_path, call):
    """Once NotYetPorted (ROADMAP item 22), each restores a checkpoint saved
    at {dp: 2} onto a one-device trainer, or requests a resize."""
    src = _trainer()
    src.step(_FEED)
    d = str(tmp_path / "step_1")
    tio.save_trainer(d, src, extra_meta={"mesh_axes": {"dp": 2}, "epoch": 0,
                                         "epoch_step": 1})
    with pytest.raises(tres.ReshardError, match="reshard_restore"):
        tio.load_trainer(d, _trainer())
    ELASTIC[call](d, _restores(src))


def test_a_zero_checkpoint_missing_shard_files_is_refused(tmp_path):
    """A ZeRO checkpoint's meta names its shard count; a directory that
    lacks some of the shard files does not load half a model."""
    d = str(tmp_path / "ck")
    tio.save_trainer(d, _trainer(), extra_meta={"zero": {"shards": 2, "arrays": {}}})
    np.savez(os.path.join(d, "params.zero0.npz"), w=np.zeros(3, np.float32))
    with pytest.raises(FileNotFoundError, match="shard files"):
        tio.load_persistables(d)


# -- against paddle_tpu --------------------------------------------------------


def _mnist_feeds(n=3, batch=16):
    rng = np.random.RandomState(0)
    return [{"image": rng.randn(batch, 784).astype(np.float32),
             "label": rng.randint(0, 10, (batch, 1)).astype(np.int64)} for _ in range(n)]


def _port_mnist(params=None):
    tr = tpt.Trainer(tpt.build(tmnist.mlp), topt.Adam(1e-3), loss_name="loss", place=CPU)
    tr.startup(sample_feed=_mnist_feeds(1)[0], params=params)
    return tr


def _jax_mnist():
    tr = jpt.Trainer(jpt.build(jmnist.mlp), jopt.Adam(1e-3), loss_name="loss")
    tr.startup(sample_feed=_mnist_feeds(1)[0])
    return tr


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):  # bfloat16 widened: exact
        return (tree.detach().float() if tree.dtype == torch.bfloat16 else tree.detach()).numpy()
    return np.asarray(jax.device_get(tree))


def _assert_trees_identical(a, b):
    a, b = _numpy_tree(a), _numpy_tree(b)
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_identical(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_mnist_adam_checkpoint_crosses_packages_bit_identical(tmp_path, direction):
    feeds = _mnist_feeds()
    d = str(tmp_path / "ck")
    if direction == "jax_to_port":
        src = _jax_mnist()
        for f in feeds:
            src.step(f)
        jio.save_trainer(d, src)
        assert tres.validate_checkpoint(d) is not None
        dst = _port_mnist()
        tio.load_trainer(d, dst)
    else:
        jt = _jax_mnist()
        src = _port_mnist(params_from_jax(
            {k: np.asarray(v) for k, v in jt.scope.params.items()}, device="cpu"))
        for f in feeds:
            src.step(f)
        tio.save_trainer(d, src)
        assert jres.validate_checkpoint(d) is not None
        dst = _jax_mnist()
        jio.load_trainer(d, dst)
    assert dst.global_step == src.global_step == 3
    _assert_trees_identical(src.scope.params, dst.scope.params)
    _assert_trees_identical(src.scope.opt_state, dst.scope.opt_state)
    assert int(np.asarray(_numpy_tree(dst.scope.opt_state)["step"])) == 3
    assert sorted(_numpy_tree(dst.scope.opt_state)["global"]) == ["beta1_pow", "beta2_pow"]
    # and both take the same next step from there
    a, b = float(src.step(feeds[0])["loss"]), float(dst.step(feeds[0])["loss"])
    np.testing.assert_allclose(a, b, rtol=1e-6)


SMALL_GPT = dict(vocab_size=50, max_len=32, d_model=64, d_inner=128, num_heads=2,
                 num_layers=2, use_flash=True, fused_ce=True, ce_chunk=16,
                 dtype="bfloat16")


def _gpt_trainer(seed=0):
    prog = tpt.build(tgpt.make_model(tgpt.base_config(**SMALL_GPT)))
    with tpt.amp_guard("bfloat16"):
        return tpt.Trainer(prog, topt.AdamW(1e-3, weight_decay=0.01), fetch_list=["loss"],
                           device="cpu").startup(seed, _gpt_feeds(1)[0])


def _gpt_feeds(n=5):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        ids = rng.randint(3, SMALL_GPT["vocab_size"], (2, 16)).astype(np.int32)
        labels = np.concatenate([ids[:, 1:], np.full((2, 1), 2)], 1).astype(np.int32)
        out.append({"ids": ids, "labels": labels})
    return out


def test_gpt_trainer_round_trip_continues_the_uninterrupted_run(tmp_path):
    feeds = _gpt_feeds()
    ref = _gpt_trainer()
    with tpt.amp_guard("bfloat16"):
        ref_losses = [float(ref.step(f)["loss"]) for f in feeds]
    saver = _gpt_trainer()
    with tpt.amp_guard("bfloat16"):
        for f in feeds[:3]:
            saver.step(f)
    d = str(tmp_path / "gpt")
    tio.save_trainer(d, saver)
    man = tres.validate_checkpoint(d)
    assert man["arrays"]["params.npz"]["lm_head_0/w@bfloat16"] == {
        "shape": [64, 50], "dtype": "uint16"}
    resumed = _gpt_trainer(seed=1)  # other initial values: all must be replaced
    tio.load_trainer(d, resumed)
    assert resumed.global_step == 3
    # the restored params are the trainer's leaves, in the program's dtypes
    assert all(p.is_leaf and p.requires_grad and p.dtype == saver.scope.params[k].dtype
               for k, p in resumed.scope.params.items())
    with tpt.amp_guard("bfloat16"):
        losses = [float(resumed.step(f)["loss"]) for f in feeds[3:]]
    assert losses == ref_losses[3:]
    _assert_trees_identical(ref.scope.params, resumed.scope.params)
    # the bf16 leaves read back in the JAX package with the same bits
    jparams = jio.load_persistables(d)[0]
    assert str(jparams["lm_head_0/w"].dtype) == "bfloat16"
    assert np.array_equal(jparams["lm_head_0/w"].view(np.uint16),
                          saver.scope.params["lm_head_0/w"].detach().view(torch.int16)
                          .numpy().view(np.uint16))


def test_flat_spec_matches_the_jax_package():
    """The same keys, shapes and stored dtypes, the bfloat16 suffix and the
    '@raw' escape of an integer leaf literally named 'x@bfloat16'."""
    tree = {"w": torch.zeros(2, 3, dtype=torch.bfloat16),
            "n": {"s": torch.zeros((), dtype=torch.int32)},
            "x@bfloat16": torch.zeros(2, dtype=torch.uint16), "e": None}
    jtree = {"w": np.zeros((2, 3), jax.numpy.bfloat16), "n": {"s": np.zeros((), np.int32)},
             "x@bfloat16": np.zeros(2, np.uint16), "e": None}
    assert tio.flat_spec(tree) == jio.flat_spec(jtree)
