"""Inference export of ``build`` programs in the port, on the CPU, against
``paddle_tpu`` on the same numpy inputs and params.

- The port's half of tests/test_e2e_mnist.py:50-61: train, ``save_trainer``,
  ``load_trainer`` into a fresh trainer, the same eval logits.
- A Program artifact (``mnist.mlp``) round-trips at buckets [1, 8] (plus
  the example's own 4): each bucket's outputs equal ``Program.apply`` on
  the same params, and a ``PredictorServer`` pads ragged requests up to a
  bucket and slices their rows back.
- ``paddle_tpu``'s Predictor and the port's on the same params give the
  same outputs, f32, to 1e-5 (rtol and atol: the same f32 products summed
  in another order); the port serves the ``params.npz`` of a
  ``paddle_tpu`` artifact read through its ``load_params``; the port's
  ``Inferencer`` matches the reference's to the same tolerance.
- The artifact carries the reference's manifest: a flipped byte, a torn
  file or a damaged meta raises ``CheckpointCorrupt``, a crash mid-export
  leaves the previous artifact loadable, and each package reads the
  other's metadata (feed spec, fingerprint, manifest)."""

import os
import shutil

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
from paddle_tpu_torch import data as tdata
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch.core.errors import EnforceError, NotYetPorted
from paddle_tpu_torch.framework import params_from_jax
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.serving import PredictorServer

CPU = tpt.CPUPlace()
TOL = 1e-5


def _feed(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"image": rng.randn(n, 784).astype(np.float32),
            "label": rng.randint(0, 10, (n, 1)).astype(np.int64)}


@pytest.fixture(scope="module")
def jax_params():
    prog = jpt.build(jmnist.mlp)
    f = _feed(4)
    params, state = prog.init(jax.random.PRNGKey(0), f["image"], f["label"])
    return ({k: np.asarray(v) for k, v in params.items()},
            {k: np.asarray(v) for k, v in state.items()})


@pytest.fixture
def port_artifact(tmp_path, jax_params):
    d = str(tmp_path / "art")
    params = params_from_jax(jax_params[0], device="cpu")
    tio.save_inference_model(d, tpt.build(tmnist.mlp), params, {}, _feed(4),
                             batch_buckets=[1, 8])
    return d, params


def test_mnist_save_load_infer_round_trip(tmp_path):
    reader = tdata.batch(tdata.shuffle(tdata.datasets.mnist("train"), 512, seed=0), 64)
    feeder = tdata.DataFeeder(["image", "label"], dtypes=["float32", "int64"])
    feeds = [feeder.feed(s) for s, _ in zip(reader(), range(20))]
    prog = tpt.build(tmnist.mlp)
    trainer = tpt.Trainer(prog, topt.Adam(1e-3), loss_name="loss", place=CPU)
    trainer.startup(sample_feed=feeds[0])
    for f in feeds:
        trainer.step(f)
    test_feed = feeder.feed(next(iter(tdata.batch(tdata.datasets.mnist("test"), 256)())))
    d = str(tmp_path / "ck")
    tio.save_trainer(d, trainer)
    trainer2 = tpt.Trainer(prog, topt.Adam(1e-3), loss_name="loss", place=CPU)
    trainer2.startup(sample_feed=feeds[0])
    tio.load_trainer(d, trainer2)
    assert trainer2.global_step == trainer.global_step == 20
    out1, out2 = trainer.eval(test_feed), trainer2.eval(test_feed)
    np.testing.assert_allclose(out1["logits"].numpy(), out2["logits"].numpy(),
                               rtol=TOL, atol=TOL)


def test_program_artifact_round_trip_at_buckets(port_artifact):
    d, params = port_artifact
    assert sorted(os.listdir(d)) == ["manifest.json", "meta.json", "params.npz", "state.npz"]
    meta = tio.read_artifact_meta(d)["meta"]
    assert meta["program"] == "paddle_tpu_torch.models.mnist:mlp"
    assert meta["layout"] == "NCHW" and meta["compute_dtype"] == "float32"
    pred = tio.load_inference_model(d, device="cpu")
    assert pred.batch_buckets == [1, 4, 8]
    prog = tpt.build(tmnist.mlp)
    for b in pred.batch_buckets:
        f = _feed(b, seed=b)
        got = pred.run(f)
        want, _ = prog.apply(params, {}, place=CPU, **f)
        for k in ("logits", "loss", "acc"):
            assert torch.equal(got[k], want[k]), (b, k)
    with pytest.raises(tio.InvalidRequest, match="not a precompiled bucket"):
        pred.run(_feed(3))
    # the server pads a ragged request up to its bucket and slices it back
    with PredictorServer(pred, workers=2) as srv:
        for n in (1, 3, 5, 8):
            f = _feed(n, seed=10 + n)
            got = srv.run(f, timeout=60)["logits"]
            want, _ = prog.apply(params, {}, place=CPU, **f)
            assert got.shape == (n, 10)
            torch.testing.assert_close(got, want["logits"], rtol=TOL, atol=TOL)


def test_predictor_matches_paddle_tpu(tmp_path, jax_params, port_artifact):
    jd = str(tmp_path / "jart")
    jio.save_inference_model(jd, jpt.build(jmnist.mlp), jax_params[0], jax_params[1],
                             _feed(4), batch_buckets=[1, 8])
    jpred = jio.load_inference_model(jd)
    tpred = tio.load_inference_model(port_artifact[0], device="cpu")
    assert jpred.batch_buckets == tpred.batch_buckets
    for b in (1, 4, 8):
        f = _feed(b, seed=20 + b)
        assert tpred.feed_spec(b) == jpred.feed_spec(b)
        j, t = jpred.run(f), tpred.run(f)
        for k in ("logits", "loss", "acc"):
            np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=TOL, atol=TOL)


def test_port_serves_the_params_of_a_paddle_tpu_artifact(tmp_path, jax_params):
    jd = str(tmp_path / "jart")
    jio.save_inference_model(jd, jpt.build(jmnist.mlp), jax_params[0], jax_params[1],
                             _feed(8))
    params = tio.load_params(jd)
    assert sorted(params) == sorted(jax_params[0])
    assert all(isinstance(v, torch.Tensor) for v in params.values())
    d = str(tmp_path / "port")
    tio.save_inference_model(d, tpt.build(tmnist.mlp), params, {}, _feed(8))
    f = _feed(8, seed=3)
    got = tio.load_inference_model(d, device="cpu").run(f)
    want = jio.load_inference_model(jd).run(f)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("damage", ["flip_params", "truncate_params", "flip_meta"])
def test_damaged_artifact_raises_corrupt(port_artifact, damage):
    d = port_artifact[0]
    name = {"flip_params": lambda: faults.flip_byte(d),
            "truncate_params": lambda: faults.truncate_file(d),
            "flip_meta": lambda: faults.flip_byte(d, "meta.json", offset=3)}[damage]()
    with pytest.raises(tres.CheckpointCorrupt) as ei:
        tio.load_inference_model(d, device="cpu")
    assert name in str(ei.value)
    with pytest.raises(jres.CheckpointCorrupt):  # the JAX package agrees
        jres.validate_checkpoint(d)


@pytest.mark.parametrize("phase", ["save_inference_model:files-written",
                                   "save_inference_model:manifest-written",
                                   "save_inference_model:committing"])
def test_crash_mid_export_keeps_the_previous_artifact(port_artifact, phase):
    d, params = port_artifact
    tres.crash_points.add(phase)
    try:
        with pytest.raises(tres.InjectedCrash):
            tio.save_inference_model(d, tpt.build(tmnist.mlp), params, {}, _feed(2))
    finally:
        tres.crash_points.discard(phase)
    # the next export recovers the old artifact if it was moved aside, then
    # commits; until then the old one loads (or sits recoverable aside)
    if phase != "save_inference_model:committing":
        assert tio.load_inference_model(d, device="cpu").batch_buckets == [1, 4, 8]
    tio.save_inference_model(d, tpt.build(tmnist.mlp), params, {}, _feed(2))
    assert tio.load_inference_model(d, device="cpu").batch_buckets == [2]
    parent = os.path.dirname(d)
    assert not any(tres.TMP_MARKER in n for n in os.listdir(parent))


def test_each_package_reads_the_others_artifact_metadata(tmp_path, jax_params, port_artifact):
    d = port_artifact[0]
    meta = tio.read_artifact_meta(d)["meta"]
    pred = tio.load_inference_model(d, device="cpu")
    for b in (None, 8):
        assert tio.artifact_feed_spec(meta, b) == pred.feed_spec(b)
        assert jio.artifact_feed_spec(meta, b) == pred.feed_spec(b)
    assert jio.artifact_fingerprint(d)[1] == tio.artifact_fingerprint(d)[1]
    assert jres.validate_checkpoint(d)["meta"] == {"kind": "inference_model"}
    jd = str(tmp_path / "jart")
    jio.save_inference_model(jd, jpt.build(jmnist.mlp), jax_params[0], jax_params[1],
                             _feed(4))
    jmeta = tio.read_artifact_meta(jd)
    assert tres.validate_checkpoint(jd) == jmeta["manifest"]
    assert tio.artifact_feed_spec(jmeta["meta"]) == jio.artifact_feed_spec(jmeta["meta"])
    assert tio.artifact_fingerprint(jd)[1] == jio.artifact_fingerprint(jd)[1]
    with pytest.raises(EnforceError, match="records no program"):
        tio.load_inference_model(jd, device="cpu")  # a StableHLO artifact


@pytest.mark.parametrize("source", ["param_path", "params"])
def test_inferencer_matches_the_reference(tmp_path, source):
    f = _feed(16)
    jt = jpt.Trainer(jpt.build(jmnist.mlp), jopt.Adam(1e-3), loss_name="loss")
    jt.startup(sample_feed=f)
    for i in range(3):
        jt.step(_feed(16, seed=i))
    d = str(tmp_path / "ck")
    jio.save_trainer(d, jt)
    if source == "param_path":
        jinf = jpt.Inferencer(jmnist.mlp, param_path=d)
        tinf = tpt.Inferencer(tmnist.mlp, param_path=d, place=CPU)
    else:
        host = {k: np.asarray(v) for k, v in jt.scope.params.items()}
        jinf = jpt.Inferencer(jmnist.mlp, params=host)
        tinf = tpt.Inferencer(tmnist.mlp, params=host, place=CPU)
    j, t = jinf.infer(f), tinf.infer(f)
    assert sorted(t) == sorted(j) and isinstance(t["logits"], np.ndarray)
    for k in t:
        np.testing.assert_allclose(t[k], np.asarray(j[k]), rtol=TOL, atol=TOL)


def test_compute_dtype_rides_with_the_artifact(tmp_path, jax_params):
    params = params_from_jax(jax_params[0], device="cpu")
    d = str(tmp_path / "bf16")
    with tpt.amp_guard("bfloat16"):
        tio.save_inference_model(d, tpt.build(tmnist.mlp), params, {}, _feed(4))
        want, _ = tpt.build(tmnist.mlp).apply(params, {}, place=CPU, **_feed(4, seed=5))
    assert tio.read_artifact_meta(d)["meta"]["compute_dtype"] == "bfloat16"
    got = tio.load_inference_model(d, device="cpu").run(_feed(4, seed=5))
    assert torch.equal(got["logits"], want["logits"])


def _module_level_net(image, label):
    return tmnist.mlp(image, label)


def test_what_cannot_be_exported(tmp_path, port_artifact):
    params = port_artifact[1]
    with pytest.raises(EnforceError, match="cannot be imported back"):
        tio.save_inference_model(str(tmp_path / "x"),
                                 tpt.build(lambda image, label: tmnist.mlp(image, label)),
                                 params, {}, _feed(2))
    with pytest.raises(NotYetPorted, match="item 27"):
        tio.save_train_artifact(str(tmp_path / "y"), None, _feed(2))
    # a module-level function of any importable module is fine
    d = str(tmp_path / "z")
    tio.save_inference_model(d, tpt.build(_module_level_net), params, {}, _feed(2))
    assert tio.read_artifact_meta(d)["meta"]["program"].endswith(":_module_level_net")
    assert tio.load_inference_model(d, device="cpu").run(_feed(2))["logits"].shape == (2, 10)


def test_artifact_dir_copy_loads_and_a_missing_file_is_corrupt(tmp_path, port_artifact):
    d = port_artifact[0]
    copy = str(tmp_path / "copy")
    shutil.copytree(d, copy)
    assert tio.load_inference_model(copy, device="cpu").batch_buckets == [1, 4, 8]
    os.remove(os.path.join(copy, "state.npz"))
    with pytest.raises(tres.CheckpointCorrupt, match="missing file 'state.npz'"):
        tio.load_inference_model(copy, device="cpu")
