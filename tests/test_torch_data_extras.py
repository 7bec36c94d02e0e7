"""The device-resident data path of the port against ``paddle_tpu``: the
feed wire on the Trainer, on-device augmentation, the device dataset
cache, the staging ring and ``data/image.py`` (tests/test_feed_wire.py and
tests/test_device_cache.py in the port's terms), on the CPU, at MNIST MLP
width.

- uint8 and bf16 wire training against the JAX Trainer's losses
  (relative 1e-5) and params (1e-5) from carried params at the same feeds;
  in the port the uint8 wire is bit for bit the f32 feed of the logical
  values ``(u8 − 127)/64``, eager and through ``run_steps(K=4)``;
- ``set_feed_wire``/``set_augment`` after ``startup`` drop the fused step
  and take effect at the next dispatch;
- cached epochs bit-identical to streamed ones (plain, and bf16 with the
  dynamic loss scaler), with no h2d bytes after epoch 1; a partial cache
  (a prefix), an over-budget and an automatic-on-the-CPU cache (off),
  ``DeviceCache.make`` refusing garbage as the JAX package does;
  invalidation by a resumed ``fit`` (and re-admission) and by
  ``resilience.reshard_restore``;
- augmentation: K fused steps equal to K sequential ones, eval applies
  the deterministic ops only, ``AugmentSpec``'s validation errors are the
  JAX package's, ``normalize`` is bit for bit the JAX one; the port's
  flips and crops are checked by their statistics (Philox and threefry
  draw other numbers);
- the staging ring: the reader's and the wait's errors propagate and
  unblock the consumer, and a slow link is pipelined 2 deep;
- ``data/image.py``'s functions give the JAX package's arrays.
"""

import contextlib
import io as _io
import time

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as jpt
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.errors import EnforceError as JEnforceError
from paddle_tpu.data import augment as jaug
from paddle_tpu.data import device_cache as jdc
from paddle_tpu.data import image as jimage
from paddle_tpu.data.wire import WireSpec as JWireSpec
from paddle_tpu.models import mnist as jmnist

import paddle_tpu_torch as tpt
from paddle_tpu_torch import data as tdata
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import layers as tL
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch.core.errors import EnforceError
from paddle_tpu_torch.data import image as timage
from paddle_tpu_torch.data.augment import AugmentSpec, FeedAugment
from paddle_tpu_torch.data.device_cache import (DeviceCache, device_feed_nbytes,
                                                device_feed_resident_nbytes)
from paddle_tpu_torch.data.feeder import DeviceFeeder, PipelineMetrics, stack_batches
from paddle_tpu_torch.data.wire import WireSpec
from paddle_tpu_torch.framework import RngStream, params_from_jax
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.profiling import advisor
from paddle_tpu_torch.testing import faults

CPU = tpt.CPUPlace()
BS = 16
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5
IMG_WIRE = {"image": WireSpec.image_uint8()}


def _u8_feeds(n, bs=BS, seed=0):
    r = np.random.RandomState(seed)
    return [{"image": r.randint(0, 256, (bs, 784)).astype(np.uint8),
             "label": r.randint(0, 10, (bs, 1)).astype(np.int64)} for _ in range(n)]


def _logical(feed):
    return dict(feed, image=(feed["image"].astype(np.float32) - 127.0) / 64.0)


def _mlp(**kw):
    return tpt.Trainer(tpt.build(tmnist.mlp), topt.SGD(0.1), loss_name="loss",
                       place=CPU, **kw)


def _scopes_equal(a, b):
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


# -- the feed wire on the Trainer ------------------------------------------------------


@pytest.fixture
def four_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        yield
    finally:
        torch.set_num_threads(n)


WIRES = {"uint8": (lambda w: w.image_uint8(), lambda f: f),
         "bfloat16": (lambda w: w.cast("bfloat16"), _logical)}


@pytest.mark.parametrize("wire", sorted(WIRES))
def test_wire_training_equals_jax(wire, four_threads):
    make_spec, to_feed = WIRES[wire]
    feeds = [to_feed(f) for f in _u8_feeds(4, bs=64)]
    jt = jpt.Trainer(jpt.build(jmnist.mlp), jopt.SGD(0.1), loss_name="loss",
                     feed_wire={"image": make_spec(JWireSpec)})
    jt.startup(sample_feed=feeds[0])
    p0 = {k: np.asarray(v) for k, v in jt.scope.params.items()}
    tr = _mlp(feed_wire={"image": make_spec(WireSpec)})
    tr.startup(sample_feed=feeds[0], params=params_from_jax(p0, device="cpu"))
    jl = [float(jt.step(feeds[i % 4])["loss"]) for i in range(6)]
    tl = [float(tr.step(feeds[i % 4])["loss"]) for i in range(6)]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=0)
    for k, v in jt.scope.params.items():
        np.testing.assert_allclose(tr.scope.params[k].detach().numpy(), np.asarray(v),
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)
    # the wire carried the narrow dtype: 1 or 2 bytes a pixel against 4
    rep = tr.pipeline_report()
    assert rep["h2d_bytes"] < rep["logical_bytes"]


@pytest.mark.parametrize("fused", [False, True])
def test_uint8_wire_is_bit_equal_to_the_logical_f32_feed(fused):
    feeds = _u8_feeds(4)
    a = _mlp(feed_wire=IMG_WIRE).startup(0, feeds[0])
    b = _mlp().startup(0, _logical(feeds[0]))
    if fused:
        la = a.run_steps(stack_batches(feeds))["loss"]
        lb = b.run_steps(stack_batches([_logical(f) for f in feeds]))["loss"]
    else:
        la = torch.stack([a.step(f)["loss"] for f in feeds])
        lb = torch.stack([b.step(_logical(f))["loss"] for f in feeds])
    assert torch.equal(la, lb)
    _scopes_equal(a.scope, b.scope)
    # startup saw the logical dtype
    assert a.scope.params["fc_0/w"].dtype == torch.float32


def test_set_feed_wire_and_set_augment_after_startup():
    feeds = _u8_feeds(8)
    aug = {"image": AugmentSpec().random_flip(axis=1)}
    # set after startup: the trainer steps as one constructed with them
    ref = _mlp(feed_wire=IMG_WIRE, augment=aug).startup(0, feeds[0])
    tr = _mlp().startup(0, _logical(feeds[0]))
    tr.set_feed_wire(IMG_WIRE)
    tr.set_augment(aug)
    tr.set_augment(FeedAugment(aug))  # an equal table: nothing changes
    assert torch.equal(tr.run_steps(stack_batches(feeds[:4]))["loss"],
                       ref.run_steps(stack_batches(feeds[:4]))["loss"])
    _scopes_equal(tr.scope, ref.scope)
    # set after a dispatch: the fused step is dropped and the next one decodes
    a = _mlp().startup(0, _logical(feeds[0]))
    b = _mlp().startup(0, _logical(feeds[0]))
    for t in (a, b):
        t.run_steps(stack_batches([_logical(f) for f in feeds[:4]]))
    assert a._fused is not None
    a.set_feed_wire(IMG_WIRE)
    assert a._fused is None
    assert torch.equal(a.run_steps(stack_batches(feeds[4:]))["loss"],
                       b.run_steps(stack_batches([_logical(f) for f in feeds[4:]]))["loss"])
    _scopes_equal(a.scope, b.scope)


# -- the device dataset cache ------------------------------------------------------------


@pytest.fixture
def cpu_prefetch(monkeypatch):
    """fit's DeviceFeeder driven with a put_fn (a CPU trainer has no side
    stream to stage on)."""
    from paddle_tpu_torch.data import feeder as tfeeder

    class OnCPU(tfeeder.DeviceFeeder):
        def __init__(self, batches, device=None, **kw):
            super().__init__(batches, put_fn=lambda b: {
                k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}, **kw)

    monkeypatch.setattr(tfeeder, "DeviceFeeder", OnCPU)


def _batches(num, bs=BS, seed=0):
    return [[(f["image"][i], f["label"][i]) for i in range(bs)]
            for f in _u8_feeds(num, bs, seed)]


def _run(epochs=3, device_cache=None, trainer_kw=None, amp=None, prefetch=False,
         batches=None, cache=None, **fit_kw):
    batches = batches if batches is not None else _batches(8)
    losses, reports = [], []

    def handler(e):
        if e.kind == "end_step":
            losses.extend(e.metrics["loss"].reshape(-1).tolist())
        elif e.kind == "end_epoch":
            reports.append(e.pipeline)

    with (tpt.amp_guard(amp) if amp else contextlib.nullcontext()):
        tr = _mlp(feed_wire=IMG_WIRE, **(trainer_kw or {}))
        tr.startup(0, {"image": np.stack([s[0] for s in batches[0]]),
                       "label": np.stack([s[1] for s in batches[0]])})
        tpt.fit(tr, lambda: iter(batches), epochs, ["image", "label"],
                dtypes=["uint8", "int64"], steps_per_dispatch=4, prefetch=prefetch,
                device_cache=device_cache if cache is None else cache,
                event_handler=handler, **fit_kw)
    return tr, losses, reports


def _deltas(reports):
    vals = [r["h2d_bytes"] for r in reports]
    return [b - a for a, b in zip([0] + vals[:-1], vals)]


@pytest.mark.parametrize("prefetch", [False, True])
def test_cached_epochs_zero_h2d_and_bit_identical(prefetch, cpu_prefetch):
    ref, ref_losses, _ = _run(prefetch=prefetch)
    tr, losses, reports = _run(device_cache=1 << 30, prefetch=prefetch)
    assert losses == ref_losses
    _scopes_equal(ref.scope, tr.scope)
    deltas = _deltas(reports)
    assert deltas[0] > 0 and deltas[1] == 0 and deltas[2] == 0
    assert reports[-1]["cache_hits"] == 4  # 2 chunks, 2 cached epochs
    assert reports[-1]["cache_hit_bytes"] == 2 * deltas[0]
    assert tr.device_cache.report()["state"] == "full"


def test_cached_epochs_bit_identical_bf16_dynamic_loss_scale():
    strat = lambda: tpt.DistStrategy(dynamic_loss_scale=True, loss_scale_growth_interval=2)
    ref, ref_losses, _ = _run(trainer_kw={"strategy": strat()}, amp="bfloat16")
    tr, losses, reports = _run(device_cache=1 << 30, trainer_kw={"strategy": strat()},
                               amp="bfloat16")
    assert losses == ref_losses
    _scopes_equal(ref.scope, tr.scope)
    assert _deltas(reports)[1] == 0


def test_partial_off_and_auto_caches():
    chunk = 4 * BS * (784 + 8)  # one K=4 chunk of uint8 pixels and int64 labels
    ref, ref_losses, _ = _run()
    tr, losses, reports = _run(device_cache=int(1.5 * chunk))
    assert losses == ref_losses
    rep = tr.device_cache.report()
    assert rep["state"] == "partial" and rep["cached_chunks"] == 1
    assert rep["cached_steps"] == 4 and rep["resident_bytes"] == chunk
    d = _deltas(reports)
    assert 0 < d[1] < d[0] and d[1] == d[0] - chunk
    tr, losses, reports = _run(device_cache=64)  # smaller than any chunk
    assert losses == ref_losses
    assert tr.device_cache.state == "off" and "exceeds" in tr.device_cache.report()["off_reason"]
    d = _deltas(reports)
    assert d[1] == d[0] > 0
    tr, losses, _ = _run(epochs=2, device_cache=True)  # the CPU has no budget
    assert tr.device_cache.state == "off" and "budget" in tr.device_cache.report()["off_reason"]
    assert len(losses) == 16


def test_device_cache_make_rejects_garbage_as_jax():
    for garbage in ("yes please", 1.5, [1]):
        with pytest.raises(TypeError) as want:
            jdc.DeviceCache.make(garbage)
        with pytest.raises(TypeError) as got:
            DeviceCache.make(garbage)
        assert str(got.value) == str(want.value)
    assert DeviceCache.make(None) is None and DeviceCache.make(False) is None
    assert isinstance(DeviceCache.make(True), DeviceCache)
    assert isinstance(DeviceCache.make("auto"), DeviceCache)
    assert DeviceCache.make(1024).budget_bytes == 1024
    c = DeviceCache(1)
    assert DeviceCache.make(c) is c


def test_resume_invalidates_then_readmits(tmp_path):
    batches = _batches(8)
    cache = DeviceCache(budget_bytes=1 << 30)
    reasons = []
    orig = cache.invalidate
    cache.invalidate = lambda reason: (reasons.append(reason), orig(reason))[1]
    cfg = tpt.CheckpointConfig(str(tmp_path), epoch_interval=1)
    _run(epochs=1, batches=batches, cache=cache, checkpoint_config=cfg)
    assert cache.state == "full"
    tr2, _, reports = _run(epochs=2, batches=batches, cache=cache, checkpoint_config=cfg,
                           resume=True)
    assert any("restore" in r for r in reasons)
    assert cache.state == "full"  # epoch 2 started clean: admitted and sealed again
    ref, _, _ = _run(epochs=2, batches=batches)
    _scopes_equal(ref.scope, tr2.scope)


def test_reshard_restore_invalidates_the_cache(tmp_path):
    feed = _u8_feeds(1)[0]
    src = _mlp(feed_wire=IMG_WIRE).startup(0, feed)
    ck = str(tmp_path / "ck")
    tio.save_trainer(ck, src)
    tgt = _mlp(feed_wire=IMG_WIRE).startup(1, feed)
    cache = DeviceCache(budget_bytes=1 << 30, trainer=tgt)
    assert cache.offer(1, tgt._put_feed(feed))
    cache.seal(1)
    tgt.device_cache = cache
    assert cache.ready
    tres.reshard_restore(ck, tgt, sample_feed=feed)
    assert cache.state == "invalid" and cache.invalid_reason == "reshard_restore"
    assert not cache.ready and cache.resident_bytes == 0
    _scopes_equal(src.scope, tgt.scope)


def test_memory_estimate_budget_and_byte_accounting():
    feed = _u8_feeds(1)[0]
    tr = _mlp(feed_wire=IMG_WIRE).startup(0, feed)
    est = advisor.memory_estimate(tr, feed, project_remat=False)
    scope = sum(p.numel() * 4 for p in tr.scope.params.values())
    assert est["param_bytes"] == scope
    # the hidden activations the backward keeps: at least the f32 input and
    # the two hidden layers of the batch
    assert est["activation_bytes"] >= BS * (784 + 2 * 128) * 4
    assert est["est_total_bytes"] == (est["param_bytes"] + est["opt_state_bytes"]
                                      + est["state_bytes"] + est["activation_bytes"])
    assert advisor.device_hbm_bytes("cpu") is None
    assert tdata.device_cache.residual_hbm_bytes(tr, feed) is None
    assert tdata.device_cache.residual_hbm_bytes(tr, feed, hbm_budget_bytes=10 ** 9) == \
        int(0.8 * 10 ** 9) - est["est_total_bytes"]
    dev = tr._put_feed(feed)
    assert device_feed_nbytes(dev) == device_feed_resident_nbytes(dev) == BS * (784 + 8)
    m = PipelineMetrics()
    m.record_h2d(1_000_000, 0.1)
    m.record_cache_hit(50_000_000)
    rep = m.report()
    assert rep["h2d_mbps"] == 10.0 and rep["cache_hit_bytes"] == 50_000_000
    assert rep["cache_hits"] == 1 and rep["chunks"] == 1


# -- augmentation ---------------------------------------------------------------------------


def _img_model(image, label):
    logits = tL.fc(image, 10)
    return {"loss": tL.mean(tL.softmax_with_cross_entropy(logits, label)), "logits": logits}


AUG = {"image": AugmentSpec().random_crop(padding=2, axes=(1, 2)).random_flip(axis=2)
       .normalize(mean=127.0, std=64.0)}


def _img_feeds(n, bs=8, seed=3):
    r = np.random.RandomState(seed)
    return [{"image": r.randint(0, 256, (bs, 28, 28)).astype(np.uint8),
             "label": r.randint(0, 10, (bs, 1)).astype(np.int64)} for _ in range(n)]


def _aug_trainer(aug=AUG):
    tr = tpt.Trainer(tpt.build(_img_model), topt.SGD(0.1), loss_name="loss", place=CPU,
                     augment=aug)
    return tr.startup(0, _img_feeds(1)[0])


def test_augment_fused_k_equals_sequential_and_advances():
    feeds = _img_feeds(4)
    seq = _aug_trainer()
    ls = torch.stack([seq.step(f)["loss"] for f in feeds])
    fused = _aug_trainer()
    lf = fused.run_steps(stack_batches(feeds))["loss"]
    assert torch.equal(lf, ls)
    _scopes_equal(seq.scope, fused.scope)
    # the same batch twice: other draws (and an update) give another loss
    tr = _aug_trainer(AUG)
    assert float(tr.step(feeds[0])["loss"]) != float(tr.step(feeds[0])["loss"])


def test_augment_eval_applies_only_deterministic_ops():
    feed = _img_feeds(1)[0]
    tr = _aug_trainer()
    a, b = tr.eval(feed)["loss"], tr.eval(feed)["loss"]
    assert torch.equal(a, b)
    tn = _aug_trainer({"image": AugmentSpec().normalize(127.0, 64.0)})
    assert torch.equal(a, tn.eval(feed)["loss"])
    # init saw the normalized dtype
    assert tr.scope.params["fc_0/w"].dtype == torch.float32


def test_augment_spec_errors_and_normalize_equal_jax():
    cases = [lambda m: m.AugmentSpec().random_flip(axis=0),
             lambda m: m.AugmentSpec().random_flip(p=0.0),
             lambda m: m.AugmentSpec().random_crop(padding=0),
             lambda m: m.AugmentSpec().random_crop(padding=2, axes=(0, 1)),
             lambda m: m.AugmentSpec().normalize(std=0.0),
             lambda m: m.AugmentSpec().normalize(dtype="int32"),
             lambda m: m.AugmentSpec().normalize(dtype="bfloat16"),
             lambda m: m.FeedAugment({"x": "flip"}),
             lambda m: m.FeedAugment.make([1])]
    for make in cases:
        with pytest.raises(JEnforceError) as want:
            make(jaug)
        with pytest.raises(EnforceError) as got:
            make(tdata.augment)
        assert str(got.value) == str(want.value)
    base = AugmentSpec()
    assert base.normalize() is not base and base.ops == ()
    spec = (AugmentSpec().random_crop(3).random_flip(axis=-1, p=0.25)
            .normalize(10.0, 3.0, "float16"))
    jspec = (jaug.AugmentSpec().random_crop(3).random_flip(axis=-1, p=0.25)
             .normalize(10.0, 3.0, "float16"))
    assert [(o.kind, o.params) for o in spec.ops] == [(o.kind, o.params) for o in jspec.ops]
    x = np.random.RandomState(4).randint(0, 256, (4, 5, 6)).astype(np.uint8)
    norm = AugmentSpec().normalize(127.0, 64.0)
    for training in (False, True):
        got = norm.apply(torch.from_numpy(x), None, training)
        want = jaug.AugmentSpec().normalize(127.0, 64.0).apply(x, None, training)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_flip_and_crop_statistics():
    """The port draws other numbers than the JAX package, from the same
    distributions: a flip at p lands on about p of the samples, a crop's
    offsets cover [0, 2·pad] about uniformly, each sample is its image
    shifted (zeros where the padding shows)."""
    n, size, pad = 4000, 6, 2
    base = torch.arange(1, size * size + 1, dtype=torch.float32).reshape(1, size, size)
    x = base.expand(n, size, size).contiguous()
    stream = RngStream("cpu").reset(7)
    flipped = AugmentSpec().random_flip(axis=2, p=0.3).apply(x, stream, True)
    frac = float((flipped[:, 0, 0] == base[0, 0, -1]).float().mean())
    assert abs(frac - 0.3) < 0.03, frac
    assert all(torch.equal(f, base[0]) or torch.equal(f, base[0].flip(1)) for f in flipped[:50])
    cropped = AugmentSpec().random_crop(pad, axes=(1, 2)).apply(x, stream.reset(8), True)
    padded = torch.nn.functional.pad(base[0], (pad, pad, pad, pad))
    counts = np.zeros((2 * pad + 1, 2 * pad + 1))
    for c in cropped[:1000]:
        hits = [(i, j) for i in range(2 * pad + 1) for j in range(2 * pad + 1)
                if torch.equal(c, padded[i:i + size, j:j + size])]
        assert len(hits) == 1
        counts[hits[0]] += 1
    expected = 1000 / counts.size
    assert np.all(np.abs(counts - expected) < 5 * np.sqrt(expected)), counts
    # the JAX package's crop and flip keep the same shape and dtype
    j = jaug.AugmentSpec().random_crop(pad, axes=(1, 2)).random_flip(axis=2).apply(
        x.numpy(), jax.random.PRNGKey(0), True)
    assert tuple(j.shape) == tuple(cropped.shape) and str(j.dtype) == "float32"


def test_field_stream_is_keyed_by_name():
    spec = AugmentSpec().random_flip(axis=2)
    feed = {"image": torch.arange(8 * 9, dtype=torch.float32).reshape(8, 3, 3)}
    a = FeedAugment({"image": spec}).apply(feed, RngStream("cpu").reset(3), True)
    extended = dict(feed, aaa=torch.zeros(8, 3, 3))
    b = FeedAugment({"image": spec, "aaa": spec}).apply(extended, RngStream("cpu").reset(3),
                                                        True)
    assert torch.equal(a["image"], b["image"])


# -- the staging ring ---------------------------------------------------------------------


class _ReaderDied(RuntimeError):
    pass


def test_staging_ring_reader_error_propagates():
    def bad():
        yield {"x": np.zeros((4,), np.float32)}
        raise _ReaderDied("reader exploded")

    f = DeviceFeeder(bad, put_fn=lambda b: b, metrics=PipelineMetrics())
    got = []
    with pytest.raises(_ReaderDied, match="reader exploded"):
        for item in f:
            got.append(item)
    assert len(got) == 1
    f.close()
    assert not any(t.is_alive() for t in f._threads)


def test_staging_ring_wait_error_propagates_and_unblocks():
    def boom(item, t_submit):
        raise OSError("DMA engine fell over")

    def gen():
        for _ in range(6):
            yield {"x": np.zeros((4,), np.float32)}

    f = DeviceFeeder(gen, put_fn=lambda b: b, metrics=PipelineMetrics(), wait_fn=boom)
    with pytest.raises(OSError, match="DMA"):
        list(f)
    f.close()
    assert not any(t.is_alive() for t in f._threads)


def _overlap_epoch(depth, delay_ms=60.0, chunks=6, consume_s=0.010):
    def gen():
        for i in range(chunks):
            yield {"x": np.full((64,), i, np.float32)}

    m = PipelineMetrics()
    f = DeviceFeeder(gen, put_fn=lambda b: b, metrics=m,
                     wait_fn=faults.slow_h2d(delay_ms), overlap_depth=depth)
    t0 = time.perf_counter()
    got = []
    for item in f:
        time.sleep(consume_s)
        got.append(float(item["x"][0]))
    assert got == [float(i) for i in range(chunks)]
    return time.perf_counter() - t0, m.report()


def test_slow_link_overlap_depth_two_against_one():
    dt_block, rep_block = _overlap_epoch(depth=1)
    dt_ring, rep_ring = _overlap_epoch(depth=2)
    assert dt_block / dt_ring >= 1.35, (dt_block, dt_ring)
    assert rep_block["overlap_hidden_s"] == 0.0 and rep_ring["overlap_hidden_s"] > 0.0
    assert rep_block["stages_s"]["h2d"] >= 0.9 * 6 * 0.060
    assert rep_ring["stages_s"]["h2d"] >= 0.9 * 6 * 0.060
    assert rep_ring["h2d_exposed_s"] < rep_ring["stages_s"]["h2d"]


# -- data/image.py ----------------------------------------------------------------------------


def test_image_functions_equal_jax():
    rng = np.random.RandomState(5)
    im = rng.randint(0, 256, (20, 30, 3)).astype(np.uint8)
    for fn, args in ((lambda m, a: m.resize_short(a, 12), (im,)),
                     (lambda m, a: m.resize_short(a.astype(np.float32), 25), (im,)),
                     (lambda m, a: m.to_chw(a), (im,)),
                     (lambda m, a: m.center_crop(a, 10), (im,)),
                     (lambda m, a: m.left_right_flip(a), (im,)),
                     (lambda m, a: m.random_crop(a, 8, rng=np.random.RandomState(1)), (im,))):
        np.testing.assert_array_equal(fn(timage, *args), fn(jimage, *args))
    for is_train in (False, True):
        outs = []
        for m in (timage, jimage):
            np.random.seed(9)
            outs.append(m.simple_transform(im, 16, 12, is_train, mean=[1.0, 2.0, 3.0]))
        np.testing.assert_array_equal(*outs)
    pil = pytest.importorskip("PIL.Image")
    buf = _io.BytesIO()
    pil.fromarray(im).save(buf, format="PNG")
    for color in (True, False):
        np.testing.assert_array_equal(timage.load_image_bytes(buf.getvalue(), color),
                                      jimage.load_image_bytes(buf.getvalue(), color))
