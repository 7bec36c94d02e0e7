"""K steps a dispatch in the port (``Trainer.run_steps``,
``fit(steps_per_dispatch=K)``), on the CPU, against the port's own
sequential steps and against ``paddle_tpu``.

- Fused ≡ sequential, bit for bit: ``run_steps(K)`` from a given state
  against K ``step()`` calls from the same state (losses, params,
  optimizer and program state) for the MNIST MLP under SGD and Adam,
  ``mnist.conv_net`` with its batch-norm statistics, a dynamic loss
  scaler with an overflowing step inside the dispatch, the guard with a
  NaN batch at step i, a 1+1-layer Transformer at dropout 0.1 with and
  without ``DistStrategy(remat=True)``, and a 1-layer GPT program. On the CPU
  ``run_steps`` runs the same static-slot body it captures on the card.
- Against ``paddle_tpu``'s ``run_steps`` (one device, on the CPU, as
  tests/test_fused_steps.py:71 and :91 run it): the same numpy params and
  feeds give losses within rtol 1e-5 and params within atol 1e-5 (f32,
  another summation order), for the MLP and the loss-scaled case.
- The static-slot body: the K results are tensors of their own, a
  ``load_trainer``, a param assignment or a new feed signature makes the
  next dispatch use the new state or a new body.
- Mirrors of tests/test_fused_steps.py: input validation, remainders
  falling through to ``step()``, ``fit`` K semantics with and without the
  prefetch (the feeder driven with a ``put_fn``, as a CPU trainer has no
  side stream), ``fit`` K matching ``fit`` K=1, the feeder closed on an
  early exit.
"""

import os

import numpy as np
import pytest

import jax
import torch

import paddle_tpu as jpt
from paddle_tpu import optimizer as jopt
from paddle_tpu.data.feeder import stack_batches as jstack
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.parallel import DistStrategy as JStrategy

import paddle_tpu_torch as tpt
from paddle_tpu_torch import _captured_step
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core.errors import EnforceError
from paddle_tpu_torch.data import feeder as tfeeder
from paddle_tpu_torch.data import stack_batches
from paddle_tpu_torch.framework import params_from_jax
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.resilience import GuardPolicy, feed_digest

CPU = tpt.CPUPlace()
# port against paddle_tpu, f32 on the CPU: the same products summed in
# another order (tests/test_torch_mnist.py holds 20 steps to the same)
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5


def _feeds(n, bs=32, seed=0):
    r = np.random.RandomState(seed)
    return [{"image": r.randn(bs, 784).astype(np.float32),
             "label": r.randint(0, 10, (bs, 1)).astype(np.int64)} for _ in range(n)]


def _mlp(opt=None, **kw):
    return tpt.Trainer(tpt.build(tmnist.mlp), opt or topt.Adam(1e-3), loss_name="loss",
                       place=CPU, **kw)


def _state(tr):
    """Every leaf of the training state, by path."""
    out = {}

    def walk(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(f"{prefix}/{k}", v)
        else:
            out[prefix] = tree.detach().clone()

    walk("", tr._state_trees())
    return out


def _assert_same_state(a, b):
    sa, sb = _state(a), _state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _fused_against_sequential(make, feeds, **run_kw):
    """Two trainers from one state: K step() calls and one run_steps(K);
    returns the sequential trainer and both outputs after checking them
    bit for bit."""
    seq, fused = make(), make()
    _assert_same_state(seq, fused)
    outs_seq = [seq.step(f) for f in feeds]
    outs = fused.run_steps(stack_batches(feeds), **run_kw)
    assert fused.global_step == seq.global_step == len(feeds)
    for name, v in outs.items():
        assert v.shape == (len(feeds), *outs_seq[0][name].shape), name
        # bit for bit, a NaN (a skipped step's loss) equal to a NaN
        torch.testing.assert_close(v, torch.stack([o[name] for o in outs_seq]), rtol=0,
                                   atol=0, equal_nan=True, msg=name)
    _assert_same_state(seq, fused)
    return seq, outs_seq, outs


# -- fused ≡ sequential, bit for bit ----------------------------------------------


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_run_steps_matches_sequential_mlp(opt):
    make_opt = {"sgd": lambda: topt.SGD(0.05), "adam": lambda: topt.Adam(1e-3)}[opt]
    feeds = _feeds(4)
    _, _, outs = _fused_against_sequential(
        lambda: _mlp(make_opt()).startup(0, feeds[0]), feeds)
    assert outs["loss"].shape == (4,) and outs["logits"].shape == (4, 32, 10)


def test_run_steps_matches_sequential_conv_net_with_batch_norm_state():
    feeds = _feeds(3, bs=8, seed=1)

    def make():
        tr = tpt.Trainer(tpt.build(tmnist.conv_net), topt.Momentum(0.01, 0.9),
                         loss_name="loss", place=CPU)
        return tr.startup(0, feeds[0])

    seq, _, _ = _fused_against_sequential(make, feeds)
    fresh = make()
    moved = [k for k, v in seq.scope.state.items()
             if not torch.equal(v, fresh.scope.state[k])]
    assert moved, "the batch norm's moving statistics did not move"


def test_run_steps_skips_an_overflowing_step_under_a_dynamic_scaler():
    """Step 2 of 4 has non-finite grads (a NaN batch, as an overflow
    gives): its update is skipped on the device, the scale backs off, and
    the other steps grow it (growth interval 2)."""
    feeds = _feeds(4, bs=8, seed=2)
    feeds[1] = dict(feeds[1], image=np.full_like(feeds[1]["image"], np.nan))
    strat = tpt.DistStrategy(loss_scale=2.0 ** 10, dynamic_loss_scale=True,
                             loss_scale_growth_interval=2)
    _, _, outs = _fused_against_sequential(
        lambda: _mlp(topt.SGD(0.05), strategy=strat).startup(0, feeds[0]), feeds)
    assert outs["loss_scale"].tolist() == [2.0 ** 10, 2.0 ** 9, 2.0 ** 9, 2.0 ** 10]
    assert not torch.isfinite(outs["loss"][1])


def test_run_steps_guard_charges_the_step_at_fault():
    """A NaN batch at step 2 of a dispatch from global step 3: its update
    is discarded, the incident is charged to step 5 with that batch's
    digest, and the other steps train."""
    feeds = _feeds(4, bs=8, seed=3)
    bad = dict(feeds[2], image=np.full_like(feeds[2]["image"], np.nan))
    policy = GuardPolicy(max_incidents=10, window=100)
    seq, fused = (_mlp(topt.SGD(0.05), guard=policy).startup(0, feeds[0])
                  for _ in range(2))
    for tr in (seq, fused):
        for f in feeds[:3]:
            tr.step(f)
    chunk = [feeds[3], feeds[0], bad, feeds[1]]
    for f in chunk:
        seq.step(f)
    outs = fused.run_steps(stack_batches(chunk))
    for tr in (seq, fused):
        tr.drain_guard()
    assert [i for i, m in enumerate(outs["guard_nonfinite"].tolist()) if m] == [2]
    _assert_same_state(seq, fused)
    assert [i.step for i in fused.guard_incidents] == [5]
    assert [i.step for i in seq.guard_incidents] == [5]
    assert fused.guard_incidents[0].feed_digest == feed_digest(bad)
    assert fused.guard_incidents[0].feed_digest == seq.guard_incidents[0].feed_digest


def _ema_net(x, label):
    """A net whose outputs include its own state: a running mean written
    through assign_variable and the step counter."""
    from paddle_tpu_torch import layers as L
    h = L.fc(x, 8, act="tanh")
    helper = tpt.LayerHelper("ema")
    avg = helper.create_variable("mean", (8,))
    helper.assign_variable("mean", 0.9 * avg + 0.1 * h.mean(0))
    step = L.autoincreased_step_counter()
    logits = L.fc(h, 10)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    return {"loss": loss, "avg": avg, "step": step}


def test_run_steps_returns_the_state_an_output_had_before_its_update():
    """Outputs that are program state come back as they were before each
    step's update (the update writes the state in place), per step."""
    feeds = [{"x": f["image"][:, :16], "label": f["label"]} for f in _feeds(3, bs=4)]

    def make():
        tr = tpt.Trainer(tpt.build(_ema_net), topt.SGD(0.1), loss_name="loss", place=CPU)
        return tr.startup(0, feeds[0])

    _, outs_seq, outs = _fused_against_sequential(make, feeds)
    assert outs["step"].reshape(-1).tolist() == [1, 2, 3]
    assert not torch.equal(outs["avg"][1], outs["avg"][2])
    assert torch.equal(outs_seq[0]["avg"], torch.zeros(8))


SEQ2SEQ = dict(src_vocab=40, trg_vocab=40, max_len=16, d_model=16, d_inner=32, num_heads=2,
               num_encoder_layers=1, num_decoder_layers=1, dropout=0.1, ce_chunk=16)


def _seq2seq_feeds(n, b=2, s=8, seed=4):
    r = np.random.RandomState(seed)
    return [{k: r.randint(3, 40, (b, s)).astype(np.int32)
             for k in ("src_ids", "trg_ids", "labels")} for _ in range(n)]


@pytest.mark.parametrize("remat", [False, True])
def test_run_steps_matches_sequential_with_dropout(remat):
    """A 1+1-layer Transformer at dropout 0.1: the fused steps draw the
    sequential steps' masks, also where a remat recompute redraws them."""
    feeds = _seq2seq_feeds(3)
    cfg = ttr.base_config(**SEQ2SEQ, fuse_qkv=True)

    def make():
        tr = tpt.Trainer(tpt.build(ttr.make_model(cfg)), topt.Adam(1e-3),
                         loss_name="loss", fetch_list=["loss"], place=CPU,
                         strategy=tpt.DistStrategy(remat=True) if remat else None)
        return tr.startup(0, feeds[0])

    seq, _, outs = _fused_against_sequential(make, feeds)
    # the masks move the loss: the same step at eval differs
    seq.global_step = 0
    assert float(seq.eval(feeds[0])["loss"]) != float(outs["loss"][0])
    if remat:
        # the recompute drew from forks of the stream, one per remat block
        assert any(own is None for own, _ in seq._rng._plan)


def test_run_steps_dropout_differs_by_step_and_follows_rng():
    """Each fused step draws its own masks (the losses of one batch
    repeated differ), and ``rng`` replaces the derived seeds."""
    feeds = _seq2seq_feeds(1) * 3
    cfg = ttr.base_config(**SEQ2SEQ, fuse_qkv=True)

    def make():
        tr = tpt.Trainer(tpt.build(ttr.make_model(cfg)), topt.SGD(0.0),
                         loss_name="loss", fetch_list=["loss"], place=CPU)
        return tr.startup(0, feeds[0])

    a = make().run_steps(stack_batches(feeds))["loss"]
    assert len(set(a.tolist())) == 3
    b = make().run_steps(stack_batches(feeds), rng=11)["loss"]
    c = make().run_steps(stack_batches(feeds), rng=11)["loss"]
    assert torch.equal(b, c) and not torch.equal(a, b)


def test_run_steps_matches_sequential_gpt_module():
    cfg = tgpt.base_config(vocab_size=30, max_len=16, d_model=32, d_inner=64, num_heads=2,
                           num_layers=1, use_flash=True, fused_ce=True, ce_chunk=16,
                           dropout=0.1)
    r = np.random.RandomState(5)
    feeds = []
    for _ in range(3):
        ids = r.randint(3, 30, (2, 8)).astype(np.int32)
        feeds.append({"ids": ids, "labels": np.roll(ids, -1, axis=1)})

    def make():
        return tpt.Trainer(tpt.build(tgpt.make_model(cfg)), topt.AdamW(1e-3),
                           loss_name="loss", fetch_list=["loss"], device=CPU).startup(0, feeds[0])

    _fused_against_sequential(make, feeds)


# -- against paddle_tpu's run_steps -------------------------------------------------


def _jax_params(feed):
    jt = jpt.Trainer(jpt.build(jmnist.mlp), jopt.SGD(0.05), loss_name="loss")
    jt.startup(sample_feed=feed)
    return {k: np.asarray(v) for k, v in jt.scope.params.items()}


@pytest.mark.parametrize("case", ["mlp", "loss_scaled"])
def test_run_steps_matches_paddle_tpu(case):
    feeds = _feeds(4, bs=16, seed=6)
    jkw, tkw = {}, {}
    if case == "loss_scaled":
        feeds[2] = dict(feeds[2], image=np.full_like(feeds[2]["image"], np.nan))
        kw = dict(loss_scale=2.0 ** 12, dynamic_loss_scale=True,
                  loss_scale_growth_interval=2)
        jkw, tkw = {"strategy": JStrategy(**kw)}, {"strategy": tpt.DistStrategy(**kw)}
    p0 = _jax_params(feeds[0])
    jt = jpt.Trainer(jpt.build(jmnist.mlp), jopt.SGD(0.05), loss_name="loss", **jkw)
    jt.startup(sample_feed=feeds[0])
    jt.scope.params = {k: jax.numpy.asarray(v) for k, v in p0.items()}
    tt = _mlp(topt.SGD(0.05), **tkw).startup(
        0, feeds[0], params=params_from_jax(p0, device="cpu"))
    jouts = jt.run_steps(jstack(feeds))
    touts = tt.run_steps(stack_batches(feeds))
    jl, tl = np.asarray(jouts["loss"]), touts["loss"].numpy()
    finite = np.isfinite(jl)
    assert (np.isfinite(tl) == finite).all()
    np.testing.assert_allclose(tl[finite], jl[finite], rtol=LOSS_RTOL, atol=0)
    if case == "loss_scaled":
        np.testing.assert_array_equal(touts["loss_scale"].numpy(),
                                      np.asarray(jouts["loss_scale"]))
        for k in ("scale", "good_steps", "overflows"):
            assert float(tt.scope.loss_scale_state[k]) == \
                float(jt.scope.loss_scale_state[k]), k
    for k, v in jt.scope.params.items():
        np.testing.assert_allclose(tt.scope.params[k].detach().numpy(), np.asarray(v),
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)
    assert tt.global_step == jt.global_step == 4


# -- the static-slot body -----------------------------------------------------------


def test_results_are_their_own_tensors():
    feeds = _feeds(3)
    tr = _mlp().startup(0, feeds[0])
    outs = tr.run_steps(stack_batches(feeds))
    runner = tr._fused
    assert len(set(outs["loss"].tolist())) == 3
    for name, v in runner.out.items():
        assert outs[name].data_ptr() != v.data_ptr(), name
        assert torch.equal(outs[name][-1], v), name
    slot = runner.feed["image"]
    assert torch.equal(slot, torch.from_numpy(feeds[-1]["image"]))
    again = tr.run_steps(stack_batches(feeds))
    assert tr._fused is runner  # one body per trainer and feed signature
    assert not torch.equal(again["loss"], outs["loss"])  # the params moved


def test_new_state_and_new_signature_make_a_new_body(tmp_path):
    feeds = _feeds(2)
    tr = _mlp(topt.SGD(0.05)).startup(0, feeds[0])
    tr.run_steps(stack_batches(feeds))
    first = tr._fused
    # a param assignment: the next dispatch trains the assigned tensor
    name = "fc_0/w"
    new = torch.zeros_like(tr.scope.params[name]).requires_grad_()
    tr.scope.params[name] = new
    tr.run_steps(stack_batches(feeds))
    assert tr._fused is not first and tr.scope.params[name] is new
    assert not torch.equal(new, torch.zeros_like(new))
    # load_trainer: the next dispatch continues from the loaded values
    saved = _mlp(topt.SGD(0.05)).startup(1, feeds[0])
    saved.step(feeds[0])
    tio.save_trainer(str(tmp_path / "ck"), saved)
    before = tr._fused
    tio.load_trainer(str(tmp_path / "ck"), tr)
    assert tr._fused is None
    saved.step(feeds[0])
    saved.step(feeds[1])
    tr.run_steps(stack_batches(feeds))
    assert tr._fused is not before
    _assert_same_state(saved, tr)
    # another feed signature (batch 16): a new body
    loaded = tr._fused
    tr.run_steps(stack_batches(_feeds(2, bs=16)))
    assert tr._fused is not loaded
    assert tr._fused.feed["image"].shape == (16, 784)


def test_startup_drops_the_body():
    feeds = _feeds(2)
    tr = _mlp().startup(0, feeds[0])
    tr.run_steps(stack_batches(feeds))
    assert tr._fused is not None
    tr.startup(0, feeds[0])
    assert tr._fused is None and tr.global_step == 0


# -- mirrors of tests/test_fused_steps.py -----------------------------------------


def test_run_steps_validates_inputs():
    feeds = _feeds(2)
    tr = _mlp()
    with pytest.raises(EnforceError, match="startup"):
        tr.run_steps(stack_batches(feeds))
    tr.startup(sample_feed=feeds[0])
    with pytest.raises(EnforceError, match="leading axis"):
        tr.run_steps(stack_batches(feeds), k=3)
    ragged = stack_batches(feeds)
    ragged["label"] = ragged["label"][:1]
    with pytest.raises(EnforceError, match="leading dims disagree"):
        tr.run_steps(ragged)
    assert tr.global_step == 0


def test_remainder_falls_through_to_step_with_one_body():
    feeds = _feeds(6)
    tr = _mlp().startup(0, feeds[0])
    ref = _mlp().startup(0, feeds[0])
    tr.run_steps(stack_batches(feeds[:4]))
    body = tr._fused
    tr.step(feeds[4])
    tr.run_steps(stack_batches(feeds[:4]))
    tr.step(feeds[5])
    tr.run_steps(stack_batches(feeds[2:6]))
    assert tr._fused is body and body.captures == 0  # the CPU captures nothing
    assert tr.global_step == 4 + 1 + 4 + 1 + 4
    for f in feeds[:4] + [feeds[4]] + feeds[:4] + [feeds[5]] + feeds[2:6]:
        ref.step(f)
    _assert_same_state(ref, tr)


def _reader(num_batches, bs=16, seed=0):
    r = np.random.RandomState(seed)
    batches = [[(r.randn(784).astype(np.float32), np.asarray([r.randint(0, 10)], np.int64))
                for _ in range(bs)] for _ in range(num_batches)]

    def f():
        yield from batches
    return f


@pytest.fixture
def cpu_prefetch(monkeypatch):
    """fit's DeviceFeeder driven with a put_fn (a CPU trainer has no side
    stream to stage on); records each feeder fit makes."""
    made = []
    orig = tfeeder.DeviceFeeder

    class OnCPU(orig):
        def __init__(self, batches, device=None, **kw):
            super().__init__(batches, put_fn=lambda b: {k: torch.from_numpy(np.asarray(v))
                                                        for k, v in b.items()}, **kw)
            made.append(self)

    monkeypatch.setattr(tfeeder, "DeviceFeeder", OnCPU)
    return made


@pytest.mark.parametrize("prefetch", [True, False])
def test_fit_steps_per_dispatch_semantics(prefetch, tmp_path, cpu_prefetch):
    """10 batches at K=4: two fused chunks and two remainder singles;
    events per dispatch with stacked metrics, the exact global step, and
    step_interval=3 checkpoints at the dispatch boundaries that crossed
    each multiple (4, 8) and at the exact hit 9."""
    tr = _mlp().startup(0, _feeds(1, bs=16)[0])
    events = []
    cfg = tpt.CheckpointConfig(str(tmp_path), epoch_interval=0, step_interval=3,
                               max_num_checkpoints=10)
    tpt.fit(tr, _reader(10), 1, ["image", "label"], dtypes=["float32", "int64"],
            event_handler=events.append, checkpoint_config=cfg, prefetch=prefetch,
            steps_per_dispatch=4, preemption=False)
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_8", "step_9"]
    assert tr.global_step == 10
    ends = [e for e in events if e.kind == "end_step"]
    assert [(e.step, e.num_steps) for e in ends] == [(4, 4), (8, 4), (9, 1), (10, 1)]
    begins = [e for e in events if e.kind == "begin_step"]
    assert [(e.step, e.num_steps) for e in begins] == [(0, 4), (4, 4), (8, 1), (9, 1)]
    assert ends[0].metrics["loss"].shape == (4,) and ends[2].metrics["loss"].shape == ()
    end_epoch = [e for e in events if e.kind == "end_epoch"][0]
    assert end_epoch.pipeline["batches" if prefetch else "chunks"] > 0
    assert bool(cpu_prefetch) == prefetch


@pytest.mark.parametrize("prefetch", [True, False])
def test_fit_steps_per_dispatch_matches_plain_fit(prefetch, cpu_prefetch):
    def run(k):
        tr = _mlp().startup(0, _feeds(1, bs=16)[0])
        tpt.fit(tr, _reader(10), 1, ["image", "label"], dtypes=["float32", "int64"],
                prefetch=prefetch, steps_per_dispatch=k)
        return tr

    a, b = run(1), run(4)
    assert a.global_step == b.global_step == 10
    _assert_same_state(a, b)


def test_fit_resume_restacks_from_the_checkpoint(tmp_path):
    """A run stopped after its first chunk and resumed at K=3 lands the
    uninterrupted K=4 run's state: the rest of the epoch re-stacks from
    the restored position."""
    full = _mlp().startup(0, _feeds(1, bs=16)[0])
    tpt.fit(full, _reader(10), 1, ["image", "label"], dtypes=["float32", "int64"],
            prefetch=False, steps_per_dispatch=4)
    cfg = tpt.CheckpointConfig(str(tmp_path), epoch_interval=0, step_interval=4)

    def stop(e):  # after the first dispatch and its interval save
        if e.kind == "begin_step" and e.step == 4:
            raise KeyboardInterrupt

    part = _mlp().startup(0, _feeds(1, bs=16)[0])
    with pytest.raises(KeyboardInterrupt):
        tpt.fit(part, _reader(10), 1, ["image", "label"], dtypes=["float32", "int64"],
                prefetch=False, steps_per_dispatch=4, checkpoint_config=cfg,
                preemption=False, event_handler=stop)
    resumed = _mlp().startup(0, _feeds(1, bs=16)[0])
    events = []
    tpt.fit(resumed, _reader(10), 1, ["image", "label"], dtypes=["float32", "int64"],
            prefetch=False, steps_per_dispatch=3, checkpoint_config=cfg, resume=True,
            preemption=False, event_handler=events.append)
    assert [(e.step, e.num_steps) for e in events if e.kind == "end_step"] == \
        [(7, 3), (10, 3)]
    _assert_same_state(full, resumed)


def test_fit_closes_feeder_on_early_exit(cpu_prefetch):
    tr = _mlp().startup(0, _feeds(1, bs=16)[0])

    def boom(e):
        if e.kind == "end_step":
            raise RuntimeError("abort training")

    with pytest.raises(RuntimeError, match="abort training"):
        tpt.fit(tr, _reader(64), 1, ["image", "label"], dtypes=["float32", "int64"],
                event_handler=boom, steps_per_dispatch=4)
    assert cpu_prefetch, "fit did not go through DeviceFeeder"
    for f in cpu_prefetch:
        for t in f._threads:
            t.join(timeout=5.0)
            assert not t.is_alive(), "fill thread leaked after early exit"


def test_fit_rejects_steps_per_dispatch_below_one():
    tr = _mlp().startup(0, _feeds(1, bs=16)[0])
    with pytest.raises(EnforceError, match="steps_per_dispatch"):
        tpt.fit(tr, _reader(2), 1, ["image", "label"], prefetch=False, steps_per_dispatch=0)


def test_capture_failure_raises_and_runs_no_eager_step(monkeypatch):
    """A failed capture raises; nothing falls back to eager steps: the
    body never ran, the state and the global step are unchanged."""
    feeds = _feeds(2)
    tr = _mlp().startup(0, feeds[0])
    before = _state(tr)
    calls = []
    monkeypatch.setattr(type(tr), "_step_body",
                        lambda self, *a, **kw: calls.append(1))

    def fail(self, seed):
        raise _captured_step.CaptureError("capturing the step as a CUDA graph failed: test")

    monkeypatch.setattr(_captured_step.FusedSteps, "on_card", True, raising=False)
    monkeypatch.setattr(_captured_step.FusedSteps, "_capture", fail)
    with pytest.raises(_captured_step.CaptureError, match="CUDA graph"):
        tr.run_steps(stack_batches(feeds))
    assert calls == [] and tr.global_step == 0
    after = _state(tr)
    assert all(torch.equal(before[k], after[k]) for k in before)
