"""Remat policies (``framework.resolve_remat_policy``, ``remat_mode``,
``maybe_remat``) and ``DistStrategy(remat=True, remat_policy=...)`` on
the CPU, against ``paddle_tpu`` and against the port's own run without
remat.

The model is the small GPT of tests/test_torch_gpt_training.py (vocab 50
in CE chunks of 16, d_model 64, 2 heads, d_inner 128, 2 layers, seq 16,
batch 2, ``use_flash``, ``fused_ce``), built with
``build(gpt.make_model(cfg))`` in both packages from the same
JAX-initialised, jittered params. Tolerances: the losses of 3 AdamW steps
against ``paddle_tpu``'s Trainer under the same strategy at rel 1e-5 (f32,
another summation order); against the port without remat, grads and
params bit for bit (a recompute or a kept product gives the same bits on
the CPU).

What each policy keeps is counted on a training forward of that model:
the tensors autograd saves outside the checkpointed blocks
(``torch.autograd.graph.saved_tensors_hooks``; inside a block a
checkpoint saves none), plus the products a selective policy keeps (its
``MUST_SAVE`` decisions), by bytes; and the blocks recomputed in the
backward, by the FFN's ReLU calls (one a layer a forward).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils.checkpoint import CheckpointPolicy

import paddle_tpu as jpt
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.parallel import DistStrategy as JStrategy

import paddle_tpu_torch as tpt
from paddle_tpu_torch import _captured_step
from paddle_tpu_torch import framework as F
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core.errors import EnforceError
from paddle_tpu_torch.data import stack_batches
from paddle_tpu_torch.layers import stacked as S
from paddle_tpu_torch.models import gpt as tgpt

CPU = "cpu"
SMALL = dict(vocab_size=50, max_len=32, d_model=64, d_inner=128, num_heads=2,
             num_layers=2, use_flash=True, fused_ce=True, ce_chunk=16)
B, SEQ, STEPS, LR = 2, 16, 3, 1e-3
POLICIES = [None, "nothing", "dots_no_batch", "dots", "everything"]
RTOL = 1e-5
_RELU, _SELECTIVE = torch.relu, F.create_selective_checkpoint_contexts


def _feeds(n=STEPS, seed=0):
    rng = np.random.RandomState(seed)
    feeds = []
    for _ in range(n):
        ids = rng.randint(3, SMALL["vocab_size"], (B, SEQ)).astype(np.int32)
        labels = np.concatenate([ids[:, 1:], np.full((B, 1), 2)], 1).astype(np.int32)
        labels[0, -4:] = 0
        feeds.append({"ids": ids, "labels": labels})
    return feeds


@pytest.fixture(scope="module")
def jax_params():
    prog = jpt.build(jgpt.make_model(jgpt.base_config(**SMALL)))
    params, _ = prog.init(jax.random.PRNGKey(0), **_feeds(1)[0])
    rng = np.random.RandomState(1)
    return {k: (np.asarray(v) + 0.1 * rng.randn(*np.shape(v))).astype(np.float32)
            for k, v in sorted(params.items())}


def _port_trainer(params, strategy=None, **cfg_kw):
    prog = tpt.build(tgpt.make_model(tgpt.base_config(**{**SMALL, **cfg_kw})))
    tr = tpt.Trainer(prog, topt.AdamW(LR), fetch_list=["loss"], device=CPU,
                     strategy=strategy)
    return tr.startup(sample_feed=_feeds(1)[0], params=F.params_from_jax(params, device=CPU))


def _steps(tr):
    """(losses, step-1 grads) of STEPS steps."""
    losses, grads = [], None
    for f in _feeds():
        losses.append(float(tr.step(f)["loss"]))
        if grads is None:
            grads = {k: p.grad.clone() for k, p in tr.scope.params.items()}
    return losses, grads


@pytest.fixture(scope="module")
def port_plain(jax_params):
    tr = _port_trainer(jax_params)
    losses, grads = _steps(tr)
    return losses, grads, {k: p.detach().clone() for k, p in tr.scope.params.items()}


@pytest.mark.parametrize("policy", POLICIES)
def test_strategy_remat_policy_trains_as_paddle_tpu(jax_params, port_plain, policy):
    jtr = jpt.Trainer(jpt.build(jgpt.make_model(jgpt.base_config(**SMALL))),
                      jopt.AdamW(LR), loss_name="loss", fetch_list=["loss"],
                      strategy=JStrategy(remat=True, remat_policy=policy))
    jtr.startup(sample_feed=_feeds(1)[0])
    jtr.scope.params = {k: jnp.asarray(v) for k, v in jax_params.items()}
    jlosses = [float(jtr.step(f)["loss"]) for f in _feeds()]
    tr = _port_trainer(jax_params, tpt.DistStrategy(remat=True, remat_policy=policy))
    losses, grads = _steps(tr)
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    plain_losses, plain_grads, plain_params = port_plain
    assert losses == plain_losses
    for k, p in tr.scope.params.items():
        assert torch.equal(grads[k], plain_grads[k]), k
        assert torch.equal(p.detach(), plain_params[k]), k


def _count_relu(monkeypatch):
    calls = []
    monkeypatch.setattr(torch, "relu", lambda x: calls.append(1) or _RELU(x))
    return calls


def _kept(monkeypatch, jax_params, policy):
    """(tensors and bytes saved outside the blocks, products and bytes a
    selective policy kept, ReLU calls in forward and backward) of one
    training forward and backward under ``remat_mode(True, policy)``;
    ``"off"`` runs without remat."""
    kept = []

    def counting(policy_fn, *a, **kw):
        def wrapped(ctx, op, *args, **kwargs):
            decision = policy_fn(ctx, op, *args, **kwargs)
            if decision == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
                kept.append(ctx.op_output.numel() * ctx.op_output.element_size())
            return decision
        return _SELECTIVE(wrapped, *a, **kw)

    monkeypatch.setattr(F, "create_selective_checkpoint_contexts", counting)
    relu = _count_relu(monkeypatch)
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    prog = tpt.build(tgpt.make_model(tgpt.base_config(**SMALL)))
    feed = _feeds(1)[0]
    params = F.params_from_jax(jax_params, device=CPU)
    prog.init(0, place=CPU, **feed)
    for p in params.values():
        p.requires_grad_()
    relu.clear()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), \
            F.remat_mode(policy != "off", policy=None if policy == "off" else policy):
        out, _ = prog.apply(params, {}, training=True, place=CPU, **feed)
    forward_relu = len(relu)
    out["loss"].backward()
    return {"saved": len(saved), "kept": len(kept), "bytes": sum(saved) + sum(kept),
            "forward_relu": forward_relu, "relu": len(relu)}


def test_what_each_policy_keeps_and_recomputes(monkeypatch, jax_params):
    """Full recompute (None, "nothing") keeps least and recomputes every
    block; "dots_no_batch" keeps the blocks' 2-D products (4 a layer:
    qkv, out, ffn_in, ffn_out), "dots" those and the attention's batched
    products (the flash kernels' plain versions on the CPU), and
    "everything" runs no checkpoint: it keeps what no remat keeps and
    recomputes nothing."""
    L = SMALL["num_layers"]
    got = {p: _kept(monkeypatch, jax_params, p) for p in POLICIES + ["off"]}
    for p, g in got.items():
        assert g["forward_relu"] == L, p
    for p in (None, "nothing", "dots_no_batch", "dots"):
        assert got[p]["relu"] == 2 * L, p  # each block ran again
    assert got["everything"]["relu"] == got["off"]["relu"] == L
    assert got["everything"] == got["off"]
    assert got[None] == got["nothing"] and got["nothing"]["kept"] == 0
    assert got["dots_no_batch"]["kept"] == 4 * L
    assert got["dots"]["kept"] > got["dots_no_batch"]["kept"]
    assert got["nothing"]["saved"] == got["dots"]["saved"] < got["off"]["saved"]
    assert (got["nothing"]["bytes"] < got["dots_no_batch"]["bytes"]
            < got["dots"]["bytes"] < got["everything"]["bytes"])


def test_remat_mode_reaches_the_gpt_stack(monkeypatch):
    """F5: ``apply_stacked`` passes ``enabled=remat or None`` (JAX
    stacked.py:436), so a config's ``remat=False`` defers to the ambient
    ``remat_mode``: under ``remat_mode(True)`` every stacked layer of the
    GPT program is checkpointed (its block runs again in the backward),
    and so under ``DistStrategy(remat=True)``."""
    L = SMALL["num_layers"]
    relu = _count_relu(monkeypatch)
    feed = _feeds(1)[0]
    prog = tpt.build(tgpt.make_model(tgpt.base_config(**SMALL)))
    params, _ = prog.init(0, place=CPU, **feed)
    for p in params.values():
        p.requires_grad_()
    for on in (False, True):
        relu.clear()
        with F.remat_mode(on):
            out, _ = prog.apply(params, {}, training=True, place=CPU, **feed)
        out["loss"].backward()
        assert len(relu) == (2 * L if on else L), on
    tr = tpt.Trainer(prog, topt.AdamW(LR), device=CPU,
                     strategy=tpt.DistStrategy(remat=True)).startup(0, feed)
    relu.clear()
    tr.step(feed)
    assert len(relu) == 2 * L
    # apply_stacked alone: remat=False under remat_mode(True) checkpoints
    x = torch.randn(2, 4, 8, requires_grad=True)
    stack = {"w": torch.randn(3, 8, 8, requires_grad=True)}

    def make_block(**kw):
        return lambda t, p: torch.relu(t @ p["w"])

    for on in (False, True):
        relu.clear()
        with F.remat_mode(on):
            y = S.apply_stacked(x, stack, make_block, remat=False)
        y.sum().backward()
        assert len(relu) == (6 if on else 3), on


@pytest.mark.parametrize("ambient", [False, True])
def test_the_trainer_replaces_the_ambient_remat_mode(monkeypatch, ambient):
    """The Trainer enters ``remat_mode(strategy.remat, policy=
    strategy.remat_policy)`` around every training run, as the JAX
    Trainer does (executor.py:615): the strategy decides, whatever
    ``remat_mode`` surrounds the step. A policy without ``remat`` keeps
    remat off."""
    L = SMALL["num_layers"]
    relu = _count_relu(monkeypatch)
    feed = _feeds(1)[0]
    prog = tpt.build(tgpt.make_model(tgpt.base_config(**SMALL)))
    for strategy, want in ((None, L), (tpt.DistStrategy(remat_policy="dots"), L),
                           (tpt.DistStrategy(remat=True), 2 * L)):
        tr = tpt.Trainer(prog, topt.AdamW(LR), device=CPU,
                         strategy=strategy).startup(0, feed)
        relu.clear()
        with F.remat_mode(ambient):
            tr.step(feed)
        assert len(relu) == want, (strategy, ambient)


@pytest.mark.parametrize("policy", POLICIES)
def test_policies_replay_dropout_masks(policy):
    """At dropout 0.1 (the dense attention, whose masks each block draws
    from the step's stream) a recomputed block draws its forward's masks
    under every policy: the grads equal those without remat, bit for
    bit."""
    feed = _feeds(1)[0]
    prog = tpt.build(tgpt.make_model(tgpt.base_config(**dict(SMALL, dropout=0.1))))
    grads = {}
    for remat in (False, True):
        strategy = tpt.DistStrategy(remat=True, remat_policy=policy) if remat else None
        tr = tpt.Trainer(prog, topt.AdamW(LR), device=CPU, strategy=strategy).startup(0, feed)
        tr.step(feed, rng=5)
        grads[remat] = {k: p.grad.clone() for k, p in tr.scope.params.items()}
    for k in grads[False]:
        assert torch.equal(grads[True][k], grads[False][k]), k


def test_run_steps_under_a_policy_and_its_key(jax_params):
    """K steps of ``run_steps`` (the body a card captures) under
    ``DistStrategy(remat=True, remat_policy="dots")`` equal K ``step()``
    calls bit for bit; the captured step is keyed on the strategy's remat
    and policy, so another policy takes another body, and not on the
    ambient ``remat_mode``, which the Trainer's own replaces."""
    feeds = _feeds()
    strategy = tpt.DistStrategy(remat=True, remat_policy="dots")
    seq, fused = _port_trainer(jax_params, strategy), _port_trainer(jax_params, strategy)
    want = torch.stack([seq.step(f)["loss"] for f in feeds])
    stacked = stack_batches(feeds)
    assert torch.equal(fused.run_steps(stacked)["loss"], want)
    for k, p in seq.scope.params.items():
        assert torch.equal(p, fused.scope.params[k]), k
    feed_k = {k: torch.from_numpy(v) for k, v in stacked.items()}
    base = _captured_step.signature(fused, feed_k)
    with F.remat_mode(False):
        assert _captured_step.signature(fused, feed_k) == base
    fused.strategy = tpt.DistStrategy(remat=True, remat_policy="everything")
    assert _captured_step.signature(fused, feed_k) != base


def test_policy_names_resolve():
    assert F.resolve_remat_policy(None) is None
    assert F.resolve_remat_policy("nothing") is F.nothing_saveable
    assert F.resolve_remat_policy("everything") is F.everything_saveable
    assert F.resolve_remat_policy("dots") is F.dots_saveable
    assert F.resolve_remat_policy("dots_no_batch") is F.dots_with_no_batch_dims_saveable
    mine = F.dots_saveable
    assert F.resolve_remat_policy(mine) is mine
    with pytest.raises(EnforceError, match="options"):
        F.resolve_remat_policy("all")
    with pytest.raises(EnforceError, match="options"):
        tpt.Trainer(tpt.build(tgpt.make_model(tgpt.base_config(**SMALL))), topt.SGD(0.1),
                    device=CPU, strategy=tpt.DistStrategy(remat=True, remat_policy="x"))
    fn = lambda x: x  # noqa: E731
    with F.remat_mode(True, policy="everything"):
        assert F.maybe_remat(fn) is fn  # keeps everything: no checkpoint
        assert F.remat_policy() is F.everything_saveable
    with F.remat_mode(True):
        assert F.maybe_remat(fn) is not fn
        assert F.maybe_remat(fn, policy="everything") is fn  # the explicit one wins
    assert F.remat_policy() is None and not F.remat_enabled()
