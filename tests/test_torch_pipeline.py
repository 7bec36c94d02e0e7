"""Pipeline parallelism of the port (``parallel/pipeline.py``, the
stacked blocks' ``tp_axis``, the Trainer's ``pp_microbatches`` and
``pp_interleave``) against ``paddle_tpu.parallel.pipeline`` and the JAX
Trainer.

In this process: the schedule's arithmetic (``interleave_perm``,
``_schedule_ticks``, ``bubble_fraction``) over a grid, and the
one-process driver (``pipeline_local``) against the JAX
``pipeline_apply`` on ``conftest``'s virtual CPU devices with the same
numpy stacked params and inputs (GPipe, interleaved, uneven groups,
extras, the interleaved rest layout, grads), as tests/test_pipeline.py
holds the JAX schedule to its sequential scan.

On one spawned gloo world of 4 ranks (``torch_dist_worker.py``, suite
"pipeline"): three Adam steps of the stacked Transformer of
tests/test_pipeline_transformer_e2e.py:20-26 (d 32, 4 heads, 4+4 layers,
batch 8, seq 12, dropout 0) at pp=4, dp2×pp2 with ``pp_interleave=2``
and tp2×pp2, from the JAX package's initial params; the port's side takes
the flash route (its plain version on the CPU), the JAX side the dense
attention. Then the interleaved trainer's eval, checkpoint and restore,
``accum_steps`` × ``pp_microbatches``, dropout on the schedule, the
enforcements and the unconsumed-context warning.

Tolerances: the schedule's outputs 1e-5 and grads 1e-4
(tests/test_pipeline.py:38, :73); the pipelined Trainers' losses 2e-4
against the JAX single-device Trainer (tests/test_pipeline_transformer_
e2e.py:187) and against the port's own unpipelined Trainer."""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.parallel import pipeline as jpp

import torch

from paddle_tpu_torch import framework as tF
from paddle_tpu_torch.core.errors import EnforceError
from paddle_tpu_torch.layers import stacked as tS
from paddle_tpu_torch.parallel import pipeline as tpp

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as W  # noqa: E402


def _jax_pp_trainer(**skw):
    from paddle_tpu.parallel import DistStrategy
    tr = pt.Trainer(pt.build(jtransformer.make_model(jtransformer.base_config(**W.PP_CFG))),
                    jopt.Adam(W.PP_LR), loss_name="loss",
                    strategy=DistStrategy(**skw) if skw else None)
    tr.startup(sample_feed=W.pp_feed(W.PP_BATCH))
    return tr


@pytest.fixture(scope="module")
def jax_losses():
    """The JAX single-device Trainer's losses, its initial params and its
    eval loss after the steps."""
    tr = _jax_pp_trainer()
    params = {k: np.asarray(v) for k, v in tr.scope.params.items()}
    feeds = [W.pp_feed(W.PP_BATCH, seed=i) for i in range(W.PP_STEPS)]
    losses = np.array([float(tr.step(f)["loss"]) for f in feeds])
    evaled = float(tr.eval(feeds[0])["loss"])
    acc = _jax_pp_trainer(accum_steps=2)
    accum = float(acc.step(W.pp_feed(W.PP_ACCUM[2], seed=9))["loss"])
    return params, losses, accum, evaled


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_losses):
    d = str(tmp_path_factory.mktemp("pipeline_world"))
    np.savez(os.path.join(d, "params_pp.npz"), **jax_losses[0])
    return dict(np.load(W.spawn_world("pipeline", d, d)))


# -- the schedule's arithmetic -----------------------------------------------------


def test_schedule_arithmetic_matches_paddle_tpu():
    for p in (1, 2, 3, 4):
        for m in (1, 2, 3, 4, 8, 9):
            for v in (1, 2, 3):
                assert tpp._schedule_ticks(m, p, v) == jpp._schedule_ticks(m, p, v)
                assert tpp.bubble_fraction(p, m, v) == jpp.bubble_fraction(p, m, v)
                L = p * v * 2
                np.testing.assert_array_equal(tpp.interleave_perm(L, p, v),
                                              jpp.interleave_perm(L, p, v))
    assert tpp.bubble_fraction(4, 8, 1) == pytest.approx(3 / 11)
    assert tpp.bubble_fraction(4, 8, 3) == pytest.approx(3 / 27)


# -- the one-process driver against the JAX schedule --------------------------------


def _layer(x, p):
    return x @ p["w"] + p["b"]


def _stacked(L, d, seed):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(L, d, d) * 0.3).astype(np.float32),
            "b": (rng.randn(L, d) * 0.1).astype(np.float32)}


# name -> (L, pp, microbatches, interleave, batch, extras, param_layout)
LOCAL_CASES = {
    "gpipe_pp4": (8, 4, 4, 1, 16, False, "stacked"),
    "interleaved_pp4_v2": (8, 4, 4, 2, 16, False, "stacked"),
    "uneven_pp2_m3_v2": (8, 2, 3, 2, 12, False, "stacked"),
    "extras_pp4_v2": (8, 4, 2, 2, 8, True, "stacked"),
    "rest_layout_pp4_v2": (8, 4, 4, 2, 16, False, "interleaved"),
}


def _jax_local(name):
    L, p, m, v, b, ex, layout = LOCAL_CASES[name]
    st = _stacked(L, 8, 2)
    rng = np.random.RandomState(3)
    x = rng.randn(b, 8).astype(np.float32)
    e = rng.randn(b, 8).astype(np.float32) if ex else None
    if layout == "interleaved":
        perm = tpp.interleave_perm(L, p, v)
        st = {k: a[perm] for k, a in st.items()}
    mesh = pt.make_mesh({"pp": p}, devices=jax.devices()[:p])

    def jlayer(a, lp, *extra):
        out = jnp.tanh(a @ lp["w"] + lp["b"])
        return out + 0.1 * extra[0] if extra else out

    def f(s, xv):
        return jpp.pipeline_apply(xv, s, jlayer, mesh, microbatches=m, interleave=v,
                                  batch_axes=(), extras=None if e is None else jnp.asarray(e),
                                  param_layout=layout)
    js = {k: jnp.asarray(a) for k, a in st.items()}
    out, vjp = jax.vjp(jax.jit(f), js, jnp.asarray(x))
    g = np.random.RandomState(4).randn(*out.shape).astype(np.float32)
    gs, gx = vjp(jnp.asarray(g))
    return st, x, e, g, np.asarray(out), {k: np.asarray(a) for k, a in gs.items()}, \
        np.asarray(gx)


@pytest.mark.parametrize("name", sorted(LOCAL_CASES))
def test_one_process_driver_matches_paddle_tpu(name):
    L, p, m, v, b, ex, layout = LOCAL_CASES[name]
    st, x, e, g, jout, jgs, jgx = _jax_local(name)
    ts = {k: torch.from_numpy(a).requires_grad_(True) for k, a in st.items()}
    tx = torch.from_numpy(x).requires_grad_(True)

    def tlayer(a, lp, *extra):
        out = torch.tanh(a @ lp["w"] + lp["b"])
        return out + 0.1 * extra[0] if extra else out

    out = tpp.pipeline_local(tx, ts, tlayer, p, m, interleave=v, param_layout=layout,
                             extras=None if e is None else torch.from_numpy(e))
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-5, atol=1e-5)
    out.backward(torch.from_numpy(g))
    for k in st:
        np.testing.assert_allclose(ts[k].grad.numpy(), jgs[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), jgx, rtol=1e-4, atol=1e-4)


def test_every_tick_of_every_rank_runs_its_backward():
    """Bubble ticks and the drain's last ticks stay in the graph (their
    cotangents zero), so a rank's backward has the forward's structure,
    as each rank of a world needs for its collectives."""
    calls = {"fwd": 0, "bwd": 0}

    class Count(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            calls["fwd"] += 1
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            calls["bwd"] += 1
            return g

    st = {k: torch.from_numpy(a).requires_grad_(True) for k, a in _stacked(8, 4, 0).items()}
    for p, m, v in ((4, 8, 1), (4, 4, 2), (2, 3, 2)):
        calls.update(fwd=0, bwd=0)
        out = tpp.pipeline_local(torch.randn(m * 2, 4), st,
                                 lambda a, lp: Count.apply(_layer(a, lp)), p, m, interleave=v)
        out.sum().backward()
        want = tpp._schedule_ticks(m, p, v) * 8 // v
        assert calls == {"fwd": want, "bwd": want}


def test_one_process_driver_checks_divisibility():
    st = {k: torch.from_numpy(a) for k, a in _stacked(4, 4, 0).items()}
    with pytest.raises(EnforceError, match="divisible by pp"):
        tpp.pipeline_local(torch.zeros(4, 4), st, _layer, 4, 2, interleave=2)
    with pytest.raises(EnforceError, match="not divisible by microbatches"):
        tpp.pipeline_local(torch.zeros(6, 4), st, _layer, 2, 4)
    with pytest.raises(EnforceError, match="param_layout"):
        tpp.pipeline_local(torch.zeros(4, 4), st, _layer, 2, 2, param_layout="rows")


def test_tick_slots_cover_every_microbatch_chunk_once():
    for p, m, v in ((4, 8, 1), (4, 8, 3), (2, 3, 2), (3, 4, 2)):
        seen = []
        for t in range(tpp._schedule_ticks(m, p, v)):
            for r in range(p):
                c, mb, _, rec = tpp.tick_slot(r, t, p, m, v)
                if t - r >= 0 and (t - r) // (v * p) * p + (t - r) % p < m:
                    seen.append((c * p + r, mb))
                if rec:
                    assert r == p - 1 and c == v - 1
        assert sorted(seen) == sorted((q, j) for q in range(p * v) for j in range(m))


class _FakeMesh:
    def __init__(self, axes):
        self.axis_names, self.shape = tuple(axes), dict(axes)


def test_pipeline_and_sequence_parallelism_cannot_wrap_one_stack():
    st = {k: torch.zeros((2,) + s) for k, s in
          tS.encoder_stack_shapes(2, 8, 16).items()}
    st = {k: v[:, ...] for k, v in st.items()}
    with tF.pipeline_mode(_FakeMesh({"pp": 2}), 2), tF.sp_mode(_FakeMesh({"sp": 2})):
        with pytest.raises(EnforceError, match="cannot wrap the same stack"):
            tS.apply_stacked(torch.zeros(2, 4, 8), st, tS.make_encoder_block, num_heads=2)


def test_pipeline_mode_is_the_ambient_switch():
    m = _FakeMesh({"pp": 2})
    assert tF.pipeline_config() is None
    with tF.pipeline_mode(m, 4, interleave=2, param_layout="interleaved") as cfg:
        got = tF.pipeline_config()
        assert got is cfg and cfg["consumed"] and cfg["interleave"] == 2
        assert cfg["microbatches"] == 4 and cfg["param_layout"] == "interleaved"
    assert tF.pipeline_config() is None
    # a program initialising never sees it; one applied does
    seen = []
    prog = tF.build(lambda x: seen.append(tF.pipeline_config()) or {"y": x})
    with tF.pipeline_mode(m, 4) as cfg:
        prog.init(0, torch.zeros(1), place="cpu")
        prog.apply({}, {}, torch.zeros(1), place="cpu")
    assert seen == [None, cfg]


def test_stack_tp_specs_match_paddle_tpu():
    from paddle_tpu.layers import stacked as jS
    for make in ("encoder", "decoder"):
        names = (tS.encoder_stack_shapes(1, 8, 8) if make == "encoder"
                 else {**tS.encoder_stack_shapes(1, 8, 8),
                       **{k: () for k in ("lnx/scale", "lnx/bias", "xq/w", "xq/b", "xkv/w",
                                          "xkv/b", "xout/w", "xout/b")}})
        got = tS.stack_tp_specs(dict.fromkeys(names))
        want = jS.stack_tp_specs(dict.fromkeys(names))
        assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}


# -- the world of 4 -----------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(W.PP_CASES))
def test_pipelined_trainer_matches_paddle_tpu(world, jax_losses, name):
    np.testing.assert_allclose(world[f"{name}/losses"], jax_losses[1], rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("name", sorted(W.PP_CASES))
def test_pipelined_trainer_matches_the_unpipelined_trainer(world, name):
    np.testing.assert_allclose(world[f"{name}/losses"], world["single/losses"], rtol=2e-4,
                               atol=2e-4)


def test_stacked_params_are_sharded_over_pp_and_tp(world):
    qkv = "encoder/encoder_stack/qkv/w"
    assert str(world[f"pp4/spec/{qkv}"]) == "P('pp', None, None, None)"
    assert world[f"pp4/local_shape/{qkv}"].tolist() == [1, 32, 3, 32]
    assert str(world[f"tp2_pp2/spec/{qkv}"]) == "P('pp', None, None, 'tp')"
    assert world[f"tp2_pp2/local_shape/{qkv}"].tolist() == [2, 32, 3, 16]
    assert world["tp2_pp2/local_shape/decoder/decoder_stack/xout/w"].tolist() == [2, 16, 32]


def test_interleaved_rest_layout_eval_and_checkpoint(world):
    names = world["inter/perm_names"].tolist()
    assert names and all("_stack/" in n for n in names)
    # eval runs the schedule on the rest layout and agrees with the
    # single-device trainer from the same params
    np.testing.assert_allclose(float(world["inter/eval"]), float(world["ck/single_eval"]),
                               rtol=2e-4)
    assert "divisible by pp_microbatches=4" in str(world["inter/eval_batch_error"])
    # logical order on disk, the optimizer state too
    assert int(world["ck/logical_equal"]) == 1
    assert int(world["ck/rest_differs"]) == 1
    assert int(world["ck/moment_logical"]) == 1
    # the trainer restores its own checkpoint and trains on
    assert int(world["ck/roundtrip_equal"]) == 1
    assert np.isfinite(float(world["ck/next_loss"]))


def test_interleaved_checkpoint_reshard_restores_on_one_device(world, jax_losses):
    """tests/test_pipeline_transformer_e2e.py:247-288: the {dp: 2, pp: 2}
    interleaved trainer's checkpoint restores on one device only through
    resilience.reshard_restore, and that trainer's eval loss is the JAX
    single-device Trainer's after the same steps, within 2e-4."""
    assert "ReshardError" in str(world["ck/plain_load_error"])
    assert "reshard_restore" in str(world["ck/plain_load_error"])
    assert str(world["ck/reshard_axes"]) == repr(({"dp": 2, "pp": 2}, None))
    got = float(world["ck/reshard_eval"])
    np.testing.assert_allclose(got, float(world["inter/eval"]), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got, jax_losses[3], atol=2e-4, rtol=2e-4)


def test_accumulation_composes_with_the_pipeline(world, jax_losses):
    np.testing.assert_allclose(float(world["accum/loss"]), jax_losses[2], rtol=2e-4)
    np.testing.assert_allclose(float(world["accum/loss"]), float(world["accum/single_loss"]),
                               rtol=2e-4)


def test_dropout_on_the_pipeline_path(world):
    kept = world["dropout/kept"]
    # the same step seed gives the same masks, another seed others
    np.testing.assert_array_equal(kept[0], kept[1])
    assert not np.array_equal(kept[0], kept[2])
    # microbatch 0 (rows 0-1) and 1 (rows 2-3) draw different masks, and two
    # layers of 0.5 keep about a quarter (one shared mask would keep a half)
    assert not np.array_equal(kept[0][:2], kept[0][2:])
    assert 0.1 < kept[0].mean() < 0.4


@pytest.mark.parametrize("name", sorted(W.PP_APPLY_CASES))
def test_pipeline_apply_on_the_world_matches_the_layer_loop(world, name):
    """The world driver (the exchange, the final sum over pp, the tp sums
    and the grads' reductions) against the plain layer loop, as
    tests/test_pipeline.py holds the JAX schedule to its scan."""
    axes, v, layout, specs = W.PP_APPLY_CASES[name]
    st, x, g = W.pp_apply_inputs(name)
    if layout == "interleaved":
        back = np.argsort(tpp.interleave_perm(4, 2, v))
        st = {k: a[back] for k, a in st.items()}
    ts = {k: torch.from_numpy(a).requires_grad_(True) for k, a in st.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tx
    for i in range(4):
        lp = {k: t[i] for k, t in ts.items()}
        out = (out + torch.relu(out @ lp["w1"]) @ lp["w2"]) if specs else W.pp_tanh_layer(out, lp)
    np.testing.assert_allclose(world[f"apply/{name}/out"], out.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(world[f"apply/{name}/dx"], tx.grad.numpy(), rtol=1e-4,
                               atol=1e-4)
    for k, t in ts.items():
        want = t.grad.numpy()
        if layout == "interleaved":
            want = want[tpp.interleave_perm(4, 2, v)]
        np.testing.assert_allclose(world[f"apply/{name}/d{k}"], want, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_enforcements_and_the_unconsumed_warning(world):
    assert "divisible by pp·interleave=2·3" in str(world["err/layers"])
    assert "not divisible by microbatches=4" in str(world["err/batch"])
    assert "data-shard product 2" in str(world["err/dshard"])
    assert "never consumed" in str(world["warn/unconsumed"][0])
