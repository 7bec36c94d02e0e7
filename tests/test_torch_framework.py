"""The port's ``build``/``Program``/``LayerHelper`` against the JAX
package's, on the CPU: the same functions built in both give the same
parameter names, shapes, dtypes and attributes, and from params and state
carried across as numpy they give the same outputs and new state.

Tolerances: f32 outputs and state to 1e-6 (rtol and atol: the same f32
products summed in another order); bf16 outputs (``amp_guard``) to 2**-7
relative, one bf16 rounding. Initial values differ by design (threefry
against the CPU generator), so they are checked by their statistics: the
mean of a Xavier-uniform draw within 5 standard errors of 0, its variance
within 5% of limit²/3, every value inside ±limit."""

import math
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as jpt
from paddle_tpu import layers as jL
from paddle_tpu import regularizer as jreg
from paddle_tpu.models import mnist as jmnist

import paddle_tpu_torch as tpt
from paddle_tpu_torch import framework as F
from paddle_tpu_torch import initializer as tinit
from paddle_tpu_torch import layers as tL
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.core.dtypes import dtype_name
from paddle_tpu_torch.core.errors import NotYetPorted
from paddle_tpu_torch.models import mnist as tmnist

TOL = 1e-6


def _attr_net(pt, L, reg):
    """A net that uses every naming and state feature: name_scope,
    ParamAttr(name=, learning_rate=, regularizer=), trainable=False,
    WeightNormParamAttr, a list-input fc, reuse_names, the step counter, a
    global var and a state variable written through assign_variable."""

    def net(x, label):
        with pt.name_scope("enc"):
            h = L.fc(x, 8, act="tanh")
            h = L.fc(h, 8, bias_attr=False, param_attr=pt.ParamAttr(
                name="shared_w", learning_rate=0.5, regularizer=reg.L2Decay(0.1)))
        frozen = L.fc(h, 6, act="sigmoid", param_attr=pt.ParamAttr(trainable=False))
        wn = L.fc(frozen, 5, param_attr=pt.WeightNormParamAttr(dim=1))
        both = L.fc([h, wn], 4, act="relu", bias_attr=pt.ParamAttr(regularizer=reg.L1Decay(0.2)))
        with pt.framework.reuse_names():
            a = L.fc(both, 3)
        b = L.fc(both, 3)  # fc_5 again: the same params as a
        helper = pt.LayerHelper("ema")
        avg = helper.create_variable("mean", (3,))
        helper.assign_variable("mean", 0.9 * avg + 0.1 * L.mean(a + b) * L.ones_like(avg))
        step = L.autoincreased_step_counter()
        gv = L.create_global_var([3], 1.5, name="gv")
        logits = L.fc(a + b + gv, 10)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        return {"loss": loss, "logits": logits, "avg": avg, "step": step}

    return net


NETS = {
    "mnist_mlp": (lambda: jmnist.mlp, lambda: tmnist.mlp, 784),
    "attr_net": (lambda: _attr_net(jpt, jL, jreg), lambda: _attr_net(tpt, tL, treg), 12),
}


def _feed(width, seed=0, n=6):
    rng = np.random.RandomState(seed)
    return {"x" if width != 784 else "image": rng.randn(n, width).astype(np.float32),
            "label": rng.randint(0, 10, (n, 1)).astype(np.int64)}


def _jax_init(fn, feed, seed=0):
    prog = jpt.build(fn)
    params, state = prog.init(jax.random.PRNGKey(seed), **feed)
    return prog, {k: np.asarray(v) for k, v in params.items()}, \
        {k: np.asarray(v) for k, v in state.items()}


def _port_program(fn, feed):
    prog = tpt.build(fn)
    params, state = prog.init(0, **{k: torch.from_numpy(v) for k, v in feed.items()})
    return prog, params, state


def _jittered(params, seed=3, scale=0.01):
    rng = np.random.RandomState(seed)
    return {k: (v + scale * rng.randn(*v.shape)).astype(v.dtype) for k, v in params.items()}


def _reg_key(reg):
    return None if reg is None else (type(reg).__name__, reg.coeff)


@pytest.mark.parametrize("net", sorted(NETS))
def test_init_names_shapes_dtypes_and_param_info_agree(net):
    jfn, tfn, width = NETS[net]
    feed = _feed(width)
    jprog, jparams, jstate = _jax_init(jfn(), feed)
    tprog, tparams, tstate = _port_program(tfn(), feed)
    assert {k: (v.shape, v.dtype.name) for k, v in jparams.items()} == \
        {k: (tuple(v.shape), dtype_name(v.dtype)) for k, v in tparams.items()}
    assert {k: (v.shape, v.dtype.name) for k, v in jstate.items()} == \
        {k: (tuple(v.shape), dtype_name(v.dtype)) for k, v in tstate.items()}
    for k, ji in jprog.param_info.items():
        ti = tprog.param_info[k]
        assert (tuple(ji.shape), np.dtype(ji.dtype).name, ji.trainable, ji.learning_rate,
                _reg_key(ji.regularizer)) == \
            (ti.shape, dtype_name(ti.dtype), ti.trainable, ti.learning_rate,
             _reg_key(ti.regularizer)), k
    assert sorted(jprog.param_info) == sorted(tprog.param_info)
    if net == "attr_net":  # the names each feature gives
        assert {"enc/fc_0/w", "shared_w", "fc_2/w", "fc_3/w@wn_g", "fc_4/w_0",
                "fc_4/w_1", "fc_5/w", "fc_6/w"} <= set(tparams)
        assert "fc_7/w" not in tparams  # reuse_names: the second fc_5 shares
        assert set(tstate) == {"ema_0/mean", "step_counter/value", "gv/value"}


@pytest.mark.parametrize("net", sorted(NETS))
def test_apply_outputs_and_state_agree_on_carried_params(net):
    jfn, tfn, width = NETS[net]
    feed = _feed(width)
    jprog, jparams, jstate = _jax_init(jfn(), feed)
    jparams = _jittered(jparams)
    jstate = {k: (v + 1).astype(v.dtype) for k, v in jstate.items()}  # not the init value
    tprog, _, _ = _port_program(tfn(), feed)
    for training in (False, True):
        jout, jnew = jprog.apply({k: jnp.asarray(v) for k, v in jparams.items()},
                                 {k: jnp.asarray(v) for k, v in jstate.items()},
                                 training=training, **feed)
        tout, tnew = tprog.apply(F.params_from_jax(jparams, tprog.param_info, device="cpu"),
                                 F.params_from_jax(jstate, device="cpu"), training=training,
                                 **{k: torch.from_numpy(v) for k, v in feed.items()})
        for k in jout:
            np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)
        assert sorted(jnew) == sorted(tnew)
        for k in jnew:
            np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]), rtol=TOL,
                                       atol=TOL, err_msg=k)


def test_frozen_param_gets_no_grad_and_trainable_ones_match_jax():
    jfn, tfn, width = NETS["attr_net"]
    feed = _feed(width)
    jprog, jparams, jstate = _jax_init(jfn(), feed)
    jparams = _jittered(jparams)
    tprog, _, _ = _port_program(tfn(), feed)
    jgrads = jax.grad(lambda p: jprog.apply(p, jstate, **feed)[0]["loss"])(
        {k: jnp.asarray(v) for k, v in jparams.items()})
    tparams = {k: v.requires_grad_() for k, v in F.params_from_jax(jparams, device="cpu").items()}
    out, _ = tprog.apply(tparams, F.params_from_jax(jstate, device="cpu"),
                         **{k: torch.from_numpy(v) for k, v in feed.items()})
    out["loss"].backward()
    assert tparams["fc_2/w"].grad is None  # trainable=False: detached
    assert float(jnp.abs(jgrads["fc_2/w"]).max()) == 0.0  # stop_gradient: zeros
    for k, g in jgrads.items():
        if k != "fc_2/w":
            np.testing.assert_allclose(tparams[k].grad.numpy(), np.asarray(g),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_compute_dtype_is_recorded_on_the_program_run():
    """``amp_guard`` around apply makes fc compute in bf16 as the JAX
    package's does; a guard entered inside the running program does not
    change the run's dtype (layers read the context, not a global)."""
    feed = _feed(784)
    jprog, jparams, _ = _jax_init(jmnist.mlp, feed)
    tprog, _, _ = _port_program(tmnist.mlp, feed)
    tp = F.params_from_jax(jparams, device="cpu")
    with jpt.amp_guard("bfloat16"):
        jout, _ = jprog.apply({k: jnp.asarray(v) for k, v in jparams.items()}, {}, **feed)
    with tpt.amp_guard("bfloat16"):
        tout, _ = tprog.apply(tp, {}, **{k: torch.from_numpy(v) for k, v in feed.items()})
    assert tout["logits"].dtype == torch.bfloat16 and jout["logits"].dtype == jnp.bfloat16
    np.testing.assert_allclose(tout["logits"].float().numpy(),
                               np.asarray(jout["logits"], np.float32), rtol=2 ** -7, atol=2 ** -7)

    seen = []

    def probe(x):
        with tpt.amp_guard("bfloat16"):
            seen.append(F.compute_dtype())
        return {"y": tL.fc(x, 2)}

    prog = tpt.build(probe)
    x = torch.ones(2, 3)
    params, _ = prog.init(0, x)
    out, _ = prog.apply(params, {}, x)
    assert seen == [torch.float32, torch.float32] and out["y"].dtype == torch.float32

    # another thread's guard is not this thread's
    other = []
    with tpt.amp_guard("bfloat16"):
        t = threading.Thread(target=lambda: other.append(F.compute_dtype()))
        t.start()
        t.join(timeout=10)
    assert other == [torch.float32]


@pytest.mark.parametrize("seed", [0, 1, 7, 123456])
def test_initial_values_by_statistics_per_name(seed):
    """Every param of ``build(mnist.mlp)`` at several seeds: Xavier-uniform
    weights with the right spread, zero biases; another seed or another
    name draws other numbers."""
    feed = {k: torch.from_numpy(v) for k, v in _feed(784).items()}
    prog = tpt.build(tmnist.mlp)
    params, _ = prog.init(seed, **feed)
    other, _ = prog.init(seed + 1, **feed)
    for name, p in params.items():
        if name.endswith("/b"):
            assert torch.count_nonzero(p) == 0, name
            continue
        fan_in, fan_out = p.shape
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        var = limit ** 2 / 3
        n = p.numel()
        assert abs(p.mean().item()) < 5 * math.sqrt(var / n), name
        assert abs(p.var().item() / var - 1) < 0.05, name
        assert p.abs().max().item() <= limit, name
        assert not torch.equal(p, other[name]), name
    assert not torch.equal(params["fc_1/w"][:10, :10], params["fc_0/w"][:10, :10])
    g = tinit.param_generator(seed, "fc_1/w")
    again = tinit.Xavier()(g, (200, 200), torch.float32)
    assert torch.equal(again, params["fc_1/w"])  # one generator per name


def test_rng_streams_are_seeded_and_folded():
    def draw(x):
        with F.rng_fold(3):
            folded = tL.uniform_random([4])
        return {"a": tL.uniform_random([4]), "b": tL.uniform_random([4]), "f": folded}

    prog = tpt.build(draw)
    x = torch.zeros(1)
    one, _ = prog.apply({}, {}, x, rng=5)
    two, _ = prog.apply({}, {}, x, rng=5)
    other, _ = prog.apply({}, {}, x, rng=6)
    assert all(torch.equal(one[k], two[k]) for k in one)
    assert not torch.equal(one["a"], one["b"]) and not torch.equal(one["a"], other["a"])
    assert not torch.equal(one["f"], one["a"])
    with pytest.raises(Exception, match="needs an RNG"):
        prog.apply({}, {}, x)


def test_maybe_remat_recomputes_with_the_same_params_and_grads():
    """A block run under ``maybe_remat`` fetches the same params in its
    backward recompute, and the grads equal those without remat."""

    def net(x, remat):
        h = tL.fc(x, 6, act="tanh")
        block = F.maybe_remat(lambda t: tL.fc(tL.fc(t, 6, act="tanh"), 6, act="tanh"),
                              enabled=remat)
        return {"loss": tL.mean(tL.fc(block(h), 1))}

    x = torch.randn(4, 5, generator=torch.Generator().manual_seed(0))
    prog = tpt.build(lambda x: net(x, False))
    params, _ = prog.init(0, x)
    grads = {}
    for remat in (False, True):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        out, _ = tpt.build(lambda x: net(x, remat)).apply(p, {}, x)
        out["loss"].backward()
        grads[remat] = {k: v.grad for k, v in p.items()}
    assert sorted(grads[True]) == sorted(params)
    for k in params:
        torch.testing.assert_close(grads[True][k], grads[False][k], rtol=0, atol=0)
    with pytest.raises(NotYetPorted):
        with F.remat_mode(True, policy="dots"):
            pass


@pytest.mark.parametrize("call", ["desc", "desc_flat", "pipeline_mode", "sp_mode"])
def test_jaxpr_and_multi_gpu_parts_are_not_ported(call):
    prog = tpt.build(tmnist.mlp)
    fn = {"desc": lambda: prog.desc({}, {}), "desc_flat": lambda: prog.desc_flat({}, {}),
          "pipeline_mode": lambda: F.pipeline_mode(None, 2),
          "sp_mode": lambda: F.sp_mode(None)}[call]
    with pytest.raises(NotYetPorted):
        fn()


def test_program_guard_and_layers_outside_a_program():
    prog = tpt.build(tmnist.mlp)
    assert tpt.default_main_program() is None
    with tpt.program_guard(prog):
        assert tpt.default_main_program() is prog is tpt.default_startup_program()
    assert tpt.default_main_program() is None
    with pytest.raises(Exception, match="No build context active"):
        tL.fc(torch.ones(2, 3), 4)
    with pytest.raises(Exception, match="not found in scope"):
        prog.apply({}, {}, torch.ones(2, 784), torch.zeros(2, 1, dtype=torch.int64))


def test_params_from_jax_checks_against_the_program():
    feed = _feed(784)
    _, jparams, _ = _jax_init(jmnist.mlp, feed)
    tprog, _, _ = _port_program(tmnist.mlp, feed)
    got = F.params_from_jax(jparams, tprog.param_info, device="cpu")
    assert all(np.array_equal(got[k].numpy(), jparams[k]) for k in jparams)
    with pytest.raises(Exception, match="missing params"):
        F.params_from_jax({k: v for k, v in jparams.items() if k != "fc_0/b"},
                          tprog.param_info, device="cpu")
    bad = dict(jparams, **{"fc_0/b": jparams["fc_0/b"][:3]})
    with pytest.raises(Exception, match="fc_0/b"):
        F.params_from_jax(bad, tprog.param_info, device="cpu")


def test_flags_are_the_jax_flags_that_mean_something_on_the_card(monkeypatch):
    """The JAX package's flags less its TPU/XLA ones; env overrides as
    ``PDTPU_<NAME>``; the deterministic switch maps to PyTorch's."""
    from paddle_tpu.core import config as jconfig
    from paddle_tpu_torch.core import config
    dropped = {"rng_impl", "compile_cache_dir", "flash_block_q", "flash_block_k"}
    assert set(config.flags()) == set(jconfig.flags()) - dropped
    assert {k: v for k, v in config.flags().items()} == \
        {k: v for k, v in jconfig.flags().items() if k not in dropped}
    monkeypatch.setenv("PDTPU_PORT_TEST_FLAG", "7")
    try:
        config.define_flag("port_test_flag", 1)
        assert config.get_flag("port_test_flag") == 7
    finally:
        config._REGISTRY.pop("port_test_flag", None)
    before = torch.are_deterministic_algorithms_enabled()
    config.enable_determinism()
    try:
        assert torch.are_deterministic_algorithms_enabled() and config.get_flag("deterministic")
    finally:
        config.disable_determinism()
    assert torch.are_deterministic_algorithms_enabled() == before
    assert not config.get_flag("deterministic")


def test_unique_name_generator_is_the_jax_one():
    from paddle_tpu.core import unique_name as ju
    from paddle_tpu_torch.core import unique_name as tu
    for mod in (ju, tu):
        g = mod.UniqueNameGenerator("p/")
        assert [g("fc"), g("fc"), g("conv")] == ["p/fc_0", "p/fc_1", "p/conv_0"]
    with tu.guard("x_"):
        assert tu.generate("fc") == "x_fc_0"


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_trainer_steps_the_attr_net_as_jax_does(opt):
    """Three Trainer steps of the attribute net from carried params: every
    param and the state (the step counter, the running mean) as the JAX
    package's, to 1e-5 (rtol and atol; Adam divides by small second
    moments); the frozen param and its accumulators untouched; the
    per-param rate, regularizers and the weight-norm gain all exercised,
    with a global L2 decay and a global-norm clip, which see the frozen
    param's zero grad in both packages."""
    from paddle_tpu import clip as jclip
    from paddle_tpu import optimizer as jopt
    from paddle_tpu_torch import clip as tclip
    from paddle_tpu_torch import optimizer as topt
    kw = {jopt: lambda: {"regularization": jreg.L2Decay(0.05),
                         "grad_clip": jclip.GradientClipByGlobalNorm(0.5)},
          topt: lambda: {"regularization": treg.L2Decay(0.05),
                         "grad_clip": tclip.GradientClipByGlobalNorm(0.5)}}
    make = {"sgd": lambda m: m.SGD(0.1, **kw[m]()),
            "adam": lambda m: m.Adam(0.01, **kw[m]())}[opt]
    jfn, tfn, width = NETS["attr_net"]
    feeds = [_feed(width, seed=s) for s in range(3)]
    jt = jpt.Trainer(jpt.build(jfn()), make(jopt), loss_name="loss", fetch_list=["avg"])
    jt.startup(sample_feed=feeds[0])
    jt.scope.params = {k: jnp.asarray(v) for k, v in _jittered(
        {k: np.asarray(v) for k, v in jt.scope.params.items()}).items()}
    start = {k: np.asarray(v) for k, v in jt.scope.params.items()}
    tt = tpt.Trainer(tpt.build(tfn()), make(topt), loss_name="loss", fetch_list=["avg"],
                     place=tpt.CPUPlace())
    tt.startup(sample_feed=feeds[0], params=F.params_from_jax(start, device="cpu"))
    for f in feeds:
        jout, tout = jt.step(f), tt.step(f)
        assert sorted(tout) == ["avg", "loss"]
        for k in ("avg", "loss"):
            np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    for k, v in jt.scope.params.items():
        np.testing.assert_allclose(tt.scope.params[k].detach().numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    for k, v in jt.scope.state.items():
        np.testing.assert_allclose(tt.scope.state[k].numpy(), np.asarray(v), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert int(tt.scope.state["step_counter/value"][0]) == 3
    assert np.array_equal(tt.scope.params["fc_2/w"].detach().numpy(), start["fc_2/w"])
    for leaf in tt.scope.opt_state["accums"]["fc_2/w"].values():
        assert torch.count_nonzero(leaf) == 0


def test_a_param_the_loss_does_not_reach_is_updated_as_jax_updates_it():
    """jax.grad gives an unreached param a zero grad, which a global L2
    decay turns into a shrink; the port's Trainer hands the optimizer the
    same zeros (autograd leaves such a param's grad None)."""
    from paddle_tpu import optimizer as jopt
    from paddle_tpu_torch import optimizer as topt

    def make(pt, L):
        def net(x):
            L.fc(x, 3, name="unused")
            return {"loss": L.mean(L.fc(x, 2))}
        return net

    feed = {"x": np.random.RandomState(0).randn(4, 5).astype(np.float32)}
    jt = jpt.Trainer(jpt.build(make(jpt, jL)), jopt.SGD(0.5, regularization=jreg.L2Decay(0.1)))
    jt.startup(sample_feed=feed)
    start = {k: np.asarray(v) for k, v in jt.scope.params.items()}
    tt = tpt.Trainer(tpt.build(make(tpt, tL)), topt.SGD(0.5, regularization=treg.L2Decay(0.1)),
                     place=tpt.CPUPlace())
    tt.startup(sample_feed=feed, params=F.params_from_jax(start, device="cpu"))
    jt.step(feed)
    tt.step(feed)
    np.testing.assert_allclose(tt.scope.params["unused/w"].detach().numpy(),
                               start["unused/w"] * (1 - 0.5 * 0.1), rtol=TOL, atol=TOL)
    for k, v in jt.scope.params.items():
        np.testing.assert_allclose(tt.scope.params[k].detach().numpy(), np.asarray(v),
                                   rtol=TOL, atol=TOL, err_msg=k)
