"""The port's basic layers against the JAX package's, on the CPU, with the
same numpy inputs and (for ``fc``) the same params carried across: ``fc``,
every entry of ``ACTIVATIONS`` and the other activations, the tensor ops
of ``layers/tensor.py``, the losses, ``mean`` and ``accuracy``.

Tolerances, all f32: 1e-6 (rtol and atol) for outputs that are the same
arithmetic in another order; 1e-5 for the transcendental activations
(exp, tanh, erf, log1p and the like, whose f32 library functions may
differ in the last bits). Gradients, by ``torch.autograd`` against
``jax.grad`` of the same weighted sum of the outputs, to 1e-5.
``accuracy`` runs on tie-free logits (random normals), where
``torch.topk`` and ``jax.lax.top_k`` must pick the same classes."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as jpt
from paddle_tpu import layers as jL
from paddle_tpu import metrics as jmetrics

import paddle_tpu_torch as tpt
from paddle_tpu_torch import framework as F
from paddle_tpu_torch import layers as tL
from paddle_tpu_torch import metrics as tmetrics

TOL, TRANS_TOL, GRAD_TOL = 1e-6, 1e-5, 1e-5
TRANSCENDENTAL = {"sigmoid", "logsigmoid", "exp", "tanh", "tanh_shrink", "elu", "selu",
                  "gelu", "gelu_exact", "soft_relu", "softplus", "stanh", "swish", "mish",
                  "erf", "sqrt", "rsqrt", "log", "pow", "cos", "sin"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got).astype(np.float64), _np(want).astype(np.float64),
                               rtol=tol, atol=tol, err_msg=msg)


# ---------------------------------------------------------------------------
# fc, with its grads


FC_CASES = {
    "flatten_1": dict(shape=(4, 3, 5), kw=dict(num_flatten_dims=1)),
    "flatten_2": dict(shape=(2, 3, 5), kw=dict(num_flatten_dims=2)),
    "no_bias": dict(shape=(4, 7), kw=dict(bias_attr=False)),
    "list_input": dict(shape=[(4, 7), (4, 3)], kw={}),
}
FC_CASES.update({f"act_{a}": dict(shape=(4, 7), kw=dict(act=a))
                 for a in sorted(k for k in jL.ops.ACTIVATIONS if k) if a != "sqrt"})


def _fc_inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    shapes = shape if isinstance(shape, list) else [shape]
    return [rng.randn(*s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("case", sorted(FC_CASES))
def test_fc_and_its_grads_match_jax(case):
    spec = FC_CASES[case]
    xs = _fc_inputs(spec["shape"])
    listed = isinstance(spec["shape"], list)

    def make(L):
        return lambda *x: L.fc(list(x) if listed else x[0], 6, **spec["kw"])

    jprog = jpt.build(make(jL))
    jparams, _ = jprog.init(jax.random.PRNGKey(0), *xs)
    rng = np.random.RandomState(1)  # a nonzero bias
    jparams = {k: np.asarray(v) + 0.1 * rng.randn(*v.shape).astype(np.float32)
               for k, v in jparams.items()}
    cot = rng.randn(*jprog.apply(jparams, {}, *xs)[0].shape).astype(np.float32)

    def jloss(p, *x):
        return jnp.sum(jprog.apply(p, {}, *x)[0] * cot)

    jout = jprog.apply(jparams, {}, *xs)[0]
    jg = jax.grad(jloss, argnums=tuple(range(len(xs) + 1)))(
        {k: jnp.asarray(v) for k, v in jparams.items()}, *xs)

    tprog = tpt.build(make(tL))
    tprog.init(0, *[_t(x) for x in xs])
    tparams = {k: v.requires_grad_() for k, v in
               F.params_from_jax(jparams, tprog.param_info, device="cpu").items()}
    txs = [_t(x).requires_grad_() for x in xs]
    tout = tprog.apply(tparams, {}, *txs)[0]
    (tout * _t(cot)).sum().backward()
    act = spec["kw"].get("act")
    _close(tout, jout, TRANS_TOL if act in TRANSCENDENTAL else TOL, "out")
    for k in jparams:
        _close(tparams[k].grad, jg[0][k], GRAD_TOL, k)
    for i, tx in enumerate(txs):
        _close(tx.grad, jg[i + 1], GRAD_TOL, f"input {i}")


# ---------------------------------------------------------------------------
# activations


ACT_CASES = {name: (lambda L, x, n=name: getattr(L, n)(x)) for name in
             ["sigmoid", "logsigmoid", "exp", "tanh", "tanh_shrink", "softshrink", "sqrt",
              "rsqrt", "abs", "ceil", "floor", "cos", "sin", "round", "reciprocal",
              "square", "log", "relu", "relu6", "leaky_relu", "elu", "selu", "gelu",
              "brelu", "soft_relu", "softplus", "softsign", "stanh", "hard_sigmoid",
              "hard_swish", "swish", "mish", "thresholded_relu", "erf"]}
ACT_CASES.update({
    "gelu_exact": lambda L, x: L.gelu(x, approximate=False),
    "pow": lambda L, x: L.pow(x, 2.5),
    "leaky_relu_0.3": lambda L, x: L.leaky_relu(x, alpha=0.3),
    "brelu_range": lambda L, x: L.brelu(x, t_min=-1.0, t_max=1.5),
    "stanh_scales": lambda L, x: L.stanh(x, scale_a=1.2, scale_b=0.5),
    "soft_relu_threshold": lambda L, x: L.soft_relu(x, threshold=1.0),
    "maxout": lambda L, x: L.maxout(x.reshape(4, 6, 2), groups=3, axis=1),
})
POSITIVE = {"sqrt", "rsqrt", "log", "pow"}


@pytest.mark.parametrize("name", sorted(ACT_CASES))
def test_activation_matches_jax(name):
    rng = np.random.RandomState(2)
    x = (rng.randn(4, 12) * 3).astype(np.float32)
    x[0, :4] = [0.0, 0.5, -0.5, 2.5]  # ties for round, the kinks of the piecewise ones
    if name in POSITIVE:
        x = np.abs(x) + 0.1
    fn = ACT_CASES[name]
    _close(fn(tL, _t(x)), fn(jL, jnp.asarray(x)),
           TRANS_TOL if name.split("_")[0] in TRANSCENDENTAL or name in TRANSCENDENTAL
           else TOL, name)


def test_activation_table_has_the_jax_names_and_rejects_others():
    assert sorted(map(str, tL.ACTIVATIONS)) == sorted(map(str, jL.ops.ACTIVATIONS))
    x = torch.randn(3, 4)
    for name in tL.ACTIVATIONS:
        if name in ("sqrt",):
            continue
        _close(tL.apply_activation(x, name), tL.ACTIVATIONS[name](x), 0, str(name))
    assert torch.equal(tL.apply_activation(x, torch.tanh), torch.tanh(x))
    with pytest.raises(ValueError, match="Unknown activation"):
        tL.apply_activation(x, "nope")


# ---------------------------------------------------------------------------
# tensor ops


def _ops():
    """name -> fn(L, arrays as that package's tensors, kw) where ``kw`` is
    ``{"device": "cpu"}`` for the port's creation ops and {} for JAX's."""
    return {
        "cast": lambda L, a, kw: L.cast(a[0], "int32"),
        "concat": lambda L, a, kw: L.concat([a[0], a[1]], axis=1),
        "split_equal": lambda L, a, kw: L.split(a[0], 2, dim=1),
        "split_sections": lambda L, a, kw: L.split(a[0], [1, -1, 2], dim=1),
        "reshape_zero_and_infer": lambda L, a, kw: L.reshape(a[2], [0, -1, 2]),
        "reshape_plain": lambda L, a, kw: L.reshape(a[0], [2, 2, 6]),
        "transpose": lambda L, a, kw: L.transpose(a[2], [2, 0, 1]),
        "squeeze_axes": lambda L, a, kw: L.squeeze(L.unsqueeze(a[0], [0, 2]), [0]),
        "squeeze_all": lambda L, a, kw: L.squeeze(L.reshape(a[0], [1, 4, 1, 6])),
        "unsqueeze": lambda L, a, kw: L.unsqueeze(a[0], [2, 0]),
        "stack": lambda L, a, kw: L.stack([a[0], a[1]], axis=1),
        "unstack": lambda L, a, kw: L.unstack(a[0], axis=1),
        "expand": lambda L, a, kw: L.expand(a[0], [2, 1]),
        "expand_as": lambda L, a, kw: L.expand_as(a[3], a[0]),
        "tile": lambda L, a, kw: L.tile(a[0], [1, 3]),
        "slice_negative": lambda L, a, kw: L.slice(a[2], [0, 2], [1, -3], [3, 10]),
        "gather_rows": lambda L, a, kw: L.gather(a[0], a[4], axis=0),
        "gather_cols": lambda L, a, kw: L.gather(a[0], a[5], axis=1),
        "gather_nd": lambda L, a, kw: L.gather_nd(a[2], a[6]),
        "scatter_overwrite": lambda L, a, kw: L.scatter(a[0], a[7], a[1][:2]),
        "scatter_add": lambda L, a, kw: L.scatter(a[0], a[7], a[1][:2], overwrite=False),
        "scatter_nd_add": lambda L, a, kw: L.scatter_nd_add(a[2], a[6], a[2][:, 0] * 2),
        "fill_constant": lambda L, a, kw: L.fill_constant([2, 3], "float32", 2.5, **kw),
        "fill_constant_batch_size_like": lambda L, a, kw: L.fill_constant_batch_size_like(
            a[2], [1, 5], "float32", 1.5, input_dim_idx=1, output_dim_idx=1),
        "zeros": lambda L, a, kw: L.zeros([2, 3], **kw),
        "ones": lambda L, a, kw: L.ones([3], "int32", **kw),
        "zeros_like": lambda L, a, kw: L.zeros_like(a[0]),
        "ones_like": lambda L, a, kw: L.ones_like(a[0]),
        "assign": lambda L, a, kw: L.assign(np.arange(4.0, dtype=np.float32), **kw),
        "arange": lambda L, a, kw: L.arange(2, 11, 3, **kw),
        "arange_end_only": lambda L, a, kw: L.arange(5, **kw),
        "range": lambda L, a, kw: L.range(1, 4, 0.5, "float32", **kw),
        "linspace": lambda L, a, kw: L.linspace(0.0, 1.0, 7, **kw),
        "shape": lambda L, a, kw: L.shape(a[2]),
        "argmax": lambda L, a, kw: L.argmax(a[0], axis=1),
        "argmin": lambda L, a, kw: L.argmin(a[0], axis=0),
        "argsort_desc": lambda L, a, kw: L.argsort(a[0], axis=1, descending=True),
        "argsort_ties": lambda L, a, kw: L.argsort(L.floor(a[0]), axis=1),
        "where": lambda L, a, kw: L.where(a[0] > 0.5),
        "cond_select": lambda L, a, kw: L.cond_select(a[0] > 0, a[0], a[1]),
        "is_empty": lambda L, a, kw: L.is_empty(a[0]),
        "has_nan": lambda L, a, kw: L.has_nan(L.log(a[0])),
        "has_inf": lambda L, a, kw: L.has_inf(a[0]),
        "isfinite": lambda L, a, kw: L.isfinite(a[0]),
        "increment": lambda L, a, kw: L.increment(a[0], 2.0),
        "cumsum_all": lambda L, a, kw: L.cumsum(a[0]),
        "cumsum_axis": lambda L, a, kw: L.cumsum(a[0], axis=1),
        "compare": lambda L, a, kw: [f(a[0], a[1]) for f in (
            L.equal, L.not_equal, L.less_than, L.less_equal, L.greater_than,
            L.greater_equal)],
        "logical": lambda L, a, kw: [L.logical_and(a[0] > 0, a[1] > 0),
                                     L.logical_or(a[0] > 0, a[1] > 0),
                                     L.logical_xor(a[0] > 0, a[1] > 0),
                                     L.logical_not(a[0] > 0)],
        "reverse": lambda L, a, kw: L.reverse(a[2], [0, 2]),
        "reverse_one_axis": lambda L, a, kw: L.reverse(a[0], 1),
        "flatten_1": lambda L, a, kw: L.flatten(a[2], 1),
        "flatten_2": lambda L, a, kw: L.flatten(a[2], 2),
        "flatten_0": lambda L, a, kw: L.flatten(a[2], 0),
        "create_tensor": lambda L, a, kw: L.create_tensor("float32", **kw),
        "sums": lambda L, a, kw: L.sums([a[0], a[1], a[0]]),
        "sum_list": lambda L, a, kw: L.sum([a[0], a[1]]),
        "sum_one": lambda L, a, kw: L.sum(a[0]),
    }


def _op_inputs():
    rng = np.random.RandomState(4)
    return [rng.randn(4, 6).astype(np.float32),
            rng.randn(4, 6).astype(np.float32),
            rng.randn(3, 5, 10).astype(np.float32),
            rng.randn(1, 6).astype(np.float32),
            np.array([[2, 0], [3, 3]], np.int32),
            np.array([5, 1, 1], np.int32),
            np.array([[0, 1], [2, 4], [1, 0]], np.int32),
            np.array([3, 1], np.int32)]


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


@pytest.mark.parametrize("name", sorted(_ops()))
def test_tensor_op_matches_jax(name):
    fn = _ops()[name]
    arrays = _op_inputs()
    want = _leaves(fn(jL, [jnp.asarray(a) for a in arrays], {}))
    got = _leaves(fn(tL, [_t(a) for a in arrays], {"device": "cpu"}))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        assert g.dtype.kind == w.dtype.kind, (g.dtype, w.dtype)  # int64 vs int32 by x64
        _close(g, w, TOL, name)


def test_random_ops_draw_the_stated_distributions():
    """Random ops draw from the program's rng stream (or a fixed seed);
    their numbers differ from JAX's, their distributions must not."""

    def fn(x):
        return {"u": tL.uniform_random([20000], min=-2.0, max=3.0),
                "g": tL.gaussian_random([20000], mean=1.0, std=2.0),
                "s": tL.uniform_random([8], seed=5),
                "b": tL.uniform_random_batch_size_like(x, [1, 4], output_dim_idx=0)}

    out, _ = tpt.build(fn).apply({}, {}, torch.zeros(3, 2), rng=0)
    u, g = out["u"], out["g"]
    assert -2.0 <= u.min().item() and u.max().item() < 3.0
    assert abs(u.mean().item() - 0.5) < 5 * (5 / 12 ** 0.5) / 20000 ** 0.5
    assert abs(g.mean().item() - 1.0) < 5 * 2 / 20000 ** 0.5
    assert abs(g.std().item() / 2.0 - 1) < 0.03
    again, _ = tpt.build(fn).apply({}, {}, torch.zeros(3, 2), rng=1)
    assert torch.equal(out["s"], again["s"]) and not torch.equal(out["u"], again["u"])
    assert out["b"].shape == (3, 4)


# ---------------------------------------------------------------------------
# losses, mean, accuracy


def _logits_labels(n=8, c=10, seed=5, label_shape="n1"):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, c) * 2).astype(np.float32)
    labels = rng.randint(0, c, (n, 1) if label_shape == "n1" else (n,)).astype(np.int64)
    return logits, labels


LOSS_CASES = {
    "swce_labels_n1": lambda L, lg, lb, sl: L.softmax_with_cross_entropy(lg, lb),
    "swce_labels_n": lambda L, lg, lb, sl: L.softmax_with_cross_entropy(lg, lb[:, 0]),
    "swce_ignore_index": lambda L, lg, lb, sl: L.softmax_with_cross_entropy(
        lg, lb, ignore_index=3),
    "swce_ignore_default": lambda L, lg, lb, sl: L.softmax_with_cross_entropy(
        lg, L.cond_select(lb > 6, lb * 0 - 100, lb)),
    "swce_soft_label": lambda L, lg, lb, sl: L.softmax_with_cross_entropy(
        lg, sl, soft_label=True),
    "swce_return_softmax": lambda L, lg, lb, sl: L.softmax_with_cross_entropy(
        lg, lb, return_softmax=True),
    "cross_entropy": lambda L, lg, lb, sl: L.cross_entropy(L.softmax(lg), lb),
    "cross_entropy_labels_n": lambda L, lg, lb, sl: L.cross_entropy(L.softmax(lg), lb[:, 0]),
    "cross_entropy_soft": lambda L, lg, lb, sl: L.cross_entropy(L.softmax(lg), sl,
                                                                soft_label=True),
    "cross_entropy_ignore_index": lambda L, lg, lb, sl: L.cross_entropy(
        L.softmax(lg), lb, ignore_index=3),
    "softmax": lambda L, lg, lb, sl: L.softmax(lg),
    "softmax_axis0": lambda L, lg, lb, sl: L.softmax(lg, axis=0),
    "log_softmax": lambda L, lg, lb, sl: L.log_softmax(lg),
    "mean_of_swce": lambda L, lg, lb, sl: L.mean(L.softmax_with_cross_entropy(lg, lb)),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_and_its_grad_match_jax(name):
    logits, labels = _logits_labels()
    labels[:3, 0] = 3  # rows the ignore_index cases drop
    soft = np.random.RandomState(6).dirichlet(np.ones(10), 8).astype(np.float32)
    fn = LOSS_CASES[name]
    rng = np.random.RandomState(7)

    def jfirst(lg):
        return _leaves(fn(jL, lg, jnp.asarray(labels), jnp.asarray(soft)))

    want = jfirst(jnp.asarray(logits))
    cots = [np.asarray(rng.randn(*np.shape(w)), np.float32) for w in want]
    jg = jax.grad(lambda lg: sum(jnp.sum(o * c) for o, c in zip(jfirst(lg), cots)))(
        jnp.asarray(logits))
    tlogits = _t(logits).requires_grad_()
    got = _leaves(fn(tL, tlogits, _t(labels), _t(soft)))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w)), (g.shape, np.shape(w))
        _close(g, w, TRANS_TOL, name)
    sum((o * _t(c)).sum() for o, c in zip(got, cots)).backward()
    _close(tlogits.grad, jg, GRAD_TOL, f"{name} grad")


def test_softmax_with_cross_entropy_takes_int64_and_int32_labels():
    logits, labels = _logits_labels()
    a = tL.softmax_with_cross_entropy(_t(logits), _t(labels))
    b = tL.softmax_with_cross_entropy(_t(logits), _t(labels.astype(np.int32)))
    assert torch.equal(a, b) and a.shape == (8, 1) and a.dtype == torch.float32


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("label_shape", ["n1", "n"])
def test_accuracy_matches_jax_on_tie_free_logits(k, label_shape):
    logits, labels = _logits_labels(n=64, label_shape=label_shape)
    assert len(np.unique(logits)) == logits.size  # no ties
    want = jmetrics.accuracy(jnp.asarray(logits), jnp.asarray(labels), k=k)
    got = tmetrics.accuracy(_t(logits), _t(labels), k=k)
    assert got.dtype == torch.float32
    _close(got, want, TOL)
    assert tL.accuracy is tmetrics.accuracy
