"""DeepFM and the book recommender, the port against ``paddle_tpu`` on the
CPU, with the pieces they need: ``embedding(is_sparse=, is_distributed=)``,
``sigmoid_cross_entropy_with_logits``, ``cos_sim``, ``square_error_cost``,
``datasets.ctr``/``movielens`` and ``flops.deepfm_train_flops``.

DeepFM at 4 fields × 50 rows, embedding 8, hidden (32, 32), f32, from the
JAX package's init carried across by ``params_from_jax``: the same
parameter names, shapes and ``ParamInfo``; the loss and every grad of one
batch (rtol 1e-6 on the loss; each grad within 1e-5 of its largest
element, a bias's of the L1 norm of dloss/dlogit, whose terms its grad
sums and which cancel: f32 sums of 4-64 terms in another order); three
Adagrad(0.05) steps (losses rtol 1e-5; params within 1e-5, as
test_torch_mnist.py holds Adam: Adagrad's first step moves a weight by
lr·g/(|g| + eps), so a weight whose grad is within a few eps of 0 moves by
an amount that the f32 rounding of g sets). The recommender at
tests/test_srl_recommender.py's widths, two Adam(1e-2) steps, to the same
tolerances. The losses and ``cos_sim`` are held value and grad to rtol
1e-6 (elementwise f32). Every batch repeats ids; the captured step's body
(``run_steps``, run K times on the CPU) gives ``step()``'s bits."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as jpt
from paddle_tpu import layers as jL
from paddle_tpu import optimizer as jopt
from paddle_tpu.core import flops as jflops
from paddle_tpu.data import datasets as jds
from paddle_tpu.models import deepfm as jdeepfm
from paddle_tpu.models import recommender as jrec

import paddle_tpu_torch as tpt
from paddle_tpu_torch import data as tdata
from paddle_tpu_torch import layers as tL
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core import flops as tflops
from paddle_tpu_torch.data import datasets as tds
from paddle_tpu_torch.framework import params_from_jax
from paddle_tpu_torch.models import deepfm as tdeepfm
from paddle_tpu_torch.models import recommender as trec

CPU = tpt.CPUPlace()
SMALL = dict(num_sparse_fields=4, sparse_feature_dim=50, embedding_size=8, num_dense=13,
             hidden_dims=(32, 32))
LOSS_RTOL, GRAD_TOL, STEP_LOSS_RTOL, PARAM_ATOL = 1e-6, 1e-5, 1e-5, 1e-5
REC_SMALL = dict(num_users=100, num_movies=80, title_vocab=50, emb_dim=16, fc_dim=32)
REC_NAMES = ["user_id", "gender_id", "age_id", "job_id", "movie_id", "category_ids",
             "title_ids", "score"]


def _deepfm_feeds(n=3, b=64, fields=4, dim=50, dense=13, seed=0):
    """bench.py _bench_deepfm_config's feeds at a small size."""
    rng = np.random.RandomState(seed)
    return [{"dense": rng.randn(b, dense).astype(np.float32),
             "sparse_ids": rng.randint(0, dim, (b, fields)).astype(np.int32),
             "label": rng.randint(0, 2, (b, 1)).astype(np.int64)} for _ in range(n)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def jax_deepfm():
    feed = _deepfm_feeds()[0]
    prog = jpt.build(jdeepfm.make_model(**SMALL))
    params, state = prog.init(jax.random.PRNGKey(0), **feed)
    return prog, {k: np.asarray(v) for k, v in params.items()}


def test_names_shapes_and_param_info_match_jax(jax_deepfm):
    jprog, jparams = jax_deepfm
    prog = tpt.build(tdeepfm.make_model(**SMALL))
    params, state = prog.init(0, place=CPU, **_deepfm_feeds()[0])
    assert sorted(params) == sorted(jparams) and state == {}
    for k, v in jparams.items():
        assert tuple(params[k].shape) == v.shape and params[k].dtype == torch.float32, k
        assert prog.param_info[k].is_distributed == jprog.param_info[k].is_distributed, k
    assert prog.param_info["deepfm_0/fm_v/w"].is_distributed
    assert prog.param_info["deepfm_0/fm_w1/w"].is_distributed
    assert not prog.param_info["fc_0/w"].is_distributed
    # the tables' Normal(0, 0.01) init
    assert abs(float(params["deepfm_0/fm_v/w"].std()) - 0.01) < 1e-3


def test_loss_and_every_grad_match_jax(jax_deepfm):
    jprog, jparams = jax_deepfm
    feed = _deepfm_feeds()[1]
    (_, jout), jgrads = jax.value_and_grad(
        lambda p: (lambda o: (o["loss"], o))(jprog.apply(p, {}, **feed, training=True)[0]),
        has_aux=True)({k: jnp.asarray(v) for k, v in jparams.items()})
    prog = tpt.build(tdeepfm.make_model(**SMALL))
    prog.init(0, place=CPU, **feed)
    tp = params_from_jax(jparams, device="cpu")
    for v in tp.values():
        v.requires_grad_(True)
    out, _ = prog.apply(tp, {}, **feed, training=True, place=CPU)
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(jout["loss"]),
                               rtol=LOSS_RTOL)
    for k in ("prob", "logit"):
        np.testing.assert_allclose(_np(out[k]), _np(jout[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    # the output biases' grads are sums of the per-row dloss/dlogit, which
    # cancel: their scale is those terms' L1 norm
    dlogit_l1 = float(np.abs(_np(jout["prob"]) - feed["label"]).sum()) / len(feed["label"])
    for k, g in jgrads.items():
        g = _np(g)
        scale = max(float(np.abs(g).max()), dlogit_l1 if k.endswith("/b") else 0.0)
        err = float(np.abs(_np(tp[k].grad) - g).max()) / scale
        assert err <= GRAD_TOL, (k, err)
    # only the rows the batch reads get a table grad
    flat = (feed["sparse_ids"] + np.arange(4) * 50).reshape(-1)
    unread = np.setdiff1d(np.arange(200), flat)
    assert unread.size and not tp["deepfm_0/fm_v/w"].grad[unread].any()


def test_three_adagrad_steps_match_jax(jax_deepfm):
    _, jparams = jax_deepfm
    feeds = _deepfm_feeds()
    jt = jpt.Trainer(jpt.build(jdeepfm.make_model(**SMALL)), jopt.Adagrad(0.05),
                     loss_name="loss")
    jt.startup(sample_feed=feeds[0])
    jt.scope.params = {k: jnp.asarray(v) for k, v in jparams.items()}
    tt = tpt.Trainer(tpt.build(tdeepfm.make_model(**SMALL)), topt.Adagrad(0.05),
                     loss_name="loss", place=CPU)
    tt.startup(sample_feed=feeds[0], params=params_from_jax(jparams, device="cpu"))
    for f in feeds:
        np.testing.assert_allclose(float(tt.step(f)["loss"]), float(jt.step(f)["loss"]),
                                   rtol=STEP_LOSS_RTOL)
    for k in jparams:
        np.testing.assert_allclose(_np(tt.scope.params[k]), _np(jt.scope.params[k]),
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)
        np.testing.assert_allclose(_np(tt.scope.opt_state["accums"][k]["moment"]),
                                   _np(jt.scope.opt_state["accums"][k]["moment"]),
                                   rtol=1e-5, atol=1e-9, err_msg=k)


def test_captured_body_gives_the_eager_steps_bits():
    """``run_steps`` (the captured step's static-slot body, K calls on the
    CPU) against K ``step()`` calls, on batches that repeat every id."""
    feeds = _deepfm_feeds(n=4, b=64, dim=5)  # 64 rows over 5 ids a field
    trs = [tpt.Trainer(tpt.build(tdeepfm.make_model(**dict(SMALL, sparse_feature_dim=5))),
                       topt.Adagrad(0.01), loss_name="loss", place=CPU).startup(3, feeds[0])
           for _ in range(2)]
    eager = torch.stack([trs[0].step(f)["loss"] for f in feeds])
    fused = trs[1].run_steps(tdata.stack_batches(feeds))["loss"]
    assert torch.equal(eager, fused)
    for k, p in trs[0].scope.params.items():
        assert torch.equal(p, trs[1].scope.params[k]), k
        assert torch.equal(trs[0].scope.opt_state["accums"][k]["moment"],
                           trs[1].scope.opt_state["accums"][k]["moment"]), k


def test_fit_over_ctr_learns():
    """``fit`` over the synthetic CTR reader (labels reshaped to [1]), the
    port alone: the mean loss of the last 8 steps below that of the first 8."""
    reader = tdata.batch(tdata.map_readers(
        lambda sample: (sample[0], sample[1], np.array([sample[2]])),
        tds.ctr(num_sparse_fields=4, sparse_dim=50, synthetic_size=2048)), 64)
    names = ["dense", "sparse_ids", "label"]
    sample = tdata.DataFeeder(names).feed(next(iter(reader())))
    tr = tpt.Trainer(tpt.build(tdeepfm.make_model(**SMALL)), topt.Adagrad(0.05),
                     loss_name="loss", place=CPU).startup(0, sample)
    losses = []
    tpt.fit(tr, reader, 2, names, prefetch=False, steps_per_dispatch=4,
            event_handler=lambda e: losses.extend(e.metrics["loss"].reshape(-1).tolist())
            if e.kind == "end_step" else None)
    assert len(losses) == 64 and np.all(np.isfinite(losses))
    assert np.mean(losses[-8:]) < np.mean(losses[:8]) - 0.05, (losses[:8], losses[-8:])


def test_deepfm_flops_match_jax():
    args = (2048, 26, 16, 13, (400, 400, 400))
    assert tflops.deepfm_train_flops(*args) == jflops.deepfm_train_flops(*args)
    assert tflops.mlp_train_flops(128, [784, 200, 200, 10]) == \
        jflops.mlp_train_flops(128, [784, 200, 200, 10])


# -- embedding flags ------------------------------------------------------------


@pytest.mark.parametrize("flags", [dict(is_sparse=True), dict(is_distributed=True),
                                   dict(is_sparse=True, is_distributed=True)])
def test_embedding_flags_match_jax(flags):
    """The flags are markers: ``is_distributed`` lands in ``ParamInfo``; the
    lookup, its NaN rows for ids past the table and its dense grad are the
    plain embedding's."""
    ids = np.array([[0, 5, -1, 3], [3, 3, 9, 7]], np.int32)

    def make(L):
        return lambda ids: {"e": L.embedding(ids, size=[8, 4], **flags)}

    jprog = jpt.build(make(jL))
    jparams, _ = jprog.init(jax.random.PRNGKey(1), ids=ids)
    ct = np.random.RandomState(2).randn(2, 4, 4).astype(np.float32)
    jout = jprog.apply(jparams, {}, ids=ids)[0]["e"]
    jgrad = jax.grad(lambda p: jnp.nansum(jprog.apply(p, {}, ids=ids)[0]["e"] * ct))(jparams)
    prog = tpt.build(make(tL))
    prog.init(0, place=CPU, ids=ids)
    assert prog.param_info["embedding_0/w"].is_distributed == \
        jprog.param_info["embedding_0/w"].is_distributed == flags.get("is_distributed", False)
    tp = params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    tp["embedding_0/w"].requires_grad_(True)
    out = prog.apply(tp, {}, ids=ids, place=CPU)[0]["e"]
    np.testing.assert_array_equal(_np(out), _np(jout))
    assert np.isnan(_np(out)[1, 2]).all()  # id 9 is past the 8-row table
    torch.nansum(out * torch.from_numpy(ct)).backward()
    np.testing.assert_allclose(_np(tp["embedding_0/w"].grad), _np(jgrad["embedding_0/w"]),
                               rtol=1e-6, atol=1e-7)


# -- losses ------------------------------------------------------------------------


def _grad_pair(jfn, tfn, *arrays):
    """Values and grads (of the sum against a fixed cotangent) of the JAX
    and port functions on the same arrays."""
    jout = jfn(*[jnp.asarray(a) for a in arrays])
    ct = np.random.RandomState(4).randn(*jout.shape).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a) * ct), argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    tout = tfn(*ts)
    (tout * torch.from_numpy(ct)).sum().backward()
    return _np(jout), _np(tout), [_np(g) for g in jg], [_np(t.grad) for t in ts]


def test_sigmoid_cross_entropy_with_logits_matches_jax():
    rng = np.random.RandomState(5)
    x = (rng.randn(6, 3) * 4).astype(np.float32)
    x[0, 0], x[1, 1] = 0.0, 40.0  # the tie of max(x, 0), and a large logit
    label = rng.randint(0, 2, (6, 3)).astype(np.float32)
    label[2, :] = -100.0  # ignored
    jo, to, jg, tg = _grad_pair(
        lambda a: jL.sigmoid_cross_entropy_with_logits(a, jnp.asarray(label)),
        lambda a: tL.sigmoid_cross_entropy_with_logits(a, torch.from_numpy(label)), x)
    np.testing.assert_allclose(to, jo, rtol=1e-6, atol=1e-7)
    assert not to[2].any() and not tg[0][2].any()
    np.testing.assert_allclose(tg[0], jg[0], rtol=1e-6, atol=1e-7)
    # ignore_index moved
    lab = np.array([[1.0, 7.0]], np.float32)
    got = tL.sigmoid_cross_entropy_with_logits(torch.ones(1, 2), torch.from_numpy(lab),
                                               ignore_index=7)
    want = jL.sigmoid_cross_entropy_with_logits(jnp.ones((1, 2)), jnp.asarray(lab),
                                                ignore_index=7)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)


def test_cos_sim_matches_jax_with_a_zero_vector():
    rng = np.random.RandomState(6)
    x, y = rng.randn(5, 7).astype(np.float32), rng.randn(5, 7).astype(np.float32)
    x[1] = 0.0   # a zero vector: 0, where a clamp of each norm would differ
    y[3] = 1e-7  # a tiny vector
    jo, to, jg, tg = _grad_pair(jL.cos_sim, tL.cos_sim, x, y)
    assert to.shape == (5, 1) and to[1, 0] == 0.0
    np.testing.assert_allclose(to, jo, rtol=1e-6, atol=1e-7)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_square_error_cost_matches_jax():
    rng = np.random.RandomState(7)
    a, b = rng.randn(4, 1).astype(np.float32), rng.randn(4, 1).astype(np.float32)
    jo, to, jg, tg = _grad_pair(jL.square_error_cost, tL.square_error_cost, a, b)
    np.testing.assert_allclose(to, jo, rtol=1e-6)
    for g, w in zip(tg, jg):
        np.testing.assert_allclose(g, w, rtol=1e-6)


# -- the recommender ---------------------------------------------------------------


def _rec_batches(n=2, b=64):
    out, buf = [], []
    for sample in tds.movielens(num_users=100, num_movies=80, title_vocab=50,
                                synthetic_size=n * b)():
        buf.append(sample)
        if len(buf) == b:
            out.append({k: np.stack([s[i] for s in buf]) for i, k in enumerate(REC_NAMES)})
            buf = []
    return out


def test_recommender_two_adam_steps_match_jax():
    batches = _rec_batches()
    jt = jpt.Trainer(jpt.build(jrec.make_model(**REC_SMALL)), jopt.Adam(1e-2),
                     loss_name="loss", fetch_list=["loss", "pred"])
    jt.startup(sample_feed=batches[0])
    p0 = {k: np.asarray(v) for k, v in jt.scope.params.items()}
    prog = tpt.build(trec.make_model(**REC_SMALL))
    tt = tpt.Trainer(prog, topt.Adam(1e-2), loss_name="loss", fetch_list=["loss", "pred"],
                     place=CPU)
    tt.startup(sample_feed=batches[0], params=params_from_jax(p0, device="cpu"))
    assert sorted(tt.scope.params) == sorted(p0)
    for k, v in p0.items():
        assert tuple(tt.scope.params[k].shape) == v.shape, k
    for b in batches:
        jo, to = jt.step(b), tt.step(b)
        np.testing.assert_allclose(float(to["loss"]), float(jo["loss"]), rtol=STEP_LOSS_RTOL)
        np.testing.assert_allclose(_np(to["pred"]), _np(jo["pred"]), rtol=1e-5, atol=1e-5)
    for k in p0:
        np.testing.assert_allclose(_np(tt.scope.params[k]), _np(jt.scope.params[k]),
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)


def test_recommender_learns_on_movielens():
    """tests/test_srl_recommender.py's recommender check, the port alone."""
    batches = _rec_batches(n=16)
    tr = tpt.Trainer(tpt.build(trec.make_model(**REC_SMALL)), topt.Adam(1e-2),
                     loss_name="loss", fetch_list=["loss", "pred"], place=CPU)
    tr.startup(0, batches[0])
    first = float(tr.step(batches[0])["loss"])
    for _ in range(6):
        for b in batches:
            out = tr.step(b)
    assert float(out["loss"]) < first * 0.7, (first, float(out["loss"]))
    assert torch.isfinite(out["pred"]).all()


# -- datasets ------------------------------------------------------------------------


@pytest.mark.parametrize("split", ["train", "test"])
def test_ctr_and_movielens_yield_the_reference_arrays(split):
    readers = [(jds.ctr(split, num_sparse_fields=5, sparse_dim=30, synthetic_size=40),
                tds.ctr(split, num_sparse_fields=5, sparse_dim=30, synthetic_size=40)),
               (jds.movielens(split, synthetic_size=40), tds.movielens(split, synthetic_size=40))]
    for jr, tr in readers:
        assert tr.synthetic is True
        want, got = list(jr()), list(tr())
        assert len(got) == len(want) == 40
        for w, g in zip(want, got):
            assert len(w) == len(g)
            for a, b in zip(w, g):
                assert np.asarray(a).dtype == np.asarray(b).dtype
                np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
