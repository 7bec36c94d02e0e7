"""The port's sequence ops, ``LoDTensor`` and ``beam_search_decode_lod``
against ``paddle_tpu.layers.sequence`` and ``beam_search`` on the CPU, on
the same numpy inputs: the converters, every ``sequence_*`` op (ragged
lengths, ids past ``num_seqs`` dropped, the padded layout's interleaved
tail ids, an empty segment), ``lod_reset``, ``reorder_lod_tensor_by_rank``,
``LoDTensor``'s levels and views, the two LoD constructors, and the
2-level LoD of decoded beams.

Tolerances: integer outputs, segment ids, gathers, max/min/first/last and
every LoD are equal exactly; f32 sums, means and the softmax within 1e-6
(rtol and atol: another summation order); ``sequence_conv`` within 1e-5;
grads of the differentiable ops (one weighted sum of the output, by
``torch.autograd`` against ``jax.grad``) within 1e-6 of the largest."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as jpt
from paddle_tpu.layers import beam_search as jBS
from paddle_tpu.layers import sequence as jS

import paddle_tpu_torch as tpt
from paddle_tpu_torch.core.place import NoCudaDevice
from paddle_tpu_torch.framework import params_from_jax
from paddle_tpu_torch.layers import beam_search as tBS
from paddle_tpu_torch.layers import sequence as tS

CPU = tpt.CPUPlace()
TOL, CONV_TOL, GRAD_TOL = 1e-6, 1e-5, 1e-6
LENGTHS = [2, 3, 0, 4]  # with an empty sequence


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _leaves(tree):
    return list(tree) if isinstance(tree, (list, tuple)) else [tree]


def _same(got, want, tol=0.0):
    for g, w in zip(_leaves(got), _leaves(want), strict=True):
        g, w = _np(g), np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        if tol == 0.0 or not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def _packed(lengths=LENGTHS, dim=3, seed=0, pad_rows=0):
    """values [sum + pad_rows, dim] f32 and int32 ids, pad rows given id
    num_seqs."""
    rng = np.random.RandomState(seed)
    total = sum(lengths) + pad_rows
    seg = np.concatenate([[i] * n for i, n in enumerate(lengths)]
                         + [[len(lengths)] * pad_rows]).astype(np.int32)
    return rng.randn(total, dim).astype(np.float32), seg


def _grads_match(jfn, tfn, x, *rest):
    """d/dx of one weighted sum of fn(x, *rest), torch against JAX."""
    jout = _leaves(jfn(jnp.asarray(x), *rest))[0]
    cot = np.random.RandomState(9).randn(*jout.shape).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(_leaves(jfn(v, *rest))[0] * cot))(jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    trest = [_t(r) if isinstance(r, np.ndarray) else r for r in rest]
    (_leaves(tfn(tx, *trest))[0] * _t(cot)).sum().backward()
    scale = max(float(np.abs(np.asarray(want)).max()), 1e-12)
    assert float(np.abs(_np(tx.grad) - np.asarray(want)).max()) / scale <= GRAD_TOL


# ---------------------------------------------------------------------------
# converters


def test_converters_match_jax():
    lens = np.array(LENGTHS, np.int32)
    _same(tS.lengths_to_offsets(_t(lens)), jS.lengths_to_offsets(jnp.asarray(lens)))
    offs = np.array([0, 2, 5, 5, 9], np.int32)
    _same(tS.offsets_to_lengths(_t(offs)), jS.offsets_to_lengths(jnp.asarray(offs)))
    for total in (9, 12):
        _same(tS.lengths_to_segment_ids(_t(lens), total),
              jS.lengths_to_segment_ids(jnp.asarray(lens), total))
    _, seg = _packed(pad_rows=2)
    _same(tS.segment_ids_to_lengths(_t(seg), 4),
          jS.segment_ids_to_lengths(jnp.asarray(seg), 4))


def test_pad_and_unpad_match_jax():
    x, _ = _packed()
    lens = np.array(LENGTHS, np.int32)
    for pad_value in (0.0, -1.5):
        _same(tS.sequence_pad(_t(x), _t(lens), 5, pad_value),
              jS.sequence_pad(jnp.asarray(x), jnp.asarray(lens), 5, pad_value))
    padded = np.asarray(jS.sequence_pad(jnp.asarray(x), jnp.asarray(lens), 5)[0])
    _same(tS.sequence_unpad(_t(padded), _t(lens)),
          jS.sequence_unpad(jnp.asarray(padded), jnp.asarray(lens)))
    _grads_match(lambda v, l: jS.sequence_pad(v, l, 5), lambda v, l: tS.sequence_pad(v, l, 5),
                 x, lens)


# ---------------------------------------------------------------------------
# the sequence_pool family


POOLS = ["sum", "average", "sqrt", "max", "min", "first", "last"]


def _unpadded_layout():
    """The padded layout's packed form: row-major, tail ids b interleaved."""
    lens = np.array(LENGTHS, np.int32)
    padded = np.random.RandomState(3).randn(4, 5, 3).astype(np.float32)
    flat, seg = jS.sequence_unpad(jnp.asarray(padded), jnp.asarray(lens))
    return np.asarray(flat), np.asarray(seg)


@pytest.mark.parametrize("layout", ["packed", "dropped_tail", "unpadded"])
@pytest.mark.parametrize("pool_type", POOLS)
def test_sequence_pool_matches_jax(pool_type, layout):
    if layout == "unpadded":
        x, seg = _unpadded_layout()
    else:
        x, seg = _packed(pad_rows=3 if layout == "dropped_tail" else 0)
    want = jS.sequence_pool(jnp.asarray(x), jnp.asarray(seg), 4, pool_type)
    got = tS.sequence_pool(_t(x), _t(seg), 4, pool_type)
    _same(got, want, TOL if pool_type in ("sum", "average", "sqrt") else 0.0)
    _grads_match(lambda v, s: jS.sequence_pool(v, s, 4, pool_type),
                 lambda v, s: tS.sequence_pool(v, s, 4, pool_type), x, seg)


def test_first_and_last_step_match_jax():
    x, seg = _packed(pad_rows=1)
    for name in ("sequence_first_step", "sequence_last_step"):
        _same(getattr(tS, name)(_t(x), _t(seg), 4),
              getattr(jS, name)(jnp.asarray(x), jnp.asarray(seg), 4))


@pytest.mark.parametrize("layout", ["packed", "dropped_tail", "unpadded"])
def test_sequence_softmax_matches_jax(layout):
    if layout == "unpadded":
        x, seg = _unpadded_layout()
        x = x[:, 0]
    else:
        x, seg = _packed(dim=1, pad_rows=2 if layout == "dropped_tail" else 0)
        x = x[:, 0]
    _same(tS.sequence_softmax(_t(x), _t(seg), 4),
          jS.sequence_softmax(jnp.asarray(x), jnp.asarray(seg), 4), TOL)
    if layout == "packed":
        _grads_match(lambda v, s: jS.sequence_softmax(v, s, 4),
                     lambda v, s: tS.sequence_softmax(v, s, 4), x, seg)
    else:
        # rows whose id is past num_seqs read the last segment's max and sum
        # through a clamped gather; its grad is checked by finite differences
        # (the reference's drops it: test_the_reference_softmax_grad_drops_...)
        assert torch.autograd.gradcheck(
            lambda v: tS.sequence_softmax(v, _t(seg), 4),
            (_t(x).double().requires_grad_(True),))


def test_the_reference_softmax_grad_drops_the_clamped_rows():
    """paddle_tpu's sequence_softmax gathers m[segment_ids] and
    denom[segment_ids] with ids past num_seqs, which the forward clamps to
    the last segment and the backward drops: the grad it gives the last
    segment's rows lacks the dropped rows' share, and differs from finite
    differences. The port's gather clamps both ways (``take_rows``); the
    reference is left as it is."""
    x = np.array([1.0, 2.0, 0.5, 3.0, -1.0], np.float32)
    seg = np.array([0, 0, 1, 1, 2], np.int32)  # the last row is past num_seqs = 2
    cot = np.array([1.0, -2.0, 0.5, 1.5, 3.0], np.float32)
    f = lambda v: jnp.sum(jS.sequence_softmax(v, jnp.asarray(seg), 2) * cot)  # noqa: E731
    jgrad = np.asarray(jax.grad(f)(jnp.asarray(x)))
    tx = _t(x).double().requires_grad_(True)
    (tS.sequence_softmax(tx, _t(seg), 2) * _t(cot).double()).sum().backward()
    eps, fd = 1e-3, []
    for i in range(5):
        up, down = x.astype(np.float64).copy(), x.astype(np.float64).copy()
        up[i], down[i] = up[i] + eps, down[i] - eps
        fd.append(float(f(jnp.asarray(up, jnp.float32)) - f(jnp.asarray(down, jnp.float32)))
                  / (2 * eps))
    np.testing.assert_allclose(_np(tx.grad), fd, atol=1e-3)
    np.testing.assert_allclose(jgrad[:2], fd[:2], atol=1e-3)  # segment 0 agrees
    assert abs(jgrad[3] - fd[3]) > 1e-2  # segment 1 lacks the dropped row's share


def test_segment_reductions_repeat_their_bits():
    """Two runs of each reduction give the same bits (the card's sorted
    sums; here the CPU's)."""
    x, seg = _unpadded_layout()
    for pool_type in POOLS:
        a = tS.sequence_pool(_t(x), _t(seg), 4, pool_type)
        b = tS.sequence_pool(_t(x), _t(seg), 4, pool_type)
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the other sequence ops


def test_expand_and_expand_as_match_jax():
    x = np.arange(8, dtype=np.float32).reshape(4, 2)
    lens = np.array([1, 3, 0, 2], np.int32)
    for total in (6, 8):
        _same(tS.sequence_expand(_t(x), _t(lens), total),
              jS.sequence_expand(jnp.asarray(x), jnp.asarray(lens), total))
    _same(tS.sequence_expand_as(_t(x), _t(lens), 6),
          jS.sequence_expand_as(jnp.asarray(x), jnp.asarray(lens), 6))
    _grads_match(lambda v, l: jS.sequence_expand(v, l, 6),
                 lambda v, l: tS.sequence_expand(v, l, 6), x, lens)


def test_expand_by_lod_level_matches_jax():
    lod = [[2, 1], [3, 2, 4]]
    zeros = np.zeros((9, 1), np.float32)
    jref, tref = jS.create_lod_tensor(zeros, lod), tS.create_lod_tensor(zeros, lod, CPU)
    x2, x3 = np.array([[10.0], [20.0]], np.float32), np.array([[1.0], [2.0], [3.0]],
                                                               np.float32)
    _same(tS.sequence_expand(_t(x2), tref, ref_level=0),
          jS.sequence_expand(jnp.asarray(x2), jref, ref_level=0))
    _same(tS.sequence_expand(_t(x3), tref, ref_level=1),
          jS.sequence_expand(jnp.asarray(x3), jref, ref_level=1))
    with pytest.raises(Exception, match="out of range"):
        tS.sequence_expand(_t(x2), tref, ref_level=2)


def test_reverse_concat_and_enumerate_match_jax():
    x, seg = _packed(pad_rows=2)
    _same(tS.sequence_reverse(_t(x), _t(seg), 4),
          jS.sequence_reverse(jnp.asarray(x), jnp.asarray(seg), 4))
    _grads_match(lambda v, s: jS.sequence_reverse(v, s, 4),
                 lambda v, s: tS.sequence_reverse(v, s, 4), x, seg)
    y, seg_y = _packed([1, 2, 2, 1], seed=1)
    _same(tS.sequence_concat([_t(x), _t(y)], [_t(seg), _t(seg_y)], 4),
          jS.sequence_concat([jnp.asarray(x), jnp.asarray(y)],
                             [jnp.asarray(seg), jnp.asarray(seg_y)], 4))
    ids = np.random.RandomState(2).randint(1, 9, (3, 5)).astype(np.int32)
    for win, pad in ((2, 0), (3, -1)):
        _same(tS.sequence_enumerate(_t(ids), win, pad),
              jS.sequence_enumerate(jnp.asarray(ids), win, pad))


def test_mask_erase_and_reshape_match_jax():
    lens = np.array(LENGTHS, np.int32)
    for dtype in (np.float32, np.int32, np.bool_):
        _same(tS.sequence_mask(_t(lens), 6, dtype), jS.sequence_mask(jnp.asarray(lens), 6,
                                                                      dtype))
    tokens = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5], np.int32)
    seg = np.array([0, 0, 1, 1, 1, 3, 3, 3, 3], np.int32)
    _same(tS.sequence_erase(_t(tokens), _t(seg), [1, 5], 4),
          jS.sequence_erase(jnp.asarray(tokens), jnp.asarray(seg), [1, 5], 4))
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    _same(tS.sequence_reshape(_t(x), _t(np.array([2, 4], np.int32)), 8),
          jS.sequence_reshape(jnp.asarray(x), jnp.asarray(np.array([2, 4], np.int32)), 8))
    with pytest.raises(Exception, match="divisible"):
        tS.sequence_reshape(_t(x), _t(np.array([6], np.int32)), 5)


def test_slice_and_scatter_match_jax():
    x, seg = _packed([3, 4, 2, 5])
    offset = np.array([1, 0, 1, 2], np.int32)
    length = np.array([2, 3, 1, 2], np.int32)
    for total_out in (8, 10):
        _same(tS.sequence_slice(_t(x), _t(seg), 4, _t(offset), _t(length), total_out),
              jS.sequence_slice(jnp.asarray(x), jnp.asarray(seg), 4, jnp.asarray(offset),
                                jnp.asarray(length), total_out))
    base = np.random.RandomState(4).randn(3, 6).astype(np.float32)
    ids = np.array([1, 1, 4, 0, 5, 2, 2], np.int32)  # repeated targets add up
    ids_seg = np.array([0, 0, 0, 1, 2, 2, 2], np.int32)
    upd = np.random.RandomState(5).randn(7).astype(np.float32)
    _same(tS.sequence_scatter(_t(base), _t(ids), _t(ids_seg), _t(upd)),
          jS.sequence_scatter(jnp.asarray(base), jnp.asarray(ids), jnp.asarray(ids_seg),
                              jnp.asarray(upd)), TOL)


@pytest.mark.parametrize("kw", [dict(filter_size=3), dict(filter_size=2, act="tanh"),
                                dict(filter_size=3, bias_attr=False)])
def test_sequence_conv_matches_jax(kw):
    x, seg = _packed(dim=4, pad_rows=2)

    def make(S):
        return lambda v, s: S.sequence_conv(v, s, 5, **kw)

    jprog = jpt.build(make(jS))
    jparams, _ = jprog.init(jax.random.PRNGKey(0), x, seg)
    jparams = {k: np.asarray(v) for k, v in jparams.items()}
    jout, _ = jprog.apply(jparams, {}, x, seg)
    prog = tpt.build(make(tS))
    prog.init(0, _t(x), _t(seg), place=CPU)
    params = params_from_jax(jparams, prog.param_info, device="cpu")
    out, _ = prog.apply(params, {}, _t(x), _t(seg), place=CPU)
    _same(out, jout, CONV_TOL)


def test_lod_reset_and_reorder_by_rank_match_jax():
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    _same(tS.lod_reset(_t(x), [2, 3]), jS.lod_reset(jnp.asarray(x), [2, 3]))
    _same(tS.lod_reset(_t(x), _t(np.array([1, 2], np.int32)), capacity=4),
          jS.lod_reset(jnp.asarray(x), jnp.asarray(np.array([1, 2], np.int32)), capacity=4))
    padded = np.random.RandomState(1).randn(5, 3, 2).astype(np.float32)
    lens = np.array([2, 3, 1, 3, 2], np.int32)  # ties keep their order
    got = tS.reorder_lod_tensor_by_rank(_t(padded), _t(lens))
    _same(got, jS.reorder_lod_tensor_by_rank(jnp.asarray(padded), jnp.asarray(lens)))
    np.testing.assert_array_equal(_np(got[0][torch.argsort(got[2])]), padded)


# ---------------------------------------------------------------------------
# LoDTensor


def test_lod_tensor_levels_match_jax():
    lod = [[2, 1], [3, 2, 4]]
    data = np.arange(18, dtype=np.float32).reshape(9, 2)
    j, t = jS.create_lod_tensor(data, lod), tS.create_lod_tensor(data, lod, CPU)
    assert t.lod_level == j.lod_level == 2
    assert t.recursive_sequence_lengths() == j.recursive_sequence_lengths()
    assert t.lod() == j.lod() == [[0, 2, 3], [0, 3, 5, 9]]
    for level in (0, 1, -1, -2):
        assert t.row_lengths(level) == j.row_lengths(level)
        assert t.num_seqs(level) == j.num_seqs(level)
        _same(t.segment_ids(level), j.segment_ids(level))
    for pool_type in ("sum", "average", "max", "last"):
        for level in (0, 1):
            got, want = t.pool(pool_type, level), j.pool(pool_type, level)
            assert isinstance(got, tS.LoDTensor) == isinstance(want, jS.LoDTensor)
            if isinstance(want, jS.LoDTensor):
                assert got.recursive_sequence_lengths() == want.recursive_sequence_lengths()
                got, want = got.values, want.values
            _same(got, want, TOL)
    for level in (0, 1):
        for g, w in zip(t.sequences(level), j.sequences(level)):
            for gg, ww in zip(_leaves(g), _leaves(w)):
                np.testing.assert_array_equal(gg, ww)
    _same(tuple(t), tuple(j))
    assert repr(t) == repr(j)
    deep = [[2], [1, 1], [4, 6]]
    assert tS.LoDTensor(np.zeros((10, 1), np.float32), deep, CPU).row_lengths(1) == \
        jS.LoDTensor(np.zeros((10, 1), np.float32), deep).row_lengths(1) == [4, 6]


def test_lod_tensor_checks_and_places():
    data = np.zeros((9, 1), np.float32)
    with pytest.raises(Exception, match="level 0"):
        tS.LoDTensor(data, [[2, 2], [3, 2, 4]], CPU)
    with pytest.raises(Exception, match="innermost"):
        tS.LoDTensor(data, [[2, 1], [3, 2, 3]], CPU)
    with pytest.raises(Exception, match="out of range"):
        tS.LoDTensor(data, [[9]], CPU).num_seqs(1)
    # a tensor stays where it lies; host values go to the card unless the
    # CPU is asked for
    assert tS.LoDTensor(torch.zeros(4, 1), [4]).values.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDevice):
            tS.create_lod_tensor(data, [[9]])


def test_create_random_int_lodtensor_matches_jax():
    np.random.seed(5)
    j = jS.create_random_int_lodtensor([[2, 3]], [2], low=1, high=7)
    np.random.seed(5)
    t = tS.create_random_int_lodtensor([[2, 3]], [2], CPU, low=1, high=7)
    _same(t.values, j.values)
    assert t.recursive_sequence_lengths() == j.recursive_sequence_lengths() == [[2, 3]]


# ---------------------------------------------------------------------------
# beam_search_decode_lod


def _decoded(seed=1, t_steps=5, b=3, k=2, eos=2):
    rng = np.random.RandomState(seed)
    step_ids = rng.randint(2, 6, (t_steps, b, k)).astype(np.int32)
    step_parents = rng.randint(0, k, (t_steps, b, k)).astype(np.int32)
    scores = rng.randn(b, k).astype(np.float32)
    return step_ids, step_parents, scores


def test_beam_search_decode_lod_matches_jax():
    step_ids, step_parents, scores = _decoded()
    jseqs, jvalid = jBS.beam_search_decode(step_ids, step_parents, end_id=2)
    tseqs, tvalid = tBS.beam_search_decode(_t(step_ids), _t(step_parents), end_id=2)
    _same((tseqs, tvalid), (jseqs, jvalid))
    jids, jsc = jBS.beam_search_decode_lod(jseqs, jvalid, scores)
    tids, tsc = tBS.beam_search_decode_lod(tseqs, tvalid, _t(scores))
    for got, want in ((tids, jids), (tsc, jsc)):
        assert got.recursive_sequence_lengths() == want.recursive_sequence_lengths()
        _same(got.values, want.values)
    assert tids.values.dtype == torch.int32 and tids.values.device == tseqs.device
    assert tids.recursive_sequence_lengths()[0] == [2, 2, 2]
    alone = tBS.beam_search_decode_lod(tseqs, tvalid)
    assert alone.recursive_sequence_lengths() == jids.recursive_sequence_lengths()
