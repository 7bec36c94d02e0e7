"""The recurrent family's models and datasets, the port against
``paddle_tpu`` on the CPU: the stacked LSTM (ragged and full lengths),
the GRU seq2seq (training, and beam and greedy decoding from trained
params, then ``beam_search_decode_lod``), SRL (stacked alternating LSTMs
and the CRF), word2vec (one shared table) and fit_a_line, each from the
JAX package's init carried across by ``params_from_jax`` and trained a
few Adam(1e-3) steps by each package's ``Trainer``; and the datasets
(uci_housing, imdb, wmt16, wmt14, conll05, imikolov, sentiment) sample
for sample.

Tolerances, f32 at narrow widths: each step's loss within rtol 1e-5 and
every param after the steps within 1e-5 (Adam's first step moves a weight
by about lr, whatever its grad's size, so f32 rounding of a grad shows as
a move of at most lr times its relative error); the decoded ids (beam,
greedy, CRF) equal exactly and the beam scores within 1e-5; the datasets'
arrays equal exactly. The captured step's body (``run_steps``, run K
times on the CPU) gives ``step()``'s bits."""

import numpy as np
import pytest

import jax
import torch

import paddle_tpu as jpt
from paddle_tpu import optimizer as jopt
from paddle_tpu.data import datasets as jds
from paddle_tpu.layers import beam_search as jBS
from paddle_tpu.models import fit_a_line as jfit
from paddle_tpu.models import lstm as jlstm
from paddle_tpu.models import seq2seq as jseq
from paddle_tpu.models import srl as jsrl
from paddle_tpu.models import word2vec as jw2v

import paddle_tpu_torch as tpt
from paddle_tpu_torch import data as tdata
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.data import datasets as tds
from paddle_tpu_torch.framework import params_from_jax
from paddle_tpu_torch.layers import beam_search as tBS
from paddle_tpu_torch.models import fit_a_line as tfit
from paddle_tpu_torch.models import lstm as tlstm
from paddle_tpu_torch.models import seq2seq as tseq
from paddle_tpu_torch.models import srl as tsrl
from paddle_tpu_torch.models import word2vec as tw2v

CPU = tpt.CPUPlace()
LOSS_RTOL, PARAM_ATOL, SCORE_TOL = 1e-5, 1e-5, 1e-5
STEPS = 3


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# feeds, at narrow widths


def _lstm_feeds(full=False, n=STEPS, b=4, s=7, vocab=50, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = np.full(b, s) if full else rng.randint(1, s + 1, b)
        out.append({"word_ids": rng.randint(0, vocab, (b, s)).astype(np.int64),
                    "label": rng.randint(0, 2, (b, 1)).astype(np.int64),
                    "sequence_length": lens.astype(np.int64)})
    return out


def _seq2seq_feeds(n=STEPS, b=3, s=5, t=4, vocab=30, seed=0):
    """bench.py bench_seq2seq's feeds at a small size, with ragged sources
    and a padded label."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        src = rng.randint(3, vocab, (b, s)).astype(np.int64)
        trg = np.concatenate([np.ones((b, 1), np.int64), src[:, :t - 1]], axis=1)
        labels = np.concatenate([trg[:, 1:], np.full((b, 1), 2)], axis=1).astype(np.int64)
        labels[0, -1] = 0  # a pad label, left out of the mean
        out.append({"src_ids": src, "trg_ids": trg, "labels": labels,
                    "src_lengths": np.array([s, 2, 4][:b], np.int64)})
    return out


def _srl_feeds(n=STEPS, b=3, t=6, vocab=40, labels=5, seed=0):
    rng = np.random.RandomState(seed)
    return [{"word_ids": rng.randint(0, vocab, (b, t)).astype(np.int64),
             "mark_ids": rng.randint(0, 2, (b, t)).astype(np.int64),
             "label": rng.randint(0, labels, (b, t)).astype(np.int64),
             "lengths": np.array([t, 2, 4][:b], np.int64)} for _ in range(n)]


def _w2v_feeds(n=STEPS, b=5, dict_size=40, seed=0):
    rng = np.random.RandomState(seed)
    return [{"context_ids": rng.randint(0, dict_size, (b, 4)).astype(np.int64),
             "label": rng.randint(0, dict_size, (b, 1)).astype(np.int64)}
            for _ in range(n)]


def _fit_feeds(n=STEPS, b=8, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(b, 13).astype(np.float32),
             "y": rng.randn(b, 1).astype(np.float32)} for _ in range(n)]


MODELS = {
    "lstm": (lambda M: M.make_model(vocab_size=50, emb_dim=8, hidden_dim=8, num_layers=2),
             jlstm, tlstm, lambda: _lstm_feeds()),
    "lstm_full_lengths": (lambda M: M.make_model(vocab_size=50, emb_dim=6, hidden_dim=8,
                                                 num_layers=2),
                          jlstm, tlstm, lambda: _lstm_feeds(full=True)),
    "seq2seq": (lambda M: M.make_model(src_vocab=30, trg_vocab=30, emb_dim=8, hidden=8),
                jseq, tseq, lambda: _seq2seq_feeds()),
    "srl": (lambda M: M.make_model(vocab_size=40, num_labels=5, word_dim=6, hidden_dim=8,
                                   depth=3), jsrl, tsrl, lambda: _srl_feeds()),
    "word2vec": (lambda M: M.make_model(dict_size=40, emb_dim=6, hidden=10), jw2v, tw2v,
                 lambda: _w2v_feeds()),
    "fit_a_line": (lambda M: M.make_model(), jfit, tfit, lambda: _fit_feeds()),
}


def _trainers(name, lr=1e-3):
    make, jmod, tmod, feeds = MODELS[name]
    feeds = feeds()
    jt = jpt.Trainer(jpt.build(make(jmod)), jopt.Adam(lr), loss_name="loss")
    jt.startup(sample_feed=feeds[0])
    jparams = {k: np.asarray(v) for k, v in jt.scope.params.items()}
    tt = tpt.Trainer(tpt.build(make(tmod)), topt.Adam(lr), loss_name="loss", place=CPU)
    tt.startup(sample_feed=feeds[0], params=params_from_jax(jparams, device="cpu"))
    assert sorted(tt.program.param_info) == sorted(jt.program.param_info)
    for k, info in jt.program.param_info.items():
        assert tt.program.param_info[k].shape == tuple(info.shape), k
    return jt, tt, feeds, jparams


@pytest.mark.parametrize("name", sorted(MODELS))
def test_adam_steps_match_jax(name):
    jt, tt, feeds, _ = _trainers(name)
    for f in feeds:
        jout, tout = jt.step(f), tt.step(f)
        np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]), rtol=LOSS_RTOL)
        if name == "srl":  # the Viterbi path of each step's emissions, exactly
            np.testing.assert_array_equal(_np(tout["decoded"]), _np(jout["decoded"]))
            np.testing.assert_allclose(float(tout["acc"]), float(jout["acc"]), rtol=1e-6)
        if name.startswith("lstm"):
            np.testing.assert_allclose(float(tout["acc"]), float(jout["acc"]), rtol=1e-6)
    for k, v in jt.scope.params.items():
        np.testing.assert_allclose(_np(tt.scope.params[k]), _np(v), rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


def test_word2vec_reads_one_shared_table():
    _, tt, feeds, jparams = _trainers("word2vec")
    assert "shared_emb/w" in jparams
    assert not any(k.startswith("embedding_") for k in jparams)
    assert tt.scope.params["shared_emb/w"].shape == (40, 6)


@pytest.mark.parametrize("name", ["lstm", "seq2seq", "srl"])
def test_captured_body_gives_the_eager_steps_bits(name):
    make, _, tmod, feeds = MODELS[name]
    feeds = feeds()
    trs = [tpt.Trainer(tpt.build(make(tmod)), topt.Adam(1e-3), loss_name="loss",
                       place=CPU).startup(2, feeds[0]) for _ in range(2)]
    eager = torch.stack([trs[0].step(f)["loss"] for f in feeds])
    fused = trs[1].run_steps(tdata.stack_batches(feeds))["loss"]
    assert torch.equal(eager, fused)
    for k, p in trs[0].scope.params.items():
        assert torch.equal(p, trs[1].scope.params[k]), k


def test_lstm_holds_each_rows_state_past_its_end():
    """Tokens past a row's length change neither its loss nor its grads."""
    make, _, tmod, feeds = MODELS["lstm"]
    feed = feeds()[0]
    prog = tpt.build(make(tmod))
    params, _ = prog.init(0, place=CPU, **feed)
    other = dict(feed, word_ids=feed["word_ids"].copy())
    for i, n in enumerate(feed["sequence_length"]):
        other["word_ids"][i, n:] = (other["word_ids"][i, n:] + 7) % 50
    outs = [prog.apply(params, {}, place=CPU, **f)[0]["loss"] for f in (feed, other)]
    assert torch.equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# the seq2seq decoder from trained params, and its 2-level LoD


@pytest.fixture(scope="module")
def trained_seq2seq():
    """Both packages' seq2seq after 9 Adam(5e-2) steps from one init: sharper
    distributions than at init, as a trained model decodes."""
    jt, tt, feeds, _ = _trainers("seq2seq", lr=5e-2)
    for f in feeds * 3:
        jt.step(f)
        tt.step(f)
    return jt, tt, feeds


@pytest.mark.parametrize("beam_size", [1, 3])
def test_seq2seq_decode_matches_jax(trained_seq2seq, beam_size):
    jt, tt, feeds = trained_seq2seq
    dims = dict(src_vocab=30, trg_vocab=30, emb_dim=8, hidden=8, max_len=6,
                beam_size=beam_size)
    src = {"src_ids": feeds[0]["src_ids"], "src_lengths": feeds[0]["src_lengths"]}
    jdec = jpt.build(jseq.make_decoder(**dims))
    jdec.init(jax.random.PRNGKey(0), **src)
    jout, _ = jdec.apply(jt.scope.params, {}, **src)
    tdec = tpt.build(tseq.make_decoder(**dims))
    tdec.init(0, place=CPU, **src)
    assert sorted(tdec.param_info) == sorted(tt.scope.params)
    with torch.no_grad():
        tout, _ = tdec.apply(tt.scope.params, {}, place=CPU, **src)
    assert tout["ids"].shape == (3, beam_size, 6) and tout["ids"].dtype == torch.int32
    np.testing.assert_array_equal(_np(tout["ids"]), _np(jout["ids"]))
    np.testing.assert_allclose(_np(tout["scores"]), _np(jout["scores"]), rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    # the reference's 2-level LoD of the decoded beams
    ids = _np(tout["ids"])
    valid = (np.cumsum(ids == 2, axis=-1) - (ids == 2)) == 0
    jlod, jsc = jBS.beam_search_decode_lod(_np(jout["ids"]), valid, _np(jout["scores"]))
    tlod, tsc = tBS.beam_search_decode_lod(tout["ids"], torch.from_numpy(valid),
                                           tout["scores"])
    assert tlod.recursive_sequence_lengths() == jlod.recursive_sequence_lengths()
    assert tlod.recursive_sequence_lengths()[0] == [beam_size] * 3
    np.testing.assert_array_equal(_np(tlod.values), _np(jlod.values))
    np.testing.assert_allclose(_np(tsc.values), _np(jsc.values), rtol=SCORE_TOL,
                               atol=SCORE_TOL)


# ---------------------------------------------------------------------------
# datasets


DATASETS = {
    "uci_housing": lambda ds, split: ds.uci_housing(split, synthetic_size=6),
    "imdb": lambda ds, split: ds.imdb(split, vocab_size=60, seq_len=12, synthetic_size=6),
    "wmt16": lambda ds, split: ds.wmt16(split, 40, 50, seq_len=9, synthetic_size=6),
    "wmt14": lambda ds, split: ds.wmt14(split, dict_size=70, seq_len=8, synthetic_size=6),
    "conll05": lambda ds, split: ds.conll05(split, 60, 7, seq_len=10, synthetic_size=6),
    "imikolov_ngram": lambda ds, split: ds.imikolov(split, ds.imikolov_build_dict(
        vocab_size=80), n=4, synthetic_size=4),
    "imikolov_seq": lambda ds, split: ds.imikolov(split, None, n=3,
                                                  data_type=ds.DataType.SEQ,
                                                  synthetic_size=4),
    "sentiment": lambda ds, split: ds.sentiment(split, vocab_size=70, seq_len=20,
                                                synthetic_size=6),
}


def _flat(sample):
    if isinstance(sample, (tuple, list)) and sample and not np.isscalar(sample[0]):
        return [np.asarray(x) for x in sample]
    return [np.asarray(sample)]


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_datasets_yield_the_jax_samples(name):
    for split in ("train", "test"):
        jr, tr = DATASETS[name](jds, split), DATASETS[name](tds, split)
        assert jr.synthetic == tr.synthetic
        got, want, again = list(tr()), list(jr()), list(tr())
        assert len(got) == len(want) > 0
        for g, w, a in zip(got, want, again):
            for gg, ww, aa in zip(_flat(g), _flat(w), _flat(a), strict=True):
                assert gg.shape == ww.shape and gg.dtype == ww.dtype
                np.testing.assert_array_equal(gg, ww)
                np.testing.assert_array_equal(aa, gg)  # determinism


def test_dataset_shapes():
    src, trg, nxt = next(iter(tds.wmt16("train", seq_len=9, synthetic_size=2)()))
    assert src.shape == trg.shape == nxt.shape == (9,) and trg[0] == 1
    words, marks, labels, n = next(iter(tds.conll05(seq_len=10, synthetic_size=2)()))
    assert words.shape == marks.shape == labels.shape == (10,) and 5 <= int(n) < 10
    ids, y = next(iter(tds.imdb(seq_len=12, synthetic_size=2)()))
    assert ids.shape == (12,) and ids.dtype == np.int64 and int(y) in (0, 1)
    x, price = next(iter(tds.uci_housing(synthetic_size=2)()))
    assert x.shape == (13,) and price.shape == (1,)
    gram = next(iter(tds.imikolov_train(n=5)()))
    assert len(gram) == 5
    d = tds.imikolov_build_dict()
    assert len(d) == 2073 and d["<unk>"] == 2072 and d == jds.imikolov_build_dict()
