"""The port's beam search (``paddle_tpu_torch.layers.beam_search``)
against ``paddle_tpu.layers.beam_search`` on the CPU, the counterparts of
``tests/test_beam_search.py``: a toy best path, greedy equal to beam 1,
an exhaustive beam equal to brute force, then the two packages on the
same seeded log-prob tables, with planted ties and a length penalty, and
``beam_search_decode``'s backtracking.

Tolerances: ids exactly; scores within 1e-6 (both sum the same f32
log-probabilities in the same order; the length penalty's ``pow`` may
differ by an ulp), the brute-force oracle's score rel 1e-5 (float64
there)."""

import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.layers import beam_search as jbs

from paddle_tpu_torch.layers import beam_search as tbs

SCORE_TOL = 1e-6


def _log_softmax(a):
    a = a - a.max(axis=-1, keepdims=True)
    return (a - np.log(np.exp(a).sum(axis=-1, keepdims=True))).astype(np.float32)


def _table_step(table):
    t = torch.from_numpy(table)

    def step_fn(tokens, state):
        return t[tokens.long()], state
    return step_fn


def test_beam_search_finds_best_path_toy():
    """Transition scores favour 1 -> 3 -> 2 (eos), then 1 -> 4 -> 2."""
    vocab = 5
    logits = np.full((vocab, vocab), -10.0, np.float32)
    logits[1, 3], logits[1, 4], logits[3, 2], logits[4, 2] = 0.0, -0.5, 0.0, 0.0
    seqs, scores = tbs.beam_search(_table_step(_log_softmax(logits)),
                                   {"dummy": torch.zeros(2)}, batch_size=1, beam_size=2,
                                   max_len=4, bos_id=1, eos_id=2)
    assert seqs.dtype == torch.int32 and tuple(seqs.shape) == (1, 2, 4)
    assert seqs[0, 0, 0] == 3 and seqs[0, 0, 1] == 2
    assert seqs[0, 1, 0] == 4
    assert float(scores[0, 0]) > float(scores[0, 1])
    # a finished beam continues with eos at zero cost
    assert seqs[0, 0, 2:].tolist() == [2, 2]


def test_greedy_matches_beam1():
    table = _log_softmax(np.random.RandomState(0).randn(6, 6).astype(np.float32))
    g = tbs.greedy_search(_table_step(table), {"s": torch.zeros(3)}, batch_size=3,
                          max_len=5)
    b, _ = tbs.beam_search(_table_step(table), {"s": torch.zeros(3)}, batch_size=3,
                           beam_size=1, max_len=5)
    np.testing.assert_array_equal(g.numpy(), b[:, 0].numpy())


@pytest.mark.parametrize("trial", range(5))
def test_exhaustive_beam_equals_brute_force_enumeration(trial):
    """With beam >= vocab^max_len every prefix survives each selection, so
    the best beam is the brute-force argmax over all sequences."""
    vocab, max_len = 3, 3
    rng = np.random.RandomState(7)
    for _ in range(trial + 1):
        table = rng.randn(vocab + 3, vocab + 3).astype(np.float32)
    table[:, 2] = -100.0  # eos never competitive
    logp = _log_softmax(table)
    K = (vocab + 3) ** max_len
    seqs, scores = tbs.beam_search(_table_step(logp), {"d": torch.zeros(K)}, batch_size=1,
                                   beam_size=K, max_len=max_len, bos_id=1, eos_id=2)
    best_score, best_seq = -np.inf, None
    for cand in itertools.product(range(vocab + 3), repeat=max_len):
        s, prev = 0.0, 1
        for tok in cand:
            s += float(logp[prev, tok])
            prev = tok
        if s > best_score:
            best_score, best_seq = s, cand
    np.testing.assert_allclose(float(scores[0, 0]), best_score, rtol=1e-5)
    assert tuple(seqs[0, 0].tolist()) == best_seq


def _markov_case(seed, vocab=11, batch=3, tie=True):
    """A log-prob table per step ([steps, vocab, vocab]) and a per-row bias
    indexed by the row's count of even tokens, so the state carries a
    ``[rows]`` leaf that the gathers must reorder. With ``tie``, equal
    candidates are planted at the first two steps (the dead lanes tie at
    step 0 anyway). All values are f32 sums both packages form the same
    way."""
    rng = np.random.RandomState(seed)
    steps = 6
    tables = _log_softmax(rng.randn(steps, vocab, vocab).astype(np.float32) * 2)
    if tie:
        tables[0, 1, 5] = tables[0, 1, 7] = tables[0, 1].max()
        tables[1, :, 4] = tables[1, :, 6]
    bias = (rng.randint(-4, 1, (8,)) / 8.0).astype(np.float32)
    return tables, bias, batch


def _jax_markov(tables, bias):
    tj, bj = jnp.asarray(tables), jnp.asarray(bias)

    def step_fn(tokens, state):
        logp = tj[state["t"]][tokens] + bj[state["evens"] % 8][:, None]
        evens = state["evens"] + (tokens % 2 == 0).astype(jnp.int32)
        return logp, {"t": state["t"] + 1, "evens": evens, "aux": state["aux"]}
    return step_fn


def _torch_markov(tables, bias):
    tt, bt = torch.from_numpy(tables), torch.from_numpy(bias)

    def step_fn(tokens, state):
        logp = tt[state["t"]][tokens.long()] + bt[(state["evens"] % 8).long()][:, None]
        evens = state["evens"] + (tokens % 2 == 0).to(torch.int32)
        return logp, {"t": state["t"] + 1, "evens": evens, "aux": state["aux"]}
    return step_fn


@pytest.mark.parametrize("seed,beam,alpha,tie", [(0, 3, 0.0, True), (1, 4, 0.6, True),
                                                 (2, 2, 1.0, False), (3, 5, 0.0, True)])
def test_beam_search_matches_jax(seed, beam, alpha, tie):
    tables, bias, batch = _markov_case(seed, tie=tie)
    rows = batch * beam
    want_s, want_sc = jbs.beam_search(
        _jax_markov(tables, bias),
        {"t": jnp.asarray(0, jnp.int32), "evens": jnp.zeros((rows,), jnp.int32),
         "aux": jnp.zeros((2,))},
        batch, beam, tables.shape[0], bos_id=1, eos_id=2, length_penalty_alpha=alpha)
    got_s, got_sc = tbs.beam_search(
        _torch_markov(tables, bias),
        {"t": 0, "evens": torch.zeros((rows,), dtype=torch.int32), "aux": torch.zeros(2)},
        batch, beam, tables.shape[0], bos_id=1, eos_id=2, length_penalty_alpha=alpha)
    assert got_s.dtype == torch.int32 and tuple(got_s.shape) == (batch, beam, 6)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_allclose(got_sc.numpy(), np.asarray(want_sc), rtol=0, atol=SCORE_TOL)


def test_planted_ties_go_to_the_lower_index():
    """Two equal best candidates: the lower flat index (token 5 before 7)
    wins, as jax.lax.top_k orders them."""
    tables, bias, batch = _markov_case(0)
    beam_idx, tokens, top = tbs.beam_select(
        torch.from_numpy(tables[0][[1] * 2]), torch.tensor([0.0, tbs.NEG_INF]),
        torch.zeros(2, dtype=torch.bool), tbs.frozen_row(11, 2), 1, 2)
    assert tokens.tolist() == [5, 7] and beam_idx.tolist() == [[0, 0]]
    assert float(top[0]) == float(top[1])


def test_gather_beams_passes_non_batch_leaves_through():
    idx = torch.tensor([[1, 1], [0, 1]])
    rows = torch.arange(4, dtype=torch.float32)
    tree = {"caches": [{"k": rows[:, None].repeat(1, 3), "index": 5}],
            "step": torch.tensor(3), "other": torch.zeros(7), "pair": (rows, 2.5)}
    out = tbs._gather_beams(tree, idx, 2, 2)
    assert out["caches"][0]["k"][:, 0].tolist() == [1.0, 1.0, 2.0, 3.0]
    assert out["caches"][0]["index"] == 5 and out["pair"][1] == 2.5
    assert out["step"] is tree["step"] and out["other"] is tree["other"]
    assert out["pair"][0].tolist() == [1.0, 1.0, 2.0, 3.0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_search_decode_matches_jax(seed):
    rng = np.random.RandomState(seed)
    T, b, k = 7, 2, 3
    ids = rng.randint(3, 9, (T, b, k)).astype(np.int32)
    ids[rng.rand(T, b, k) < 0.2] = 2
    parents = rng.randint(0, k, (T, b, k)).astype(np.int32)
    want_s, want_v = jbs.beam_search_decode(ids, parents, end_id=2)
    got_s, got_v = tbs.beam_search_decode(torch.from_numpy(ids), torch.from_numpy(parents),
                                          end_id=2)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert (~got_v.numpy()).any()
