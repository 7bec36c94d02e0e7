"""Greedy and beam-search decoding (counterpart of
``paddle_tpu.layers.beam_search``).

The step-function contract is the JAX package's: ``step_fn(tokens
[rows], state) -> (logprobs [rows, vocab], new_state)``, where the state
is any nest of dicts, lists and tuples of tensors (and ints, such as a
cache's step index). The JAX ``lax.scan`` over a static ``max_len``
becomes a Python loop here; a GPT generator on the card runs the same
selection functions (:func:`greedy_select`, :func:`beam_select`) inside
one captured CUDA graph of a decode step (``_captured_decode``).

Ties are broken as the JAX package breaks them: ``jax.lax.top_k``
returns the lower flat index first and ``jnp.argsort`` is stable. Dead
beam lanes start at ``NEG_INF`` and tie at step 0, so ties are real.
``torch.topk`` promises no order among ties on the card, so the beam
selection takes the first ``beam`` entries of a stable descending sort.

:func:`beam_search_decode_lod` packages decoded beams as the reference's
2-level LoD output (a :class:`sequence.LoDTensor`).
"""

from __future__ import annotations

import numpy as np
import torch

from .sequence import LoDTensor

NEG_INF = -1e9


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def beam_rows(beam_idx: torch.Tensor, beam: int) -> torch.Tensor:
    """[B, beam] lane indices -> [B*beam] int64 row indices into the
    ``[B*beam, ...]`` layout (row ``b*beam + lane``)."""
    base = torch.arange(beam_idx.shape[0], device=beam_idx.device)[:, None] * beam
    return (beam_idx.long() + base).reshape(-1)


def _gather_beams(tree, idx, batch: int, beam: int):
    """Reindex the beam dimension of every ``[batch*beam, ...]`` tensor
    leaf of ``tree`` by ``idx`` [batch, beam]. Ints, 0-dim tensors and
    tensors whose first dimension is not ``batch*beam`` (e.g. a cache's
    step index) pass through unchanged. Returns new tensors."""
    rows = beam_rows(idx, beam)

    def g(x):
        if not isinstance(x, torch.Tensor) or x.ndim == 0 or x.shape[0] != batch * beam:
            return x
        return x.index_select(0, rows)

    return _tree_map(g, tree)


def greedy_select(logp: torch.Tensor, finished: torch.Tensor, eos_id: int) -> torch.Tensor:
    """The next token of each row [rows] int32: the first maximal id
    (``torch.argmax`` returns the first, as ``jnp.argmax`` does), or
    ``eos_id`` for a row that has finished."""
    nxt = torch.argmax(logp, dim=-1).to(torch.int32)
    return torch.where(finished, eos_id, nxt)


def frozen_row(vocab: int, eos_id: int, device=None) -> torch.Tensor:
    """[vocab] f32: a finished beam's continuation scores — only EOS, at
    zero cost."""
    row = torch.full((vocab,), NEG_INF, dtype=torch.float32, device=device)
    row[eos_id] = 0.0
    return row


def beam_select(logp, scores, finished, frozen, batch: int, beam: int):
    """One beam-search selection: the top ``beam`` of ``beam × vocab``
    candidates per batch row. ``logp`` [B*beam, V] f32, ``scores``
    [B*beam] f32, ``finished`` [B*beam] bool, ``frozen`` from
    :func:`frozen_row`. Returns (beam_idx [B, beam] int64, tokens
    [B*beam] int32, top scores [B*beam] f32), best first, ties to the
    lower flat index."""
    vocab = logp.shape[-1]
    logp = torch.where(finished[:, None], frozen, logp)
    cand = (scores[:, None] + logp).reshape(batch, beam * vocab)
    top_scores, top_idx = torch.sort(cand, dim=1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :beam], top_idx[:, :beam]
    beam_idx = torch.div(top_idx, vocab, rounding_mode="floor")
    tokens = (top_idx - beam_idx * vocab).to(torch.int32).reshape(-1)
    return beam_idx, tokens, top_scores.reshape(-1)


def initial_scores(batch: int, beam: int, device=None) -> torch.Tensor:
    """[B*beam] f32: lane 0 of each row alive, the others dead, so step 0
    does not duplicate beams."""
    s = torch.full((batch, beam), NEG_INF, dtype=torch.float32, device=device)
    s[:, 0] = 0.0
    return s.reshape(-1)


def finish_beams(seqs, scores, batch: int, beam: int, eos_id: int,
                 length_penalty_alpha: float = 0.0):
    """Sequences [B, beam, T] and scores [B, beam] sorted best-first, with
    the GNMT length penalty ``((5 + len) / 6) ** alpha`` where alpha > 0
    (len counts tokens that are neither 0 nor EOS, plus one)."""
    seqs = seqs.reshape(batch, beam, -1)
    scores = scores.reshape(batch, beam)
    if length_penalty_alpha > 0:
        lengths = ((seqs != 0) & (seqs != eos_id)).sum(dim=-1).float() + 1.0
        penalty = torch.pow((5.0 + lengths) / 6.0, length_penalty_alpha)
        scores = scores / penalty
    order = torch.argsort(-scores, dim=1, stable=True)
    seqs = torch.take_along_dim(seqs, order[..., None], dim=1)
    scores = torch.take_along_dim(scores, order, dim=1)
    return seqs, scores


def beam_search(step_fn, init_state, batch_size: int, beam_size: int, max_len: int,
                bos_id: int = 1, eos_id: int = 2, length_penalty_alpha: float = 0.0,
                device=None):
    """Returns (sequences [B, beam, max_len] int32, scores [B, beam] f32)
    sorted best-first. ``init_state`` leaves must be laid out
    ``[B*beam, ...]`` (tile per-batch state ``beam_size`` times first).
    Finished beams continue only with EOS at zero cost; the loop runs all
    ``max_len`` steps, as the JAX scan does."""
    B, K = batch_size, beam_size
    tokens = torch.full((B * K,), bos_id, dtype=torch.int32, device=device)
    scores = initial_scores(B, K, device)
    finished = torch.zeros((B * K,), dtype=torch.bool, device=device)
    seqs = torch.zeros((B * K, max_len), dtype=torch.int32, device=device)
    state = init_state
    frozen = None
    for t in range(max_len):
        logp, state = step_fn(tokens, state)
        if frozen is None:
            frozen = frozen_row(logp.shape[-1], eos_id, logp.device)
        beam_idx, tokens, scores = beam_select(logp, scores, finished, frozen, B, K)
        state, seqs, finished = _gather_beams((state, seqs, finished), beam_idx, B, K)
        seqs[:, t] = tokens
        finished = finished | (tokens == eos_id)
    return finish_beams(seqs, scores, B, K, eos_id, length_penalty_alpha)


def greedy_search(step_fn, init_state, batch_size: int, max_len: int,
                  bos_id: int = 1, eos_id: int = 2, device=None):
    """Greedy decode: [batch_size, max_len] int32 token ids. A row that
    emitted ``eos_id`` keeps emitting it."""
    tokens = torch.full((batch_size,), bos_id, dtype=torch.int32, device=device)
    finished = torch.zeros((batch_size,), dtype=torch.bool, device=device)
    seqs = torch.zeros((batch_size, max_len), dtype=torch.int32, device=device)
    state = init_state
    for t in range(max_len):
        logp, state = step_fn(tokens, state)
        tokens = greedy_select(logp, finished, eos_id)
        seqs[:, t] = tokens
        finished = finished | (tokens == eos_id)
    return seqs


def beam_search_decode(step_ids, step_parents, end_id: int = 2, name=None):
    """beam_search_decode_op analog: backtrack per-step (ids, parent beam
    indices) into full sequences.

    ``step_ids``/``step_parents``: [T, B, K] integers — the token chosen
    at step t per beam, and the beam lane it extended. Returns (sequences
    [B, K, T], valid [B, K, T]): ``valid`` marks tokens up to and
    including the first ``end_id``."""
    step_ids = torch.as_tensor(step_ids)
    step_parents = torch.as_tensor(step_parents)
    t_steps, b, k = step_ids.shape
    lane = torch.arange(k, device=step_ids.device).expand(b, k)
    toks = []
    for t in reversed(range(t_steps)):
        toks.append(torch.gather(step_ids[t], 1, lane))
        lane = torch.gather(step_parents[t].long(), 1, lane)
    seqs = torch.stack(toks[::-1]).permute(1, 2, 0)
    is_end = (seqs == end_id).int()
    ended_before = torch.cumsum(is_end, dim=-1) - is_end
    return seqs, ended_before == 0


def beam_search_decode_lod(seqs, valid, scores=None, place=None):
    """Package decoded beams as the reference's 2-level LoD output
    (beam_search_decode_op.cc): level 0 groups the hypotheses of each
    source sentence, level 1 gives each hypothesis's token count.

    ``seqs``/``valid``: [B, K, T] from :func:`beam_search_decode` (or from
    :func:`beam_search`, ``valid`` marking tokens up to the first EOS).
    Returns a ``LoDTensor`` of int32 token ids with ``recursive_seq_lens =
    [[K]*B, per-hypothesis lengths]``; with ``scores`` [B, K], also a
    2-level LoDTensor of the scores whose innermost lengths are 1 (the
    sentenceScores output). Ragged bookkeeping on the host, as the
    reference computes it on the CPU; the results go to ``place``, else to
    ``seqs``' device when it is a tensor, else to the card."""
    if place is None and isinstance(seqs, torch.Tensor):
        place = seqs.device

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    seqs_np, valid_np = host(seqs), host(valid).astype(bool)
    b, k, _ = seqs_np.shape
    tokens = [seqs_np[i, j][valid_np[i, j]] for i in range(b) for j in range(k)]
    flat = np.concatenate(tokens) if tokens else np.zeros((0,), seqs_np.dtype)
    ids = LoDTensor(flat.astype(np.int32), [[k] * b, [len(t) for t in tokens]], place)
    if scores is None:
        return ids
    return ids, LoDTensor(host(scores).reshape(b * k), [[k] * b, [1] * (b * k)], place)


__all__ = ["NEG_INF", "beam_rows", "beam_search", "beam_search_decode",
           "beam_search_decode_lod", "beam_select",
           "finish_beams", "frozen_row", "greedy_search", "greedy_select",
           "initial_scores"]
