"""RNN encoder-decoder with attention (counterpart of
``paddle_tpu.models.seq2seq``): the book machine-translation model and
bench.py ``bench_seq2seq``: a bidirectional GRU encoder and a GRU decoder
with additive attention, built from primitive ops.

``make_model`` is the teacher-forced training program; ``make_decoder``
the generation program (beam search over the same attention cell through
``layers.beam_search.beam_search``). Both create their parameters in one
order under one set of names, so a trained scope applies to the decoder
as it is; ``layers.beam_search_decode_lod`` packages its output as the
reference's 2-level LoD.

Every matmul of the cell runs in the compute dtype, the attention scores
soft-max in f32, and the loss is the JAX package's f32 ``log_softmax``
then the label's entry (seq2seq.py:110-114). The decoder weights are cast
once a run, not once a step.
"""

from __future__ import annotations

import torch

from .. import initializer as init
from .. import layers as L
from ..framework import LayerHelper, cast_compute, compute_dtype
from ..layers.nn import _embedding_lookup
from ..layers.rnn import _gru_step, dynamic_gru


def _forward(src_ids, trg_ids, src_lengths, src_vocab, trg_vocab, emb_dim, hidden):
    """The shared builder: the encoder, every decoder parameter and the
    teacher-forced decode of ``trg_ids``. Returns (logits, aux), aux
    holding the attention cell and the tensors generation needs."""
    helper = LayerHelper("seq2seq")
    cd = compute_dtype()
    # the encoder: a bidirectional GRU
    src_emb = L.embedding(src_ids, size=[src_vocab, emb_dim])
    fwd = dynamic_gru(src_emb, hidden, sequence_length=src_lengths)
    bwd = dynamic_gru(src_emb, hidden, sequence_length=src_lengths, is_reverse=True)
    enc = torch.cat([fwd, bwd], dim=-1)  # [b, s, 2h]
    src_mask = (torch.arange(src_ids.shape[1], device=src_ids.device)[None, :]
                < src_lengths[:, None])  # [b, s]

    # the decoder's parameters (an explicit target table, so generation can
    # step token by token over it)
    def param(suffix, shape, initializer=None):
        return helper.create_parameter(suffix, shape, torch.float32,
                                       initializer=initializer or init.Xavier())

    trg_table = param("trg_emb/w", (trg_vocab, emb_dim))
    w_att_enc = param("att_enc/w", (2 * hidden, hidden))
    w_att_dec = param("att_dec/w", (hidden, hidden))
    v_att = param("att_v/w", (hidden, 1))
    w_x = param("dec_gru_x/w", (emb_dim + 2 * hidden, 3 * hidden))
    w_h = param("dec_gru_h/w", (hidden, 3 * hidden))
    b_g = param("dec_gru/b", (3 * hidden,), init.Constant(0.0))
    w_out = param("dec_out/w", (hidden, trg_vocab))

    h0 = cast_compute(cd, torch.tanh(L.fc(torch.cat([fwd[:, -1], bwd[:, 0]], dim=-1),
                                          hidden, name="init_state")))
    wad, va, wx, bg, wh = cast_compute(cd, w_att_dec, v_att, w_x, b_g, w_h)
    w_zr, w_c = wh[:, :2 * hidden], wh[:, 2 * hidden:]

    def cell(h, x_t, enc_t, enc_att_t, mask_t):
        """One decoder step: additive attention over ``enc_t``, then the
        GRU. The encoder tensors come in explicitly, so generation can
        tile them per beam."""
        h, x_t, enc_t, enc_att_t = cast_compute(cd, h, x_t, enc_t, enc_att_t)
        q = torch.matmul(h, wad)[:, None, :]                         # [r, 1, h]
        e = torch.matmul(torch.tanh(enc_att_t + q), va)[..., 0]      # [r, s]
        e = torch.where(mask_t, e.float(), -1e9)
        a = torch.softmax(e, dim=-1).to(enc_t.dtype)
        ctx = torch.bmm(a[:, None, :], enc_t)[:, 0]                  # [r, 2h]
        x_proj = torch.matmul(torch.cat([x_t, ctx], dim=-1), wx) + bg
        return _gru_step(x_proj, h, w_zr, w_c)

    enc_att = torch.matmul(enc, cast_compute(cd, w_att_enc))  # [b, s, h], once
    trg_emb = _embedding_lookup(trg_ids, trg_table, trg_table.dtype)
    h, hs = h0, []
    for x_t in trg_emb.unbind(1):
        h = cell(h, x_t, enc, enc_att, src_mask)
        hs.append(h)
    logits = torch.matmul(torch.stack(hs, dim=1), cast_compute(cd, w_out))
    aux = {"cell": cell, "enc": enc, "enc_att": enc_att, "src_mask": src_mask, "h0": h0,
           "trg_table": trg_table, "w_out": w_out}
    return logits, aux


def make_model(src_vocab=2000, trg_vocab=2000, emb_dim=128, hidden=256):
    """Program fn: (src_ids [b, s], trg_ids [b, t], labels [b, t],
    src_lengths [b]) -> {"loss": the CE's mean over non-pad labels,
    "logits"}."""

    def seq2seq(src_ids, trg_ids, labels, src_lengths):
        logits, _ = _forward(src_ids, trg_ids, src_lengths, src_vocab, trg_vocab, emb_dim,
                             hidden)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.take_along_dim(logp, labels.long()[..., None], dim=-1)[..., 0]
        nonpad = (labels != 0).float()
        loss = torch.sum(nll * nonpad) / torch.clamp_min(nonpad.sum(), 1.0)
        return {"loss": loss, "logits": logits}

    return seq2seq


def make_decoder(src_vocab=2000, trg_vocab=2000, emb_dim=128, hidden=256, max_len=20,
                 beam_size=1, bos_id=1, eos_id=2):
    """The generation program: (src_ids [b, s], src_lengths [b]) ->
    {"ids" [b, K, max_len], "scores" [b, K]} best first. It has
    ``make_model``'s parameter names: apply it with a trained Trainer's
    params."""
    from ..layers.beam_search import beam_search

    def decode_program(src_ids, src_lengths):
        b, k = src_ids.shape[0], beam_size
        # the training program's layer calls on a 1-token target create
        # every parameter under its training name
        dummy = torch.full((b, 1), bos_id, dtype=torch.int32, device=src_ids.device)
        _, aux = _forward(src_ids, dummy, src_lengths, src_vocab, trg_vocab, emb_dim,
                          hidden)
        enc = aux["enc"].repeat_interleave(k, dim=0)
        enc_att = aux["enc_att"].repeat_interleave(k, dim=0)
        mask = aux["src_mask"].repeat_interleave(k, dim=0)
        h0 = aux["h0"].repeat_interleave(k, dim=0)
        cell, table = aux["cell"], aux["trg_table"]
        w_out = cast_compute(compute_dtype(), aux["w_out"])

        def step_fn(tokens, h):
            x_t = _embedding_lookup(tokens, table, table.dtype)
            h_new = cell(h, x_t, enc, enc_att, mask)
            logits = torch.matmul(h_new, w_out).float()
            return torch.log_softmax(logits, dim=-1), h_new

        seqs, scores = beam_search(step_fn, h0, batch_size=b, beam_size=k, max_len=max_len,
                                   bos_id=bos_id, eos_id=eos_id, device=src_ids.device)
        return {"ids": seqs, "scores": scores}

    return decode_program


__all__ = ["make_decoder", "make_model"]
