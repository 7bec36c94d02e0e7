"""Semantic role labelling (counterpart of ``paddle_tpu.models.srl``; the
book ``label_semantic_roles`` config): word and predicate-mark embeddings,
stacked LSTMs alternating direction with a residual, per-position
emission scores, the linear-chain CRF's loss and its Viterbi decode, over
padded [b, t] batches with lengths."""

from __future__ import annotations

import torch

from .. import layers as L
from ..layers.crf import crf_decoding, linear_chain_crf
from ..layers.rnn import dynamic_lstm


def make_model(vocab_size=5000, num_labels=20, word_dim=32, hidden_dim=128, depth=4):
    """word_ids [b, t], mark_ids [b, t] (1 on the predicate span), label
    [b, t], lengths [b]."""

    def srl_net(word_ids, mark_ids, label, lengths):
        word = L.embedding(word_ids, size=[vocab_size, word_dim], name="word_emb")
        mark = L.embedding(mark_ids, size=[2, word_dim], name="mark_emb")
        x = torch.cat([word, mark], dim=-1)

        h, _ = dynamic_lstm(x, hidden_dim, sequence_length=lengths, name="lstm_0")
        for i in range(1, depth):
            nxt, _ = dynamic_lstm(h, hidden_dim, sequence_length=lengths,
                                  is_reverse=bool(i % 2), name=f"lstm_{i}")
            h = nxt + h  # the residual keeps deep stacks trainable
        emission = L.fc(h, num_labels, num_flatten_dims=2, name="emission")

        nll, transition = linear_chain_crf(emission, label, lengths, name="crf")
        decoded = crf_decoding(emission, lengths, transition)
        mask = torch.arange(label.shape[1], device=label.device)[None, :] < lengths[:, None]
        correct = torch.sum((decoded == label) & mask)
        acc = correct / torch.clamp_min(torch.sum(mask), 1)
        return {"loss": torch.mean(nll), "decoded": decoded, "acc": acc}

    return srl_net


__all__ = ["make_model"]
