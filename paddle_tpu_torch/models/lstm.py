"""Stacked-LSTM text classification (counterpart of
``paddle_tpu.models.lstm``): the benchmark's stacked_dynamic_lstm model
(benchmark/fluid/models/stacked_dynamic_lstm.py; bench.py ``bench_lstm``
and ``bench_lstm_big``): an embedding, ``num_layers`` dynamic LSTMs, the
mean over each row's valid positions, ``fc``, softmax CE and accuracy."""

from __future__ import annotations

import torch

from .. import layers as L
from ..layers.rnn import dynamic_lstm
from ..metrics import accuracy


def make_model(vocab_size=5000, emb_dim=512, hidden_dim=512, num_layers=2, class_num=2):
    def lstm_net(word_ids, label, sequence_length=None):
        x = L.embedding(word_ids, size=[vocab_size, emb_dim])
        for _ in range(num_layers):
            x, _ = dynamic_lstm(x, hidden_dim, sequence_length=sequence_length)
        # the mean over valid positions (sequence_pool "average")
        if sequence_length is not None:
            t = x.shape[1]
            mask = (torch.arange(t, device=x.device)[None, :]
                    < sequence_length[:, None]).to(x.dtype)
            pooled = (x * mask[..., None]).sum(1) / torch.clamp_min(
                mask.sum(1, keepdim=True), 1.0)
        else:
            pooled = x.mean(dim=1)
        logits = L.fc(pooled, class_num)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        return {"loss": loss, "acc": accuracy(logits, label), "logits": logits}

    return lstm_net


__all__ = ["make_model"]
