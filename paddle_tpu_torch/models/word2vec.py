"""word2vec (counterpart of ``paddle_tpu.models.word2vec``; the
book/test_word2vec config): an N-gram context to the next word, the
context words read from ONE shared embedding named by
``ParamAttr(name="shared_emb/w")``."""

from __future__ import annotations

from .. import layers as L
from ..framework import ParamAttr


def make_model(dict_size=2000, emb_dim=32, hidden=256, context=4):
    def w2v(context_ids, label):
        """context_ids: [b, context] int; label: [b, 1]."""
        embs = [L.embedding(context_ids[:, i], size=[dict_size, emb_dim],
                            param_attr=ParamAttr(name="shared_emb/w"))
                for i in range(context)]
        x = L.fc(L.concat(embs, axis=-1), hidden, act="sigmoid")
        logits = L.fc(x, dict_size)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        return {"loss": loss, "logits": logits}

    return w2v


__all__ = ["make_model"]
