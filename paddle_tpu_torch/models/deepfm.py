"""DeepFM CTR model (counterpart of ``paddle_tpu.models.deepfm``): the
BASELINE "DeepFM CTR (sparse embedding + pserver distributed transpiler)"
config.

One flat ``[fields·dim]`` first-order table and one ``[fields·dim, k]``
factor table, both flagged ``is_distributed`` (a marker on one card, as in
the JAX package), read at ``ids + arange(fields)·dim``; the FM
interaction, a ReLU tower over the embeddings and dense features, and a
dense linear head. ``build(make_model(...))`` has the JAX program's
parameter names (``deepfm_0/fm_w1/w``, ``deepfm_0/fm_v/w``, ``fc_0`` ...
``fc_{n+1}``), so ``params_from_jax`` carries a JAX init across.

The rows are read by advanced indexing (``_embedding_lookup``), whose
backward on the card sums repeated ids in a fixed order (a sorted
``index_put_``); a batch repeats ids heavily (2,048 rows × 26 fields over
1,000 rows a field), and ``index_select``/``gather`` would sum them with
atomics, in a different order each run. The offsets and the label's cast
are made on the device inside the step, so the step captures as a CUDA
graph.
"""

from __future__ import annotations

import torch

from .. import initializer as init
from .. import layers as L
from ..framework import LayerHelper
from ..layers.nn import _embedding_lookup


def make_model(num_sparse_fields=26, sparse_feature_dim=1000, embedding_size=16,
               num_dense=13, hidden_dims=(400, 400, 400)):
    def deepfm(dense, sparse_ids, label):
        """dense [b, num_dense] f32, sparse_ids [b, fields] (ids within each
        field), label [b, 1] int."""
        helper = LayerHelper("deepfm")
        rows = num_sparse_fields * sparse_feature_dim
        w1 = helper.create_parameter("fm_w1/w", (rows, 1), torch.float32,
                                     initializer=init.Normal(0, 0.01), is_distributed=True)
        v = helper.create_parameter("fm_v/w", (rows, embedding_size), torch.float32,
                                    initializer=init.Normal(0, 0.01), is_distributed=True)

        # field f occupies rows [f·dim, (f+1)·dim) of the flat tables
        offsets = torch.arange(num_sparse_fields, device=sparse_ids.device) * sparse_feature_dim
        flat_ids = sparse_ids.long() + offsets[None, :]

        first = _embedding_lookup(flat_ids, w1, w1.dtype)[..., 0].sum(dim=1, keepdim=True)
        emb = _embedding_lookup(flat_ids, v, v.dtype)  # [b, fields, k]
        sum_sq = torch.square(emb.sum(dim=1))
        sq_sum = torch.square(emb).sum(dim=1)
        second = 0.5 * (sum_sq - sq_sum).sum(dim=1, keepdim=True)

        deep = torch.cat([emb.reshape(emb.shape[0], -1), dense], dim=1)
        for h in hidden_dims:
            deep = L.fc(deep, h, act="relu")
        deep_out = L.fc(deep, 1)

        dense_lin = L.fc(dense, 1)
        logit = first + second + deep_out + dense_lin
        loss = L.mean(L.sigmoid_cross_entropy_with_logits(logit, label.float()))
        return {"loss": loss, "prob": L.sigmoid(logit), "logit": logit}

    return deepfm


__all__ = ["make_model"]
