"""BERT-base pretraining (counterpart of ``paddle_tpu.models.bert``):
``BertConfig``, ``base_config``, ``encode`` and the training program
``make_pretrain_model`` with its masked-LM and next-sentence heads.

The encoder is the Transformer's ``encoder_layer``, so its attention
takes the flash kernel with the padding key bias where ``use_flash`` is
set and dropout is a no-op (eval, or dropout 0); at ``BertConfig``'s
dropout 0.1 training runs the dense path. Params are created through
``LayerHelper`` under the JAX package's names and dtypes: the embedding
tables, ``pos_table``, the layer norms and the ``mlm_out`` head in
``dtype``, the attention, FFN and fc weights in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from .. import initializer as init
from .. import layers as L
from ..core.dtypes import convert_dtype
from ..framework import LayerHelper, maybe_remat, name_scope
from ..layers import attention as A
from ..ops.fused_ce import chunked_softmax_cross_entropy
from .transformer import TransformerConfig, encoder_layer


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    max_len: int = 512
    type_vocab: int = 2
    d_model: int = 768
    d_inner: int = 3072
    num_heads: int = 12
    num_layers: int = 12
    dropout: float = 0.1
    use_flash: bool = False
    # the fused [d, 3, d] QKV projection (layers/attention.py fuse_qkv)
    fuse_qkv: bool = False
    # the chunked logits-free CE for the MLM head (ops/fused_ce.py)
    fused_ce: bool = False
    ce_chunk: int = 4096
    # per-layer recompute in the backward (framework.maybe_remat)
    remat: bool = False
    dtype: str = "float32"


def base_config(**kw) -> BertConfig:
    return BertConfig(**kw)


def encode(input_ids, token_type_ids, cfg: BertConfig):
    """The encoder output [b, s, d]: word, position and type embeddings,
    layer norm, dropout, then ``num_layers`` encoder layers under the
    padding mask and a final layer norm."""
    dtype = convert_dtype(cfg.dtype)
    with name_scope("word"):
        x = L.embedding(input_ids, size=[cfg.vocab_size, cfg.d_model], dtype=dtype)
    with name_scope("pos"):
        helper = LayerHelper("pos_table")
        pos = helper.create_parameter("w", (cfg.max_len, cfg.d_model), dtype,
                                      initializer=init.Normal(0, 0.02))
        x = x + pos[None, :input_ids.shape[1]]
    with name_scope("type"):
        x = x + L.embedding(token_type_ids, size=[cfg.type_vocab, cfg.d_model],
                            dtype=dtype)
    x = L.layer_norm(x, begin_norm_axis=2)
    x = L.dropout(x, cfg.dropout, dropout_implementation="upscale_in_train")

    mask = A.padding_mask(input_ids)
    tcfg = TransformerConfig(d_model=cfg.d_model, d_inner=cfg.d_inner,
                             num_heads=cfg.num_heads, dropout=cfg.dropout,
                             use_flash=cfg.use_flash, fuse_qkv=cfg.fuse_qkv,
                             dtype=cfg.dtype)
    with name_scope("encoder"):
        for _ in range(cfg.num_layers):
            x = maybe_remat(lambda a, m: encoder_layer(a, tcfg, m),
                            enabled=cfg.remat or None)(x, mask)
        x = L.layer_norm(x, begin_norm_axis=2)
    return x


def make_pretrain_model(cfg: Union[BertConfig, dict]):
    """The training program ``bert(input_ids, token_type_ids,
    mlm_positions [b, m], mlm_labels [b, m, 1], nsp_label [b, 1]) ->
    {"loss", "mlm_loss", "nsp_loss"}``. The MLM head gathers the masked
    positions, transforms them (fc + gelu + layer norm) and projects to
    the vocabulary with ``mlm_out`` ``w``/``b`` (chunked with its bias
    under ``fused_ce``); the NSP head runs over [CLS]. It carries
    ``factory_spec``."""
    cfg = cfg if isinstance(cfg, BertConfig) else BertConfig(**cfg)

    def bert(input_ids, token_type_ids, mlm_positions, mlm_labels, nsp_label):
        seq = encode(input_ids, token_type_ids, cfg)
        dtype = seq.dtype

        # masked LM head. The rows are read by advanced indexing, whose
        # backward (index_put_ with accumulate) sums the grads of a position
        # masked twice in a fixed order on the card; torch.gather's backward
        # adds them with atomics, in an order that changes from run to run
        b = seq.shape[0]
        rows = torch.arange(b, device=seq.device)[:, None]
        gathered = seq[rows, mlm_positions.long()]  # [b, m, d]
        h = L.fc(gathered, cfg.d_model, num_flatten_dims=2, act="gelu",
                 name="mlm_transform")
        h = L.layer_norm(h, begin_norm_axis=2)
        helper = LayerHelper("mlm_out")
        w = helper.create_parameter("w", (cfg.d_model, cfg.vocab_size), dtype,
                                    initializer=init.Normal(0, 0.02))
        bias = helper.create_parameter("b", (cfg.vocab_size,), dtype,
                                       initializer=init.Constant(0.0))
        if cfg.fused_ce:
            m = h.shape[1]
            ce = chunked_softmax_cross_entropy(
                h.reshape(b * m, cfg.d_model), w, bias,
                mlm_labels.reshape(-1).long(), 0.0, cfg.ce_chunk)
            mlm_loss = ce.mean()
        else:
            mlm_logits = L.matmul(h, w) + bias
            mlm_loss = L.mean(L.softmax_with_cross_entropy(mlm_logits, mlm_labels))

        # next-sentence head over [CLS]
        pooled = L.fc(seq[:, 0], cfg.d_model, act="tanh", name="pooler")
        nsp_logits = L.fc(pooled, 2, name="nsp_out")
        nsp_loss = L.mean(L.softmax_with_cross_entropy(nsp_logits, nsp_label))

        loss = mlm_loss + nsp_loss
        return {"loss": loss, "mlm_loss": mlm_loss, "nsp_loss": nsp_loss}

    bert.factory_spec = {"factory": f"{__name__}:make_pretrain_model",
                         "kwargs": {"cfg": dataclasses.asdict(cfg)}}
    return bert


__all__ = ["BertConfig", "base_config", "encode", "make_pretrain_model"]
