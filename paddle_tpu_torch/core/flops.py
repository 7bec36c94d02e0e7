"""Analytic model-FLOP counts of a training step (counterpart of
``paddle_tpu.core.flops``; the port keeps its own copy of the formulas).

Conventions, the JAX package's (PaLM appendix-B style, Megatron matmul
accounting):

- dense matmul train FLOPs = 6 · (matmul params) · tokens (forward 2N,
  backward 4N);
- attention adds a forward 4·s·d per token per layer (QKᵀ and PV), ×3
  in training = 12·L·s·d per token; causal attention is halved, since the
  flash kernels compute only the lower triangle;
- elementwise, norm and gather FLOPs are left out (an undercount, never
  an overcount).

A step's TFLOP/s is these FLOPs over its wall time; MFU divides that by
the card's peak.
"""

from __future__ import annotations


def _attn_train_flops(tokens: int, seq: int, d_model: int, layers: int,
                      causal: bool) -> float:
    f = 12.0 * layers * seq * d_model * tokens
    return f / 2 if causal else f


def transformer_train_flops(bs: int, seq: int, cfg) -> float:
    """Train-step FLOPs of the encoder-decoder transformer
    (``models/transformer.py``; flops.py:101). Encoder: full
    self-attention. Decoder: causal self-attention (halved) and full
    cross-attention, whose q/kv/out projections add 4·d² params a decoder
    layer. The vocab projection counts on the decoder tokens only."""
    d, di = cfg.d_model, cfg.d_inner
    tokens = bs * seq
    enc_layer_params = 4 * d * d + 2 * d * di
    dec_layer_params = 8 * d * d + 2 * d * di
    f = 6.0 * tokens * (enc_layer_params * cfg.num_encoder_layers +
                        dec_layer_params * cfg.num_decoder_layers)
    f += _attn_train_flops(tokens, seq, d, cfg.num_encoder_layers, causal=False)
    f += _attn_train_flops(tokens, seq, d, cfg.num_decoder_layers, causal=True)
    f += _attn_train_flops(tokens, seq, d, cfg.num_decoder_layers, causal=False)
    f += 6.0 * d * cfg.trg_vocab * tokens  # output projection
    return f


def bert_train_flops(bs: int, seq: int, num_masked: int, cfg) -> float:
    """Train-step FLOPs of BERT pretraining (``models/bert.py``;
    flops.py:150): the encoder stack, the MLM head (transform and vocab
    projection over the masked positions) and the pooler/NSP head."""
    d, di, L = cfg.d_model, cfg.d_inner, cfg.num_layers
    tokens = bs * seq
    f = 6.0 * (4 * d * d + 2 * d * di) * tokens * L
    f += _attn_train_flops(tokens, seq, d, L, causal=False)
    f += 6.0 * (d * d + d * cfg.vocab_size) * bs * num_masked  # MLM head
    f += 6.0 * (d * d + 2 * d) * bs  # pooler + NSP
    return f


def mlp_train_flops(bs: int, dims) -> float:
    """Train-step FLOPs of a dense MLP with layer widths ``dims``
    (flops.py:302): 6 · (matmul params) · batch."""
    params = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return 6.0 * params * bs


def deepfm_train_flops(bs: int, num_fields: int, emb_size: int, num_dense: int,
                       hidden_dims) -> float:
    """Train-step FLOPs of DeepFM (``models/deepfm.py``; flops.py:343): the
    deep tower over the concatenated embeddings and dense features, and
    the dense linear head. The embedding gathers, their scatter-add
    backward and the FM interaction are left out (they move bytes, not
    matmul FLOPs): an undercount."""
    dims = [num_fields * emb_size + num_dense, *hidden_dims, 1]
    return mlp_train_flops(bs, dims) + 6.0 * num_dense * bs


__all__ = ["bert_train_flops", "deepfm_train_flops", "mlp_train_flops",
           "transformer_train_flops"]
