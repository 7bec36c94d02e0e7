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


def lstm_train_flops(bs: int, seq: int, hidden: int, num_layers: int,
                     emb_dim=None) -> float:
    """Train-step FLOPs of the stacked LSTM (``models/lstm.py``;
    flops.py:307): the input and recurrent GEMMs of the 4 gates a step a
    layer, ×6; the gates' elementwise math and the head are left out."""
    emb_dim = emb_dim or hidden
    f = 0.0
    for layer in range(num_layers):
        xin = emb_dim if layer == 0 else hidden
        f += 6.0 * (4 * hidden * (xin + hidden)) * bs * seq
    return f


def seq2seq_train_flops(bs: int, src_len: int, trg_len: int, emb_dim: int, hidden: int,
                        trg_vocab: int) -> float:
    """Train-step FLOPs of the GRU seq2seq with additive attention
    (``models/seq2seq.py``; flops.py:318): the gate, attention and output
    matmuls at the train factor 6; the embedding gathers, softmaxes and
    elementwise attention math are left out (an undercount)."""
    f = 2 * 6.0 * (3 * hidden * (emb_dim + hidden)) * bs * src_len  # bi-GRU encoder
    f += 6.0 * (2 * hidden * hidden) * bs * src_len                 # attention's enc proj
    # a decoder step: query proj, scores, context, the GRU's x and h GEMMs
    f += 6.0 * (hidden * hidden) * bs * trg_len
    f += 6.0 * (src_len * hidden) * bs * trg_len
    f += 6.0 * (src_len * 2 * hidden) * bs * trg_len
    f += 6.0 * (3 * hidden * (emb_dim + 2 * hidden)) * bs * trg_len
    f += 6.0 * (3 * hidden * hidden) * bs * trg_len
    f += 6.0 * (hidden * trg_vocab) * bs * trg_len                  # the output head
    return f


# -- convnets (flops.py:166-300) ----------------------------------------------


def _conv_flops(cin: int, cout: int, k: int, hout: int, wout: int) -> float:
    return 2.0 * k * k * cin * cout * hout * wout


def resnet_fwd_flops(depth: int = 50, image_size: int = 224,
                     class_num: int = 1000) -> float:
    """Per-image forward FLOPs of ResNet-50/101/152 (bottleneck blocks,
    ``models/resnet.py``). About 8.2 GFLOPs for 50/224 (2 FLOPs per MAC)."""
    blocks = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}[depth]
    s = image_size
    f = _conv_flops(3, 64, 7, s // 2, s // 2)  # stem, stride 2
    s //= 4  # stem stride 2 + maxpool stride 2
    cin = 64
    for stage, n in enumerate(blocks):
        width = 64 * (2 ** stage)
        cout = width * 4
        stride = 1 if stage == 0 else 2
        for b in range(n):
            st = stride if b == 0 else 1
            so = s // st
            f += _conv_flops(cin, width, 1, s, s)  # 1x1 at input res (v1.5: stride on the 3x3)
            f += _conv_flops(width, width, 3, so, so)
            f += _conv_flops(width, cout, 1, so, so)
            if b == 0:
                f += _conv_flops(cin, cout, 1, so, so)  # projection shortcut
            cin, s = cout, so
    f += 2.0 * cin * class_num  # fc
    return f


def vgg_fwd_flops(depth: int = 16, image_size: int = 224,
                  class_num: int = 1000) -> float:
    """Per-image forward FLOPs of VGG-16/19. About 31 GFLOPs for 16/224."""
    cfgs = {16: (2, 2, 3, 3, 3), 19: (2, 2, 4, 4, 4)}[depth]
    chans = (64, 128, 256, 512, 512)
    s, cin, f = image_size, 3, 0.0
    for n, c in zip(cfgs, chans):
        for _ in range(n):
            f += _conv_flops(cin, c, 3, s, s)
            cin = c
        s //= 2
    flat = cin * s * s
    for dims in ((flat, 4096), (4096, 4096), (4096, class_num)):
        f += 2.0 * dims[0] * dims[1]
    return f


def alexnet_fwd_flops(image_size: int = 224, class_num: int = 1000) -> float:
    """Per-image forward FLOPs of AlexNet (``models/convnets.make_alexnet``).
    About 1.4 GFLOPs at 224 (2 FLOPs per MAC; the classic ~720M-MAC
    figure)."""
    s = (image_size + 2 * 2 - 11) // 4 + 1          # conv1 k11 s4 p2
    f = _conv_flops(3, 64, 11, s, s)
    s = (s - 3) // 2 + 1                             # pool 3/2
    f += _conv_flops(64, 192, 5, s, s)
    s = (s - 3) // 2 + 1
    f += _conv_flops(192, 384, 3, s, s)
    f += _conv_flops(384, 256, 3, s, s)
    f += _conv_flops(256, 256, 3, s, s)
    s = (s - 3) // 2 + 1
    for dims in ((256 * s * s, 4096), (4096, 4096), (4096, class_num)):
        f += 2.0 * dims[0] * dims[1]
    return f


# GoogLeNet v1 inception parameter table (models/convnets.make_googlenet):
# (c1, c3r, c3, c5r, c5, proj) per block, grouped by spatial stage.
_GOOGLENET_STAGES = (
    ((64, 96, 128, 16, 32, 32), (128, 128, 192, 32, 96, 64)),
    ((192, 96, 208, 16, 48, 64), (160, 112, 224, 24, 64, 64),
     (128, 128, 256, 24, 64, 64), (112, 144, 288, 32, 64, 64),
     (256, 160, 320, 32, 128, 128)),
    ((256, 160, 320, 32, 128, 128), (384, 192, 384, 48, 128, 128)),
)


def googlenet_fwd_flops(image_size: int = 224, class_num: int = 1000) -> float:
    """Per-image forward FLOPs of GoogLeNet v1. About 3 GFLOPs at 224."""
    s = image_size // 2                              # stem conv7 s2
    f = _conv_flops(3, 64, 7, s, s)
    s = (s + 2 - 3) // 2 + 1                         # pool 3/2 p1
    f += _conv_flops(64, 64, 1, s, s)
    f += _conv_flops(64, 192, 3, s, s)
    s = (s + 2 - 3) // 2 + 1
    cin = 192
    for stage in _GOOGLENET_STAGES:
        for (c1, c3r, c3, c5r, c5, proj) in stage:
            f += _conv_flops(cin, c1, 1, s, s)
            f += _conv_flops(cin, c3r, 1, s, s) + _conv_flops(c3r, c3, 3, s, s)
            f += _conv_flops(cin, c5r, 1, s, s) + _conv_flops(c5r, c5, 5, s, s)
            f += _conv_flops(cin, proj, 1, s, s)
            cin = c1 + c3 + c5 + proj
        s = (s + 2 - 3) // 2 + 1                     # inter-stage pool 3/2 p1
    f += 2.0 * cin * class_num
    return f


def se_resnext_fwd_flops(depth: int = 50, image_size: int = 224,
                         class_num: int = 1000, cardinality: int = 32,
                         reduction: int = 16) -> float:
    """Per-image forward FLOPs of SE-ResNeXt-50/101
    (``models/convnets.make_se_resnext``): the grouped 3x3 divides that
    conv's FLOPs by the cardinality; SE adds two small FCs a block. About
    8.4 GFLOPs for 50/224."""
    stages = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[depth]
    s = image_size // 2                       # stem conv7 s2
    f = _conv_flops(3, 64, 7, s, s)
    s = (s + 2 - 3) // 2 + 1                  # maxpool 3/2 p1
    cin = 64
    for stage, n in enumerate(stages):
        filters = 128 * (2 ** stage)
        cout = filters * 2
        for b in range(n):
            st = 2 if stage > 0 and b == 0 else 1
            so = s // st
            f += _conv_flops(cin, filters, 1, s, s)
            # grouped conv: in-channels per group x total out-channels
            f += _conv_flops(filters // cardinality, filters, 3, so, so)
            f += _conv_flops(filters, cout, 1, so, so)
            se_mid = max(cout // reduction, 4)
            f += 2.0 * (cout * se_mid + se_mid * cout)          # SE FCs
            if cin != cout or st != 1:
                f += _conv_flops(cin, cout, 1, so, so)          # projection
            cin, s = cout, so
    f += 2.0 * cin * class_num
    return f


def convnet_train_flops(fwd_flops_per_image: float, bs: int) -> float:
    """Train = forward + backward, about 3x the forward (the backward does
    about twice the forward's work)."""
    return 3.0 * fwd_flops_per_image * bs


__all__ = ["alexnet_fwd_flops", "bert_train_flops", "convnet_train_flops",
           "deepfm_train_flops", "googlenet_fwd_flops", "mlp_train_flops",
           "resnet_fwd_flops", "se_resnext_fwd_flops", "transformer_train_flops",
           "vgg_fwd_flops"]
