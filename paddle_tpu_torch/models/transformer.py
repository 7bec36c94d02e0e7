"""Transformer, encoder-decoder, WMT en-de "base" (counterpart of
``paddle_tpu.models.transformer``): ``TransformerConfig``,
``base_config``, the pre-LN ``encoder_layer`` and ``decoder_layer``,
``encode``, ``decode_hidden``, ``decode``, the training program
``make_model`` and the incremental decoder ``make_decoder`` (greedy, or
beam search at ``beam_size > 1``).

Both programs are ``build`` functions whose layers create their params
through ``LayerHelper`` under the JAX package's names, so
``params_from_jax`` carries a JAX-initialised model across, and a
decoder serves the params of a trained ``make_model`` (the names are
shared). Attention takes the flash kernels where ``use_flash`` is set
and dropout is a no-op (the routing rule of ``layers/attention.py``):
the encoder's self-attention with the padding key bias and the
decoder's causal self-attention, at eval and at dropout 0. The
decoder's cross-attention passes no ``use_flash`` and is dense, as in
the JAX package (transformer.py:94-96). Both programs carry
``factory_spec``, by which an inference artifact rebuilds them.

Not carried yet, raising :class:`NotYetPorted`: ``stacked=True`` (the
stacked encoder and decoder blocks), ROADMAP queue 1 item 17. The
decoder's loop runs eagerly (its capture as a CUDA graph is item 17's
too).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from .. import initializer as init
from .. import layers as L
from ..core.dtypes import convert_dtype
from ..core.errors import NotYetPorted
from ..framework import LayerHelper, maybe_remat, name_scope, reuse_names
from ..layers import attention as A
from ..layers.beam_search import beam_search, greedy_search
from ..layers.nn import _scalar_like
from ..ops.fused_ce import chunked_softmax_cross_entropy


@dataclasses.dataclass
class TransformerConfig:
    src_vocab: int = 32000
    trg_vocab: int = 32000
    max_len: int = 256
    d_model: int = 512
    d_inner: int = 2048
    num_heads: int = 8
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    dropout: float = 0.1
    label_smooth_eps: float = 0.1
    use_flash: bool = False
    # one [d, 3, d] (self) / [d, 2, d] (cross K/V) projection per attention
    fuse_qkv: bool = False
    # the chunked logits-free CE (ops/fused_ce.py); chunk = vocab tile width
    fused_ce: bool = False
    ce_chunk: int = 4096
    # per-layer recompute in the backward (framework.maybe_remat); False
    # still honours the ambient framework.remat_mode
    remat: bool = False
    # the stacked-block representation (not carried yet: item 17)
    stacked: bool = False
    dtype: str = "float32"


def base_config(**kw) -> TransformerConfig:
    return TransformerConfig(**kw)


def _config(cfg: Union[TransformerConfig, dict]) -> TransformerConfig:
    """A config, from itself or from its ``dataclasses.asdict`` form (how
    ``factory_spec`` records it)."""
    cfg = cfg if isinstance(cfg, TransformerConfig) else TransformerConfig(**cfg)
    if cfg.stacked:
        raise NotYetPorted("TransformerConfig(stacked=True): the stacked encoder "
                           "and decoder blocks come with ROADMAP queue 1, item 17")
    return cfg


def _embed(ids, vocab, d_model, dtype, scope_name):
    with name_scope(scope_name):
        emb = L.embedding(ids, size=[vocab, d_model], dtype=dtype, param_attr=None)
    return emb * _scalar_like(emb, d_model ** 0.5)


def _drop(x, cfg: TransformerConfig):
    return L.dropout(x, cfg.dropout, dropout_implementation="upscale_in_train")


def encoder_layer(x, cfg: TransformerConfig, mask):
    h = L.layer_norm(x, begin_norm_axis=2)
    h = A.multi_head_attention(h, num_heads=cfg.num_heads, attn_mask=mask,
                               dropout_rate=cfg.dropout, use_flash=cfg.use_flash,
                               fuse_qkv=cfg.fuse_qkv)
    x = x + _drop(h, cfg)
    h = L.layer_norm(x, begin_norm_axis=2)
    h = A.ffn(h, cfg.d_inner, dropout_rate=cfg.dropout)
    return x + _drop(h, cfg)


def decoder_layer(x, enc_out, cfg: TransformerConfig, self_mask, cross_mask,
                  cache: Optional[dict] = None):
    h = L.layer_norm(x, begin_norm_axis=2)
    if cache is not None:
        h, cache = A.multi_head_attention(h, num_heads=cfg.num_heads, causal=False,
                                          dropout_rate=0.0, cache=cache,
                                          fuse_qkv=cfg.fuse_qkv)
    else:
        h = A.multi_head_attention(h, num_heads=cfg.num_heads, causal=True,
                                   attn_mask=self_mask, dropout_rate=cfg.dropout,
                                   use_flash=cfg.use_flash, fuse_qkv=cfg.fuse_qkv)
    x = x + _drop(h, cfg)
    h = L.layer_norm(x, begin_norm_axis=2)
    # no use_flash: the cross-attention is dense, as in the JAX package
    h = A.multi_head_attention(h, keys=enc_out, num_heads=cfg.num_heads,
                               attn_mask=cross_mask, dropout_rate=cfg.dropout,
                               fuse_qkv=cfg.fuse_qkv)
    x = x + _drop(h, cfg)
    h = L.layer_norm(x, begin_norm_axis=2)
    h = A.ffn(h, cfg.d_inner, dropout_rate=cfg.dropout)
    x = x + _drop(h, cfg)
    return (x, cache) if cache is not None else x


def encode(src_ids, cfg: TransformerConfig):
    """(encoder output [b, s, d], the padding mask [b, 1, 1, s])."""
    cfg = _config(cfg)
    dtype = convert_dtype(cfg.dtype)
    x = _embed(src_ids, cfg.src_vocab, cfg.d_model, dtype, "src")
    x = x + A.positional_encoding(src_ids.shape[1], cfg.d_model, dtype,
                                  device=x.device)[None]
    x = _drop(x, cfg)
    mask = A.padding_mask(src_ids)
    with name_scope("encoder"):
        for _ in range(cfg.num_encoder_layers):
            x = maybe_remat(lambda a, m: encoder_layer(a, cfg, m),
                            enabled=cfg.remat or None)(x, mask)
        x = L.layer_norm(x, begin_norm_axis=2)
    return x, mask


def _logits_weight(cfg: TransformerConfig, dtype):
    helper = LayerHelper("logits_proj")
    return helper.create_parameter("w", (cfg.d_model, cfg.trg_vocab), dtype,
                                   initializer=init.Xavier())


def decode_hidden(trg_ids, enc_out, cross_mask, cfg: TransformerConfig):
    """The decoder stack up to (hidden states, the vocab projection
    weight), so the loss can run the projection chunked (``fused_ce``)."""
    dtype = convert_dtype(cfg.dtype)
    x = _embed(trg_ids, cfg.trg_vocab, cfg.d_model, dtype, "trg")
    x = x + A.positional_encoding(trg_ids.shape[1], cfg.d_model, dtype,
                                  device=x.device)[None]
    x = _drop(x, cfg)
    with name_scope("decoder"):
        for _ in range(cfg.num_decoder_layers):
            x = maybe_remat(lambda a, e, cm: decoder_layer(a, e, cfg, None, cm),
                            enabled=cfg.remat or None)(x, enc_out, cross_mask)
        x = L.layer_norm(x, begin_norm_axis=2)
    return x, _logits_weight(cfg, dtype)


def decode(trg_ids, enc_out, cross_mask, cfg: TransformerConfig):
    x, w = decode_hidden(trg_ids, enc_out, cross_mask, cfg)
    return L.matmul(x, w)


def make_model(cfg: Union[TransformerConfig, dict]):
    """The training program ``transformer(src_ids [b, s], trg_ids [b, t],
    labels [b, t]) -> {"loss", "token_count"}`` (and ``"logits"`` on the
    dense branch): the label-smoothed CE over non-pad target tokens (pad
    id 0), ``(1 − eps)·nll − eps·mean(logp)``. ``fused_ce`` runs the
    vocab projection and the CE chunked (``ops/fused_ce.py``). It carries
    ``factory_spec``."""
    cfg = _config(cfg)

    def transformer(src_ids, trg_ids, labels):
        enc_out, src_mask = encode(src_ids, cfg)
        eps = cfg.label_smooth_eps
        lab = labels.long()
        nonpad = (labels != 0).float()
        token_count = nonpad.sum().clamp_min(1.0)
        if cfg.fused_ce:
            x, w = decode_hidden(trg_ids, enc_out, src_mask, cfg)
            b, t, d = x.shape
            ce = chunked_softmax_cross_entropy(
                x.reshape(b * t, d), w, None, lab.reshape(-1), eps,
                cfg.ce_chunk).reshape(b, t)
            loss = (ce * nonpad).sum() / token_count
            return {"loss": loss, "token_count": token_count}
        logits = decode(trg_ids, enc_out, src_mask, cfg)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
        ce = (1.0 - eps) * nll - eps * logp.mean(dim=-1)
        loss = (ce * nonpad).sum() / token_count
        return {"loss": loss, "logits": logits, "token_count": token_count}

    transformer.factory_spec = {"factory": f"{__name__}:make_model",
                                "kwargs": {"cfg": dataclasses.asdict(cfg)}}
    return transformer


def make_decoder(cfg: Union[TransformerConfig, dict], max_len: int,
                 beam_size: int = 1, bos_id: int = 1, eos_id: int = 2,
                 length_penalty_alpha: float = 0.0):
    """The incremental decoding program ``decode_program(src_ids [b, s])
    -> {"ids": [b, max_len] int32}`` (greedy) or ``{"ids": [b, beam,
    max_len] int32, "scores": [b, beam] f32}`` (beam search, best first):
    the encoder once, then one token a step through the decoder with its
    self-attention K/V cached ([b·beam, h, max_len, hd] a layer, in
    ``cfg.dtype``; beam search repeats the encoder's output and mask per
    beam and reorders the caches by the surviving beams, their int index
    passing through). Its params are ``make_model``'s, under the same
    names, so a trained scope serves directly. It carries
    ``factory_spec``."""
    cfg = _config(cfg)

    def decode_program(src_ids):
        dtype = convert_dtype(cfg.dtype)
        b = src_ids.shape[0]
        K = beam_size
        rows = b * K
        dev = src_ids.device
        enc_out, src_mask = encode(src_ids, cfg)
        if K > 1:
            enc_out = enc_out.repeat_interleave(K, dim=0)
            src_mask = src_mask.repeat_interleave(K, dim=0)
        head_dim = cfg.d_model // cfg.num_heads
        caches = [
            {"k": torch.zeros((rows, cfg.num_heads, max_len, head_dim), dtype=dtype,
                              device=dev),
             "v": torch.zeros((rows, cfg.num_heads, max_len, head_dim), dtype=dtype,
                              device=dev),
             "index": 0}
            for _ in range(cfg.num_decoder_layers)]
        pe = A.positional_encoding(max_len, cfg.d_model, dtype, device=dev)

        def run_step(tokens, caches):
            with reuse_names():
                pos = caches[0]["index"]
                with name_scope("trg"):
                    x = L.embedding(tokens, size=[cfg.trg_vocab, cfg.d_model],
                                    dtype=cfg.dtype)
                    x = x * _scalar_like(x, cfg.d_model ** 0.5)
                x = x[:, None, :] + pe[pos:pos + 1][None]
                new_caches = []
                with name_scope("decoder"):
                    for li in range(cfg.num_decoder_layers):
                        x, c = decoder_layer(x, enc_out, cfg, None, src_mask,
                                             cache=caches[li])
                        new_caches.append(c)
                    x = L.layer_norm(x, begin_norm_axis=2)
                logits = L.matmul(x[:, 0], _logits_weight(cfg, dtype))
                return torch.log_softmax(logits.float(), dim=-1), new_caches

        # one step before the loop, as the JAX package runs it (in init mode
        # it creates the params); it writes position 0, which the loop's
        # first step writes again with the same values
        run_step(torch.full((rows,), bos_id, dtype=torch.int32, device=dev), caches)
        if K > 1:
            seqs, scores = beam_search(run_step, caches, b, K, max_len, bos_id=bos_id,
                                       eos_id=eos_id,
                                       length_penalty_alpha=length_penalty_alpha,
                                       device=dev)
            return {"ids": seqs, "scores": scores}
        seqs = greedy_search(run_step, caches, rows, max_len, bos_id=bos_id,
                             eos_id=eos_id, device=dev)
        return {"ids": seqs}

    decode_program.factory_spec = {
        "factory": f"{__name__}:make_decoder",
        "kwargs": {"cfg": dataclasses.asdict(cfg), "max_len": max_len,
                   "beam_size": beam_size, "bos_id": bos_id, "eos_id": eos_id,
                   "length_penalty_alpha": length_penalty_alpha}}
    return decode_program


__all__ = ["TransformerConfig", "base_config", "decode", "decode_hidden",
           "decoder_layer", "encode", "encoder_layer", "make_decoder", "make_model"]
