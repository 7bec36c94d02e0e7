"""The MoE transformer LM (counterpart of ``paddle_tpu.models.
moe_transformer``): a GShard/Switch-style causal model in which every
``moe_every``-th block's FFN is a top-k-routed expert bank
(``parallel.moe.moe``), sharded over the mesh's ``ep`` axis when the
model is built against a mesh with one (``make_model(cfg, mesh)``; None
runs the dense path). The blocks' load-balance losses are summed into the
objective. Attention is causal and takes the flash kernels where
``use_flash`` is set and dropout is a no-op.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import layers as L
from ..core.dtypes import convert_dtype
from ..core.errors import enforce
from ..framework import name_scope
from ..layers import attention as A
from ..parallel.moe import moe
from .lm_head import lm_head_loss


@dataclasses.dataclass
class MoeTransformerConfig:
    vocab_size: int = 32000
    max_len: int = 1024
    d_model: int = 512
    d_inner: int = 2048          # the dense blocks' FFN width
    d_expert: int = 1024         # each expert's FFN width
    num_heads: int = 8
    num_layers: int = 6
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_every: int = 2           # every Nth block's FFN is MoE
    aux_weight: float = 0.01     # the load-balance loss' weight
    dropout: float = 0.0
    use_flash: bool = False
    fused_ce: bool = True
    ce_chunk: int = 4096
    dtype: str = "float32"


def base_config(**kw) -> MoeTransformerConfig:
    return MoeTransformerConfig(**kw)


def make_model(cfg: MoeTransformerConfig, mesh=None):
    """The program function ``moe_lm(ids [b, s], labels [b, s]) -> {"loss",
    "ce_loss", "aux_loss"}`` (moe_transformer.py:51): next-token CE over
    non-pad labels plus ``aux_weight`` times the summed load-balance
    losses, with the JAX program's names (``tok/embedding_0``,
    ``blocks/...``, ``blocks/moe_0/router_w`` ...)."""

    def moe_lm(ids, labels):
        dtype = convert_dtype(cfg.dtype)
        s = ids.shape[1]
        enforce(s <= cfg.max_len, f"seq {s} exceeds max_len {cfg.max_len}")
        with name_scope("tok"):
            x = L.embedding(ids, size=[cfg.vocab_size, cfg.d_model], dtype=cfg.dtype)
        pe = A.positional_encoding(cfg.max_len, cfg.d_model, dtype, device=x.device)
        x = x + pe[:s][None]
        x = L.dropout(x, cfg.dropout, dropout_implementation="upscale_in_train")

        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        with name_scope("blocks"):
            for i in range(cfg.num_layers):
                h = L.layer_norm(x, begin_norm_axis=2)
                h = A.multi_head_attention(h, num_heads=cfg.num_heads, causal=True,
                                           dropout_rate=cfg.dropout,
                                           use_flash=cfg.use_flash)
                x = x + L.dropout(h, cfg.dropout, dropout_implementation="upscale_in_train")
                h = L.layer_norm(x, begin_norm_axis=2)
                if cfg.moe_every and (i + 1) % cfg.moe_every == 0:
                    h, aux = moe(h, num_experts=cfg.num_experts, d_ff=cfg.d_expert,
                                 top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                                 mesh=mesh)
                    aux_total = aux_total + aux
                else:
                    h = A.ffn(h, cfg.d_inner, dropout_rate=cfg.dropout)
                x = x + L.dropout(h, cfg.dropout, dropout_implementation="upscale_in_train")
            x = L.layer_norm(x, begin_norm_axis=2)

        ce_loss, _ = lm_head_loss(x, labels, cfg.vocab_size, dtype, cfg.fused_ce,
                                  cfg.ce_chunk)
        loss = ce_loss + cfg.aux_weight * aux_total
        return {"loss": loss, "ce_loss": ce_loss, "aux_loss": aux_total}

    return moe_lm


__all__ = ["MoeTransformerConfig", "base_config", "make_model"]
