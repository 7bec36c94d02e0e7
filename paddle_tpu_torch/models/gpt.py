"""GPT — decoder-only causal LM: the training program and incremental
generation (counterpart of ``paddle_tpu.models.gpt``: ``GPTConfig``,
``base_config``, ``make_model``, ``make_generator``).

Both programs are ``nn.Module``s that own their parameters under the JAX
package's names (:data:`PARAM_TABLE`), so params trained or initialised
in ``paddle_tpu`` load through :func:`params_from_jax`, params trained
by :func:`make_model` load straight into :func:`make_generator`, and the
port produces the JAX package's losses and token ids. Both run the
stacked blocks causally through the flash-attention kernels
(``use_flash``, the config default); training differentiates through
the forward kernel and the two backward kernels. At ``dropout > 0``
training takes the dense attention instead (the kernels have no
dropout), with its masks drawn from the rng that ``Trainer`` gives the
step (``framework.run_context``). Beam search and the int8 KV cache
come in later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
from torch import nn

from .. import initializer as init
from ..core.dtypes import convert_dtype, dtype_name
from ..core.errors import EnforceError, NotFoundError, NotYetPorted, enforce
from ..core.place import default_device
from .. import framework
from ..framework import cast_compute
from ..layers import attention as A
from ..layers import nn as L
from ..layers import stacked as S
from ..layers.beam_search import greedy_search
from .lm_head import lm_head_loss

BUILDER = "models.gpt.make_generator"


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 32000
    max_len: int = 1024
    d_model: int = 768
    d_inner: int = 3072
    num_heads: int = 12
    num_layers: int = 12
    use_flash: bool = True
    # training-only fields, read by the training program (make_model);
    # the generator ignores them as the JAX package's does, so a config
    # trained with dropout or remat still serves
    fused_ce: bool = True
    ce_chunk: int = 4096
    remat: bool = False
    dropout: float = 0.0
    dtype: str = "float32"
    kv_cache_dtype: str = "compute"


def base_config(**kw) -> GPTConfig:
    return GPTConfig(**kw)


# JAX param name -> (module attribute path, initializer); the one table
# between the JAX package's flat param dict and this module
PARAM_TABLE = {
    "tok/embedding_0/w": ("w_emb", init.Xavier()),
    **{f"gpt/encoder_stack/{k}": (f"stack.{a}", i)
       for k, (a, i) in S.STACK_PARAMS.items()},
    "gpt/layer_norm_0/scale": ("ln_scale", init.Constant(1.0)),
    "gpt/layer_norm_0/bias": ("ln_bias", init.Constant(0.0)),
    "lm_head_0/w": ("w_head", init.Xavier()),
}


class _JaxNamedParams(nn.Module):
    """What both GPT programs do with their params under the JAX names
    of :data:`PARAM_TABLE`."""

    @property
    def device(self) -> torch.device:
        return self.w_emb.device

    def flat_params(self) -> Dict[str, torch.Tensor]:
        """{JAX param name: tensor} (the tensors themselves, not copies)."""
        return {name: self.get_parameter(attr)
                for name, (attr, _) in PARAM_TABLE.items()}

    def load_params(self, flat: Dict[str, torch.Tensor]):
        """Take every parameter from ``flat`` (JAX names; dtypes kept as
        given, copied to this module's device, so training in place never
        writes to the caller's tensors). Missing, extra or misshapen
        entries raise."""
        extra = sorted(set(flat) - set(PARAM_TABLE))
        enforce(not extra, f"load_params: not params of this program: {extra}")
        for name, (attr, _) in PARAM_TABLE.items():
            if name not in flat:
                raise NotFoundError(f"load_params: missing param {name!r}")
            p = self.get_parameter(attr)
            t = torch.as_tensor(flat[name])
            if tuple(t.shape) != tuple(p.shape):
                raise EnforceError(f"load_params: {name} has shape "
                                   f"{tuple(t.shape)}, expected {tuple(p.shape)}")
            p.data = t.to(self.device, copy=True)
        return self

    def init_params(self, seed: int = 0):
        """Fresh init through the port's initializers: each param draws
        from its own CPU generator seeded from (seed, its name), so the
        values do not depend on the device or on the order of params."""
        for name, (attr, initializer) in PARAM_TABLE.items():
            p = self.get_parameter(attr)
            g = init.param_generator(seed, name)
            p.data = initializer(g, tuple(p.shape), p.dtype).to(self.device)
        return self


class GPTModel(_JaxNamedParams):
    """``make_model``'s program: ``forward(ids [b, s], labels [b, s]) ->
    {"loss", "token_count"}``, the next-token CE over labels that are not
    the pad id 0. Parameter dtypes follow the JAX package's
    ``Program.init``: the embedding and ``lm_head_0/w`` in ``cfg.dtype``,
    the stack in f32, and ``gpt/layer_norm_0`` in the dtype of the
    activations it normalises (the JAX layer creates it in its input's
    dtype), which is the wider of the compute dtype and ``cfg.dtype``."""

    def __init__(self, cfg: GPTConfig, compute_dtype="float32", device=None):
        super().__init__()
        dev = default_device(device, "make_model")
        self.cfg = cfg
        self.compute_dtype = convert_dtype(compute_dtype)
        dt = convert_dtype(cfg.dtype)
        V, d = cfg.vocab_size, cfg.d_model

        def param(shape, dtype):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=dev))

        self.w_emb = param((V, d), dt)
        self.stack = S.EncoderStack(cfg.num_layers, d, cfg.d_inner, device=dev,
                                    trainable=True)
        ln_dtype = torch.promote_types(self.compute_dtype, dt)
        self.ln_scale = param((d,), ln_dtype)
        self.ln_bias = param((d,), ln_dtype)
        self.w_head = param((d, V), dt)
        self.register_buffer(
            "pe", A.positional_encoding(cfg.max_len, d, dt, device=dev),
            persistent=False)

    def forward(self, ids, labels) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        ids = torch.as_tensor(ids, device=self.device)
        labels = torch.as_tensor(labels, device=self.device)
        s = ids.shape[1]
        enforce(s <= cfg.max_len, f"seq {s} exceeds max_len {cfg.max_len}")
        x = L._embedding_lookup(ids, self.w_emb, self.compute_dtype) + self.pe[:s][None]
        x = S.apply_stacked(x, self.stack.params(), S.make_encoder_block,
                            num_heads=cfg.num_heads, use_flash=cfg.use_flash,
                            causal=True, remat=cfg.remat,
                            dropout_rate=cfg.dropout,
                            compute_dtype=self.compute_dtype,
                            training=self.training)
        x = L._layer_norm_given(x, self.ln_scale, self.ln_bias, begin_norm_axis=2)
        loss, token_count = lm_head_loss(x, labels, self.w_head, cfg.fused_ce,
                                         cfg.ce_chunk)
        return {"loss": loss, "token_count": token_count}


def make_model(cfg: GPTConfig, compute_dtype="float32", device=None) -> GPTModel:
    """The training program: ``(ids [b, s], labels [b, s]) -> {"loss",
    "token_count"}``, next-token CE over non-pad labels (pad id 0).

    ``compute_dtype`` replaces the JAX package's ``default_compute_dtype``
    flag. Parameters are allocated on ``device`` (the CUDA card by
    default) uninitialised: call ``init_params`` or ``load_params``, or
    let ``Trainer.startup`` do it."""
    return GPTModel(cfg, compute_dtype=compute_dtype, device=device)


class GPTGenerator(_JaxNamedParams):
    """``make_generator``'s program: ``forward(prompt_ids [b, p] int32)
    -> {"ids": [b, max_new_tokens] int32}`` (greedy)."""

    def __init__(self, cfg: GPTConfig, max_new_tokens: int, bos_id: int = 1,
                 eos_id: int = 2, compute_dtype="float32", device=None):
        super().__init__()
        if cfg.kv_cache_dtype == "int8":
            raise NotYetPorted("GPT generator with kv_cache_dtype='int8' "
                               "(the int8 KV cache, ROADMAP)")
        enforce(cfg.kv_cache_dtype == "compute",
                f"kv_cache_dtype={cfg.kv_cache_dtype!r} (compute|int8)")
        dev = default_device(device, "make_generator")
        self.cfg = cfg
        self.max_new_tokens = int(max_new_tokens)
        self.bos_id, self.eos_id = int(bos_id), int(eos_id)
        self.compute_dtype = convert_dtype(compute_dtype)
        dt = convert_dtype(cfg.dtype)
        V, d = cfg.vocab_size, cfg.d_model

        def param(shape, dtype):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=dev),
                                requires_grad=False)

        self.w_emb = param((V, d), dt)
        self.stack = S.EncoderStack(cfg.num_layers, d, cfg.d_inner, device=dev)
        self.ln_scale = param((d,), torch.float32)
        self.ln_bias = param((d,), torch.float32)
        self.w_head = param((d, V), dt)
        self.register_buffer(
            "pe", A.positional_encoding(cfg.max_len, d, dt, device=dev),
            persistent=False)

    def spec(self) -> Dict:
        """How to rebuild this program: the builder and its arguments
        (what ``io.save_inference_model`` records in meta.json)."""
        return {"builder": BUILDER, "config": dataclasses.asdict(self.cfg),
                "max_new_tokens": self.max_new_tokens, "bos_id": self.bos_id,
                "eos_id": self.eos_id,
                "compute_dtype": dtype_name(self.compute_dtype)}

    # -- the program ----------------------------------------------------------

    def _head(self, x_last):  # [rows, d] -> log-probs [rows, vocab] f32
        h = S._ln(x_last[:, None, :], self.ln_scale, self.ln_bias)[:, 0]
        # jnp.matmul promotes mixed dtypes (f32 h, bf16 head -> f32);
        # torch.matmul does not, so promote explicitly
        dt = torch.promote_types(h.dtype, self.w_head.dtype)
        logits = torch.matmul(h.to(dt), self.w_head.to(dt)).float()
        return torch.log_softmax(logits, dim=-1)

    def prefill(self, prompt_ids: torch.Tensor, layers=None):
        """Run the prompt causally. Returns (logp0 [b, vocab] f32 — the
        first generated token's distribution, ks, vs — per-layer
        [b, h, p, hd] caches in the compute dtype)."""
        cfg = self.cfg
        p = prompt_ids.shape[1]
        if layers is None:
            layers = [self.stack.layer(i, self.compute_dtype)
                      for i in range(cfg.num_layers)]
        x = cast_compute(self.compute_dtype,
                         L.take_rows(self.w_emb, prompt_ids) + self.pe[:p][None])
        ks, vs = [], []
        for lp in layers:
            x, (k, v) = S.prefill_block(x, lp, cfg.num_heads, cfg.use_flash,
                                        self.compute_dtype)
            ks.append(k)
            vs.append(v)
        return self._head(x[:, -1]), ks, vs

    def forward(self, prompt_ids) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        prompt_ids = torch.as_tensor(prompt_ids, device=self.device)
        b, p = prompt_ids.shape
        total = p + self.max_new_tokens
        enforce(total <= cfg.max_len,
                f"prompt {p} + max_new {self.max_new_tokens} exceeds max_len "
                f"{cfg.max_len}")
        with torch.inference_mode():
            layers = [self.stack.layer(i, self.compute_dtype)
                      for i in range(cfg.num_layers)]
            logp0, ks, vs = self.prefill(prompt_ids, layers)

            def grow(a):  # [b, h, p, hd] -> [b, h, total, hd]
                out = a.new_zeros(a.shape[:2] + (total, a.shape[3]))
                out[:, :, :p] = a
                return out

            state0 = {"k": [grow(a) for a in ks], "v": [grow(a) for a in vs],
                      "index": p, "first": True}

            def step_fn(tokens, state):
                # the first step consumes the prefill's distribution
                # without writing a token; the index advances only once a
                # generated token is cached (position p holds token 1)
                if state["first"]:
                    return logp0, dict(state, first=False)
                index = state["index"]
                xt = cast_compute(self.compute_dtype,
                                  L.take_rows(self.w_emb, tokens)[:, None, :]
                                  + self.pe[index][None, None])
                for i, lp in enumerate(layers):
                    xt, _, _ = S.decode_block(xt, lp, state["k"][i],
                                              state["v"][i], index,
                                              cfg.num_heads, self.compute_dtype)
                return self._head(xt[:, 0]), dict(state, index=index + 1)

            ids = greedy_search(step_fn, state0, b, self.max_new_tokens,
                                bos_id=self.bos_id, eos_id=self.eos_id,
                                device=self.device)
        return {"ids": ids}


def make_generator(cfg: GPTConfig, max_new_tokens: int, beam_size: int = 1,
                   bos_id: int = 1, eos_id: int = 2,
                   compute_dtype="float32", device=None) -> GPTGenerator:
    """Incremental generation program over a KV cache:
    ``(prompt_ids [b, p]) -> {"ids": [b, max_new_tokens]}`` (greedy).

    ``compute_dtype`` replaces the JAX package's ``default_compute_dtype``
    flag (its default is float32 there too). Parameters are allocated on
    ``device`` (the CUDA card by default) uninitialised: call
    ``init_params`` or ``load_params``."""
    if beam_size > 1:
        raise NotYetPorted("make_generator(beam_size > 1): beam search "
                           "comes with a later slice")
    return GPTGenerator(cfg, max_new_tokens, bos_id=bos_id, eos_id=eos_id,
                        compute_dtype=compute_dtype, device=device)


def params_from_jax(flat: Dict[str, np.ndarray], device=None,
                    dtype=None) -> Dict[str, torch.Tensor]:
    """The JAX package's flat params (numpy arrays, e.g. from
    ``jax.tree.map(np.asarray, params)``) as torch tensors on ``device``
    (the CUDA card by default), through :func:`framework.params_from_jax`.
    ``dtype`` casts every floating param; None keeps each one's dtype."""
    out = framework.params_from_jax(flat, device=device)
    dt = convert_dtype(dtype)
    if dt is not None:
        out = {k: t.to(dt) if t.is_floating_point() else t for k, t in out.items()}
    return out


def build_from_spec(spec: Dict, device=None) -> GPTGenerator:
    """Rebuild a generator from :meth:`GPTGenerator.spec` (io's loader)."""
    return make_generator(GPTConfig(**spec["config"]), spec["max_new_tokens"],
                          bos_id=spec["bos_id"], eos_id=spec["eos_id"],
                          compute_dtype=spec["compute_dtype"], device=device)


__all__ = ["GPTConfig", "GPTGenerator", "GPTModel", "PARAM_TABLE",
           "base_config", "make_generator", "make_model", "params_from_jax"]
