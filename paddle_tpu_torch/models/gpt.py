"""GPT — decoder-only causal LM: the training program and incremental
generation (counterpart of ``paddle_tpu.models.gpt``: ``GPTConfig``,
``base_config``, ``make_model``, ``make_generator``).

``make_model(cfg)`` returns the training program's function, which the
caller wraps in ``build``, as in the JAX package: its layers create their
params through ``LayerHelper`` under the JAX package's names
(``tok/embedding_0/w``, ``gpt/encoder_stack/*``, ``gpt/layer_norm_0/*``,
``lm_head_0/w``), with the dtypes the JAX package's ``Program.init``
gives, so params trained or initialised in ``paddle_tpu`` load through
``params_from_jax`` and a trained ``Trainer.scope.params`` loads straight
into :func:`make_generator`. The compute dtype is the running program's
(``amp_guard`` or the ``default_compute_dtype`` flag). The stacked blocks
run causally through the flash-attention kernels (``use_flash``, the
config default); training differentiates through the forward kernel and
the two backward kernels. At ``dropout > 0`` training takes the dense
attention instead (the kernels have no dropout), with its masks drawn
from the step's rng stream. Under ``framework.sp_mode`` (the Trainer's
``DistStrategy(sequence_parallel=True, sp_impl=...)``) the program runs
the JAX function's sequence-parallel branches: for ring attention it
permutes ids, labels and positions into zigzag order once and keeps its
activations there; for Ulysses it checks that the sequence divides.

``make_generator(cfg, n)`` returns the generation program's function,
which the caller wraps in ``build`` too, as in the JAX package: it
creates every param once through ``LayerHelper`` under the training
program's names, so ``Program.init`` draws them as ``make_model``'s init
does and a trained scope serves directly. It decodes greedily or by beam
search (``beam_size > 1``, the caches grown to ``b·beam`` rows), over a
KV cache in the compute dtype or in int8 with f32 scales
(``kv_cache_dtype="int8"``). In apply mode a call runs the prefill
eagerly, then its decode steps from static buffers through
:mod:`paddle_tpu_torch._captured_decode`: on the card one captured CUDA
graph of a decode step, replayed, with the cache index on the device; on
the CPU the same step body as a plain call.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .. import initializer as init
from .._captured_decode import eager_decode_on
from ..core.dtypes import convert_dtype
from ..core.errors import enforce
from .. import framework
from ..framework import (BuildContext, LayerHelper, cast_compute, compute_dtype,
                         current_context, name_scope)
from ..layers import attention as A
from ..layers import nn as L
from ..layers import stacked as S
from ..layers.beam_search import beam_search, greedy_search
from .lm_head import lm_head_loss

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


def _config(cfg: Union[GPTConfig, dict]) -> GPTConfig:
    """A config, from itself or from its ``dataclasses.asdict`` form (how
    ``factory_spec`` records it)."""
    return cfg if isinstance(cfg, GPTConfig) else GPTConfig(**cfg)


def make_model(cfg: Union[GPTConfig, dict]):
    """The training program's function ``gpt(ids [b, s], labels [b, s]) ->
    {"loss", "token_count"}``, next-token CE over non-pad labels (pad id
    0), for ``build`` (models/gpt.py:65). It carries ``factory_spec``."""
    cfg = _config(cfg)

    def gpt(ids, labels):
        dtype = convert_dtype(cfg.dtype)
        s = ids.shape[1]
        enforce(s <= cfg.max_len, f"seq {s} exceeds max_len {cfg.max_len}")
        sp = framework.sp_config()
        positions = None
        if sp is not None and sp.get("impl", "ring") == "ring":
            from ..parallel.ring_attention import zigzag_order
            n = sp["mesh"].shape[sp["axis"]]
            enforce(s % (2 * n) == 0,
                    f"sequence parallelism needs seq {s} divisible by 2·sp={2 * n}")
            # activations stay in zigzag order end to end (models/gpt.py:68-83):
            # ids, labels and positions permuted once, the ring told so
            positions = zigzag_order(s, n, device=ids.device)
            ids, labels = ids[:, positions], labels[:, positions]
            sp["layout"] = "zigzag"
        elif sp is not None:  # ulysses: natural order, no permutation
            n = sp["mesh"].shape[sp["axis"]]
            enforce(s % n == 0,
                    f"ulysses sequence parallelism needs seq {s} divisible by sp={n}")
        with name_scope("tok"):
            x = L.embedding(ids, size=[cfg.vocab_size, cfg.d_model], dtype=cfg.dtype)
        if positions is None:
            # rows 0..s-1 of the max_len table, which are this table
            x = x + A.positional_encoding(s, cfg.d_model, dtype, device=x.device)[None]
        else:
            pe = A.positional_encoding(cfg.max_len, cfg.d_model, dtype, device=x.device)
            x = x + pe[positions][None]
        with name_scope("gpt"):
            stack = S.encoder_stack_params(cfg.num_layers, cfg.d_model, cfg.d_inner)
            x = S.apply_stacked(x, stack, S.make_encoder_block, num_heads=cfg.num_heads,
                                use_flash=cfg.use_flash, causal=True, remat=cfg.remat,
                                dropout_rate=cfg.dropout)
            x = L.layer_norm(x, begin_norm_axis=2)
        loss, token_count = lm_head_loss(x, labels, cfg.vocab_size, dtype, cfg.fused_ce,
                                         cfg.ce_chunk)
        return {"loss": loss, "token_count": token_count}

    gpt.factory_spec = {"factory": f"{__name__}:make_model",
                        "kwargs": {"cfg": dataclasses.asdict(cfg)}}
    return gpt


class _Weights:
    """What the prefill and the decode steps read, by role: the embedding
    table, each layer's params (its matmul weights in the compute dtype),
    the final norm's params, the head's weight in the dtype of its
    product, and the positional table. ``tensors`` lists them in the order
    of :meth:`_GenerateProgram._sources`."""

    def __init__(self, tensors: List[torch.Tensor], cfg: GPTConfig, device):
        self.tensors = tensors
        it = iter(tensors)
        self.w_emb = next(it)
        self.layers = [{name: next(it) for name in S.STACK_PARAMS}
                       for _ in range(cfg.num_layers)]
        self.ln_scale, self.ln_bias, self.w_head = next(it), next(it), next(it)
        self.pe = A.positional_encoding(cfg.max_len, cfg.d_model, convert_dtype(cfg.dtype),
                                        device=device)

    def fits(self, sources) -> bool:
        """Whether ``sources`` copy into these tensors as they are (the same
        shapes, target dtypes and device)."""
        return len(sources) == len(self.tensors) and all(
            t.shape == s.shape and t.dtype == dt and t.device == s.device
            for t, (s, dt) in zip(self.tensors, sources))


class _GenerateProgram:
    """``make_generator``'s program function (see there). Every call
    creates (init) or fetches (apply) its params through ``LayerHelper``
    once. In apply mode it runs the prefill eagerly, then the decode steps
    from the static buffers of a
    :class:`~paddle_tpu_torch._captured_decode.CapturedDecode` for the
    call's (batch, prompt length): the step captured once as a CUDA graph
    and replayed on the card, called as a plain function on the CPU. At
    most ``max_signatures`` of them are kept, the least recently called
    dropped first with its graph (a ``Predictor`` raises the bound to its
    bucket count). Every one reads one set of static copies of the params
    (:class:`_Weights`), copied from the call's params once a call, with
    the matmul weights cast to the compute dtype in that copy: a call with
    another params dict never reads the last one's, and no replay casts.
    Another device or compute dtype drops the static copies and the
    decodes. Calls are serialised (the buffers are shared). In training
    mode and under :func:`_captured_decode.eager_decode` it runs the plain
    loop (:meth:`_eager`), the JAX program's form, which the captured steps
    are held to. In init mode it creates the params and decodes nothing
    (``Program.init`` returns only the params and state)."""

    # call signatures whose static buffers and graph are kept (each holds
    # its caches: 75.5 MB for GPT-base bf16 at batch 8, 604 MB at beam 4)
    max_signatures = 8

    def __init__(self, cfg: GPTConfig, max_new_tokens: int, beam_size: int, bos_id: int,
                 eos_id: int, length_penalty_alpha: float):
        enforce(cfg.kv_cache_dtype in ("compute", "int8"),
                f"kv_cache_dtype={cfg.kv_cache_dtype!r} (compute|int8)")
        enforce(int(beam_size) >= 1, f"beam_size must be >= 1, got {beam_size}")
        self.cfg = cfg
        self.max_new_tokens = int(max_new_tokens)
        self.beam_size = int(beam_size)
        self.bos_id, self.eos_id = int(bos_id), int(eos_id)
        self.length_penalty_alpha = float(length_penalty_alpha)
        self.__name__ = "generate"
        self.factory_spec = {
            "factory": f"{__name__}:make_generator",
            "kwargs": {"cfg": dataclasses.asdict(cfg), "max_new_tokens": self.max_new_tokens,
                       "beam_size": self.beam_size, "bos_id": self.bos_id,
                       "eos_id": self.eos_id,
                       "length_penalty_alpha": self.length_penalty_alpha}}
        self._decoders: Dict = {}  # (batch, prompt length) -> CapturedDecode, oldest first
        self._weights: Optional[_Weights] = None  # the static copies the decodes read
        self._lock = threading.Lock()

    @property
    def int8_kv(self) -> bool:
        return self.cfg.kv_cache_dtype == "int8"

    # -- the program ------------------------------------------------------------

    def __call__(self, prompt_ids):
        cfg = self.cfg
        b, p = prompt_ids.shape
        enforce(p + self.max_new_tokens <= cfg.max_len,
                f"prompt {p} + max_new {self.max_new_tokens} exceeds max_len {cfg.max_len}")
        ctx = current_context()
        sources = self._sources(compute_dtype())
        if ctx.mode == "init":
            # Program.init keeps the params created above and discards what
            # the program returns, so the startup runs no decode (and no
            # kernel): its cost is the initializers'
            return None
        if ctx.training or eager_decode_on():
            with torch.inference_mode():
                weights = _Weights([t.to(dt) for t, dt in sources], cfg, ctx.device)
                return self._eager(weights, prompt_ids, ctx.compute_dtype)
        return self._captured(sources, prompt_ids, ctx)

    def _sources(self, compute_dtype) -> List[tuple]:
        """Every param, created or fetched once with ``make_model``'s names
        (models/gpt.py:139-156), as ``(tensor, the dtype the steps read it
        in)`` in :class:`_Weights`' order."""
        cfg = self.cfg
        d, V = cfg.d_model, cfg.vocab_size
        with name_scope("tok"):
            w_emb = LayerHelper("embedding").create_parameter(
                "w", (V, d), cfg.dtype, initializer=init.Xavier())
        with name_scope("gpt"):
            stack = S.encoder_stack_params(cfg.num_layers, d, cfg.d_inner)
            ln = LayerHelper("layer_norm")
            ln_scale = ln.create_parameter("scale", (d,), torch.float32,
                                           initializer=init.Constant(1.0))
            ln_bias = ln.create_parameter("bias", (d,), torch.float32,
                                          initializer=init.Constant(0.0))
        w_head = LayerHelper("lm_head").create_parameter(
            "w", (d, V), cfg.dtype, initializer=init.Xavier())
        out = [(w_emb, w_emb.dtype)]
        for i in range(cfg.num_layers):
            for name in S.STACK_PARAMS:
                t = stack[name][i]
                out.append((t, compute_dtype if name in S._MATMUL_WEIGHTS else t.dtype))
        # the final norm's output is f32 (its params are), and jnp.matmul
        # promotes the mixed pair, so a bf16 head weight is read as f32
        out += [(ln_scale, ln_scale.dtype), (ln_bias, ln_bias.dtype),
                (w_head, torch.promote_types(ln_scale.dtype, w_head.dtype))]
        return out

    def _captured(self, sources, prompt_ids, ctx):
        from .._captured_decode import CapturedDecode

        b, p = prompt_ids.shape
        with self._lock, torch.inference_mode():
            if self._weights is None or not self._weights.fits(sources):
                self._decoders.clear()
                self._weights = None  # the old copies go before the new ones come
                self._weights = _Weights(
                    [torch.empty(s.shape, dtype=dt, device=s.device) for s, dt in sources],
                    self.cfg, ctx.device)
            torch._foreach_copy_(self._weights.tensors, [s for s, _ in sources])
            dec = self._decoders.pop((b, p), None)
            if dec is None:
                while len(self._decoders) >= self.max_signatures:
                    del self._decoders[next(iter(self._decoders))]
                dec = CapturedDecode(self, self._weights, b, p, ctx.compute_dtype)
            self._decoders[(b, p)] = dec  # the most recently called last
            return dec.run(prompt_ids)

    # -- the steps, over a set of weights -------------------------------------

    def head(self, w: _Weights, x_last):  # [rows, d] -> log-probs [rows, vocab] f32
        h = S._ln(x_last[:, None, :], w.ln_scale, w.ln_bias)[:, 0]
        # jnp.matmul promotes mixed dtypes (f32 h, bf16 head -> f32);
        # torch.matmul does not, so promote explicitly
        dt = torch.promote_types(h.dtype, w.w_head.dtype)
        logits = torch.matmul(h.to(dt), w.w_head.to(dt)).float()
        return torch.log_softmax(logits, dim=-1)

    def prefill(self, w: _Weights, prompt_ids: torch.Tensor, compute_dtype):
        """Run the prompt causally. Returns (logp0 [b, vocab] f32 — the
        first generated token's distribution, ks, vs — per-layer
        [b, h, p, hd] caches in the compute dtype)."""
        cfg = self.cfg
        p = prompt_ids.shape[1]
        x = cast_compute(compute_dtype, L.take_rows(w.w_emb, prompt_ids) + w.pe[:p][None])
        ks, vs = [], []
        for lp in w.layers:
            x, (k, v) = S.prefill_block(x, lp, cfg.num_heads, cfg.use_flash, compute_dtype)
            ks.append(k)
            vs.append(v)
        return self.head(w, x[:, -1]), ks, vs

    def prefix_caches(self, ks, vs) -> List[tuple]:
        """Per layer, the prompt's cache entries as the decode blocks store
        them: ``(k, v)`` in the compute dtype, or ``(k_q, k_s, v_q, v_s)``
        quantized (:func:`layers.stacked.quantize_kv`) — before the cache
        is grown, so padded positions get zero scales."""
        if not self.int8_kv:
            return [(k, v) for k, v in zip(ks, vs)]
        return [S.quantize_kv(k) + S.quantize_kv(v) for k, v in zip(ks, vs)]

    def decode_step(self, w: _Weights, tokens, caches, index, compute_dtype):
        """The incremental step: ``tokens`` [rows] int32 embedded at
        position ``index`` (a 0-dim integer tensor on the device), the
        blocks writing each layer's ``caches`` at ``index`` in place, the
        head. Returns log-probs [rows, vocab] f32. Reads nothing back to
        the host."""
        cfg = self.cfg
        pe_row = w.pe.index_select(0, index.reshape(1).long())
        xt = cast_compute(compute_dtype,
                          L.take_rows(w.w_emb, tokens)[:, None, :] + pe_row[None])
        block = S.decode_block_q8 if self.int8_kv else S.decode_block
        for lp, cache in zip(w.layers, caches):
            xt = block(xt, lp, *cache, index, cfg.num_heads, compute_dtype)[0]
        return self.head(w, xt[:, 0])

    def _eager(self, w: _Weights, prompt_ids, compute_dtype) -> Dict[str, torch.Tensor]:
        """The decode as a plain loop (``greedy_search``/``beam_search``
        over a step function and a state each step replaces), the form of
        the JAX program: the reference the captured steps are held to."""
        b, p = prompt_ids.shape
        K, new = self.beam_size, self.max_new_tokens
        total = p + new
        dev = prompt_ids.device
        logp0, ks, vs = self.prefill(w, prompt_ids, compute_dtype)

        def grow(a):  # [b, h, p, x] -> [b·K, h, total, x], zeros beyond p
            out = a.new_zeros((a.shape[0] * K, a.shape[1], total, a.shape[3]))
            out[:, :, :p] = a.repeat_interleave(K, dim=0) if K > 1 else a
            return out

        caches = [tuple(grow(a) for a in c) for c in self.prefix_caches(ks, vs)]
        logp0 = logp0.repeat_interleave(K, dim=0) if K > 1 else logp0
        state0 = {"caches": caches, "first": True,
                  "index": torch.full((), p, dtype=torch.int32, device=dev)}

        def step_fn(tokens, state):
            # the first step consumes the prefill's distribution without
            # writing a token; the index advances only once a generated
            # token is cached (position p holds token 1)
            if state["first"]:
                return logp0, dict(state, first=False)
            logp = self.decode_step(w, tokens, state["caches"], state["index"], compute_dtype)
            return logp, dict(state, index=state["index"] + 1)

        if K > 1:
            seqs, scores = beam_search(
                step_fn, state0, b, K, new, bos_id=self.bos_id, eos_id=self.eos_id,
                length_penalty_alpha=self.length_penalty_alpha, device=dev)
            return {"ids": seqs, "scores": scores}
        return {"ids": greedy_search(step_fn, state0, b, new, bos_id=self.bos_id,
                                     eos_id=self.eos_id, device=dev)}

    def weights(self, params: Dict[str, torch.Tensor], device=None) -> _Weights:
        """The weights a call on ``params`` reads, cast as the running
        compute dtype (:func:`framework.compute_dtype`) asks, outside a
        program run: for timing or checking :meth:`prefill` and
        :meth:`decode_step` alone."""
        dev = framework._first_device(params) if device is None else torch.device(device)
        ctx = BuildContext("apply", params, {}, None, False, {}, dev, compute_dtype())
        with framework._use_ctx(ctx), torch.inference_mode():
            return _Weights([t.to(dt) for t, dt in self._sources(ctx.compute_dtype)],
                            self.cfg, dev)


def make_generator(cfg: Union[GPTConfig, dict], max_new_tokens: int, beam_size: int = 1,
                   bos_id: int = 1, eos_id: int = 2, length_penalty_alpha: float = 0.0):
    """Incremental generation program over a KV cache, for ``build``
    (models/gpt.py:118): ``generate(prompt_ids [b, p]) -> {"ids": [b,
    max_new_tokens] int32}`` (greedy) or ``{"ids": [b, beam,
    max_new_tokens] int32, "scores": [b, beam] f32}`` (beam search, best
    first, with the GNMT length penalty at ``length_penalty_alpha > 0``),
    over a KV cache in the compute dtype or in int8 with f32 scales
    (``cfg.kv_cache_dtype="int8"``). Its params are ``make_model``'s,
    under the same names, so a trained ``Trainer.scope.params`` serves
    directly; ``Program.init`` draws them as the training program's init
    does. The compute dtype is the running program's (``amp_guard`` or the
    ``default_compute_dtype`` flag). On the card the decode steps replay
    one captured CUDA graph of a step, the cache index on the device
    (:class:`_GenerateProgram`). It carries ``factory_spec``."""
    return _GenerateProgram(_config(cfg), max_new_tokens, beam_size, bos_id, eos_id,
                            length_penalty_alpha)


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


__all__ = ["GPTConfig", "base_config", "make_generator", "make_model", "params_from_jax"]
