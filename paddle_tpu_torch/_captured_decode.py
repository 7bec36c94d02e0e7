"""A decoder's incremental steps as one captured CUDA graph, replayed.

The JAX package decodes in one compiled program: ``greedy_search`` or
``beam_search`` is a ``lax.scan`` over a static ``max_len`` under ``jit``,
the cache index is a device ``int32`` (paddle_tpu/models/gpt.py:118-263,
paddle_tpu/models/transformer.py:164-233). Here one CUDA graph holds ONE
incremental step and a call replays it, so the host launches one graph
a token instead of hundreds of kernels.

:class:`StaticDecode` is what every decoder shares. For one call
signature it owns fixed tensors: each layer's caches, the tokens,
finished flags, beam scores and sequences, the cache index and the step
counter (0-dim ``int32`` tensors on the card); the selection of a step
over them (greedy or beam, with the beam gathers and the sequences'
write, both counters advanced on the card); the capture and the replay.
Its two decoders:

- :class:`CapturedDecode`, a GPT generator's (rows = batch · beam, prompt
  length, ``max_new_tokens``, beam, ``kv_cache_dtype``). Its caches are
  ``k``, ``v`` in the compute dtype, or int8 ``k_q``, ``v_q`` with f32
  scales. The weights it reads are the generator's
  (``GPTGenerator._decode_weights``, copied from the params once a call).
  A call runs the prefill eagerly (the flash forward, one launch a layer)
  and writes the prompt's cache entries (repeated per beam; int8
  quantized before it is grown; zeros beyond the prompt); runs the first
  step eagerly (it consumes the prefill's distribution and writes no
  cache, as the JAX ``cond`` does); replays the step ``max_new_tokens - 1``
  times.
- :class:`CapturedEncDecDecode`, the Transformer's
  (``models.transformer.make_decoder``; rows, source length, ``max_len``,
  beam, cache dtype). Its caches are each layer's self-attention ``k``,
  ``v``; beside them the encoder's output and source mask, repeated per
  beam, which a call writes from the eager encoder. A call replays the
  step ``max_len`` times from ``bos_id`` at index 0. The step reads the
  program's static copies of its params (``_DecodeProgram``).

Nothing in a step reads back to the host (no ``.item()``, no early exit
once every row has finished: the JAX scan runs ``max_len`` steps too).
Beam gathers cannot reorder a static buffer in place, so each cache is
gathered into a scratch buffer of its shape and copied back: a beam step
reads and writes every cache twice (four times its bytes, 1.21 GB for
GPT-base at bucket 8 and beam 4), where JAX's functional gather reads
and writes it once.

Capture. The step first runs eagerly on a side stream (PyTorch's
warm-up: cuBLAS handles and workspaces), on the buffers before any call
has filled them; every call writes all of its state before it reads it,
so the warm-up leaves nothing behind. A failed capture raises
:class:`~paddle_tpu_torch._captured_step.CaptureError`; nothing falls back
to eager steps. Capture, replays and buffers all live under
``torch.inference_mode()``.

On the CPU nothing is captured: the same step runs as a plain call, so
the CPU tests cover the body the card replays.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ._captured_step import CAPTURE_MODE, WARMUP_RUNS, CaptureError, side_stream
from .layers.beam_search import (beam_rows, beam_select, finish_beams, frozen_row,
                                 greedy_select, initial_scores)


class StaticDecode:
    """The static buffers of one decode call signature, the selection of a
    step over them, and the capture and replay of that step: what a
    model's decode (:class:`CapturedDecode`, :class:`CapturedEncDecDecode`)
    shares. ``kinds`` is each cache tensor's (shape, dtype), one tuple of
    them per layer; ``steps`` the width of the sequences written."""

    def __init__(self, batch: int, beam: int, steps: int, vocab: int, eos_id: int,
                 kinds, num_layers: int, device):
        self.batch, self.beam = int(batch), int(beam)
        self.rows = self.batch * self.beam
        self.eos_id = int(eos_id)
        self.device = device = torch.device(device)
        rows = self.rows
        self.caches: List[Tuple[torch.Tensor, ...]] = [
            tuple(torch.zeros(s, dtype=d, device=device) for s, d in kinds)
            for _ in range(num_layers)]
        self.tokens = torch.zeros((rows,), dtype=torch.int32, device=device)
        self.finished = torch.zeros((rows,), dtype=torch.bool, device=device)
        self.scores = torch.zeros((rows,), dtype=torch.float32, device=device)
        self.seqs = torch.zeros((rows, steps), dtype=torch.int32, device=device)
        self.index = torch.zeros((), dtype=torch.int32, device=device)
        self.step = torch.zeros((), dtype=torch.int32, device=device)
        self.frozen = None
        self.scratch: Dict[Tuple, torch.Tensor] = {}
        if self.beam > 1:
            self.frozen = frozen_row(vocab, self.eos_id, device)
            self.scratch = {(s, d): torch.empty(s, dtype=d, device=device)
                            for s, d in kinds}
        self.graph = None
        self.captures = 0
        self.replays = 0

    @property
    def on_card(self) -> bool:
        """Whether the step is captured and replayed (a CUDA device) or
        called (the CPU)."""
        return self.device.type == "cuda"

    def cache_bytes(self) -> int:
        """Bytes of the caches (every layer, with the int8 cache's scales)."""
        return sum(t.numel() * t.element_size() for c in self.caches for t in c)

    # -- one step ---------------------------------------------------------------

    def _select(self, logp: torch.Tensor) -> None:
        """The selection of one step from ``logp`` [rows, vocab]: the next
        tokens, the finished flags and the sequences' column at the step
        counter (for beam search also the scores, and every ``[rows,
        ...]`` buffer reordered by the surviving beams), then the step
        counter advanced."""
        col = self.step.reshape(1).long()
        if self.beam == 1:
            tokens = greedy_select(logp, self.finished, self.eos_id)
        else:
            beam_idx, tokens, top = beam_select(logp, self.scores, self.finished,
                                                self.frozen, self.batch, self.beam)
            rows = beam_rows(beam_idx, self.beam)
            for cache in self.caches:
                for c in cache:
                    scratch = self.scratch[(tuple(c.shape), c.dtype)]
                    torch.index_select(c, 0, rows, out=scratch)
                    c.copy_(scratch)
            self.seqs.copy_(self.seqs.index_select(0, rows))
            self.finished.copy_(self.finished.index_select(0, rows))
            self.scores.copy_(top)
        self.seqs.index_copy_(1, col, tokens[:, None])
        self.finished |= tokens == self.eos_id
        self.tokens.copy_(tokens)
        self.step.add_(1)

    def _body(self) -> None:
        """The incremental step: what the graph holds."""
        raise NotImplementedError

    # -- a call -----------------------------------------------------------------

    def _start(self, bos_id: int, index: int) -> None:
        """Every buffer a call reads before it writes it, set for a new
        call: the tokens at ``bos_id``, no row finished, empty sequences,
        the beams' initial scores, the cache index at ``index``."""
        self.tokens.fill_(bos_id)
        self.finished.zero_()
        self.seqs.zero_()
        if self.beam > 1:
            self.scores.copy_(initial_scores(self.batch, self.beam, self.device))
        self.index.fill_(index)
        self.step.zero_()

    def _steps(self, n: int) -> None:
        """``n`` incremental steps: graph replays on the card, plain calls
        of the body on the CPU."""
        for _ in range(n):
            if self.graph is None:
                self._body()
            else:
                try:
                    self.graph.replay()
                except Exception as e:
                    raise CaptureError(f"replaying the captured decode step failed: {e}") \
                        from e
                self.replays += 1

    def _outputs(self, length_penalty_alpha: float) -> Dict[str, torch.Tensor]:
        """The call's result: the ids (for beam search with the scores,
        sorted best first under the length penalty)."""
        if self.beam == 1:
            return {"ids": self.seqs.clone()}
        seqs, scores = finish_beams(self.seqs, self.scores, self.batch, self.beam,
                                    self.eos_id, length_penalty_alpha)
        return {"ids": seqs, "scores": scores}

    def _capture(self) -> None:
        main = torch.cuda.current_stream(self.device)
        side = side_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self.index.zero_()
                self.step.zero_()
                self._body()
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode=CAPTURE_MODE):
                self._body()
        except Exception as e:
            raise CaptureError(f"capturing the decode step as a CUDA graph failed: {e}") \
                from e
        self.graph = graph
        self.captures += 1


class CapturedDecode(StaticDecode):
    """One GPT generator's decode from static buffers at one call
    signature: captured and replayed on the card, called on the CPU."""

    def __init__(self, gen, batch: int, prompt_len: int, layers, w_head):
        cfg = gen.cfg
        self.gen = gen
        self.prompt_len = int(prompt_len)
        self.new = gen.max_new_tokens
        rows = int(batch) * gen.beam_size
        total = self.prompt_len + self.new
        hd = cfg.d_model // cfg.num_heads
        shape = (rows, cfg.num_heads, total, hd)
        if gen.int8_kv:
            scale = (rows, cfg.num_heads, total, 1)
            kinds = ((shape, torch.int8), (scale, torch.float32)) * 2
        else:
            kinds = ((shape, gen.compute_dtype),) * 2
        super().__init__(batch, gen.beam_size, self.new, cfg.vocab_size, gen.eos_id, kinds,
                         cfg.num_layers, gen.device)
        self.signature = (self.rows, self.prompt_len, self.new, self.beam,
                          cfg.kv_cache_dtype)
        # the weights the step reads, the generator's: each layer's params
        # (the matmul weights cast to the compute dtype) and the head's weight
        self.layers, self.w_head = layers, w_head

    def _body(self) -> None:
        logp = self.gen.decode_step(self.tokens, self.caches, self.index, self.layers,
                                    self.w_head)
        self._select(logp)
        self.index.add_(1)

    def run(self, prompt_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        gen, K, p = self.gen, self.beam, self.prompt_len
        if self.on_card and self.graph is None and self.new > 1:
            self._capture()
        logp0, ks, vs = gen.prefill(prompt_ids, self.layers)
        for cache, prefix in zip(self.caches, gen.prefix_caches(ks, vs)):
            for c, a in zip(cache, prefix):
                c.view(self.batch, K, *c.shape[1:])[:, :, :, :p].copy_(a[:, None])
                c[:, :, p:].zero_()
        self._start(gen.bos_id, p)
        # the first step: the prefill's distribution, no cache written
        self._select(logp0.repeat_interleave(K, dim=0) if K > 1 else logp0)
        self._steps(self.new - 1)
        return self._outputs(gen.length_penalty_alpha)


class CapturedEncDecDecode(StaticDecode):
    """An encoder-decoder's decode (``models.transformer.make_decoder``)
    from static buffers at one call signature (rows = batch · beam, the
    source length, ``max_len``, beam, the cache dtype): each call writes
    the eager encoder's output and source mask into their buffers
    (repeated per beam), then runs ``max_len`` incremental steps from
    ``bos_id`` at index 0, the JAX ``scan``'s steps. ``step(tokens,
    caches, index, enc_out, src_mask) -> logp`` is the model's decoder
    step over these buffers (each layer's cache a ``(k, v)`` pair
    ``[rows, h, max_len, hd]``, written in place at the device index)."""

    def __init__(self, step, batch: int, beam: int, max_len: int, src_len: int,
                 d_model: int, num_heads: int, num_layers: int, vocab: int, cache_dtype,
                 enc_dtype, bos_id: int, eos_id: int, length_penalty_alpha: float, device):
        rows = int(batch) * int(beam)
        shape = (rows, num_heads, int(max_len), d_model // num_heads)
        super().__init__(batch, beam, max_len, vocab, eos_id, ((shape, cache_dtype),) * 2,
                         num_layers, device)
        self.max_len = int(max_len)
        self.bos_id = int(bos_id)
        self.length_penalty_alpha = float(length_penalty_alpha)
        self.signature = (rows, int(src_len), self.max_len, self.beam, cache_dtype)
        self.enc_out = torch.zeros((rows, src_len, d_model), dtype=enc_dtype,
                                   device=self.device)
        self.src_mask = torch.zeros((rows, 1, 1, src_len), dtype=torch.float32,
                                    device=self.device)
        self.step_fn = step

    def _body(self) -> None:
        logp = self.step_fn(self.tokens, self.caches, self.index, self.enc_out,
                            self.src_mask)
        self._select(logp)
        self.index.add_(1)

    def run(self, enc_out: torch.Tensor, src_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One call from the encoder's output [batch, s, d] and its source
        mask [batch, 1, 1, s]."""
        if self.on_card and self.graph is None:
            self._capture()
        K = self.beam
        self.enc_out.view(self.batch, K, *enc_out.shape[1:]).copy_(enc_out[:, None])
        self.src_mask.view(self.batch, K, *src_mask.shape[1:]).copy_(src_mask[:, None])
        for cache in self.caches:
            for c in cache:
                c.zero_()
        self._start(self.bos_id, 0)
        self._steps(self.max_len)
        return self._outputs(self.length_penalty_alpha)


__all__ = ["CapturedDecode", "CapturedEncDecDecode", "StaticDecode"]
