"""A GPT generator's decode steps as one captured CUDA graph, replayed.

The JAX package generates in one compiled program: ``greedy_search`` or
``beam_search`` is a ``lax.scan`` over a static ``max_len`` under ``jit``,
the cache index is a device ``int32`` and the first step is a
``lax.cond`` (paddle_tpu/models/gpt.py:118-263). Here one CUDA graph
holds ONE incremental step and a call replays it ``max_new_tokens - 1``
times, so the host launches one graph a token instead of about 640
kernels.

Static buffers. For one generator and call signature — (rows = batch ·
beam, prompt length, ``max_new_tokens``, beam, ``kv_cache_dtype``) — a
:class:`CapturedDecode` owns fixed tensors: each layer's caches (``k``,
``v`` in the compute dtype, or int8 ``k_q``, ``v_q`` with f32 scales),
the tokens, finished flags, beam scores and sequences, the cache index
and the step counter (0-dim ``int32`` tensors on the card). The weights
it reads are the generator's (``GPTGenerator._decode_weights``: the
matmul weights cast to the compute dtype and the head's weight, one set
for every signature, copied from the params once a call). A call:

1. runs the prefill eagerly (the flash forward, one launch a layer) and
   writes the prompt's cache entries into the caches (repeated per beam;
   int8 quantized before it is grown; zeros beyond the prompt);
2. runs the first step eagerly: it consumes the prefill's
   distribution and writes no cache, as the JAX ``cond`` does;
3. replays the captured step ``max_new_tokens - 1`` times: the embedding
   at the device index, the blocks (each writing its cache at the index),
   the head, the greedy or beam selection with the beam gathers and the
   sequences' write, both counters advanced on the card;
4. copies the outputs out (for beam search, sorted best first with the
   length penalty).

Nothing in the step reads back to the host (no ``.item()``, no early exit
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

from ._captured_step import CAPTURE_MODE, WARMUP_RUNS, CaptureError
from .layers.beam_search import (beam_rows, beam_select, finish_beams, frozen_row,
                                 greedy_select, initial_scores)


class CapturedDecode:
    """One generator's decode from static buffers at one call signature:
    captured and replayed on the card, called on the CPU."""

    def __init__(self, gen, batch: int, prompt_len: int, layers, w_head):
        cfg = gen.cfg
        self.gen = gen
        self.batch, self.prompt_len = int(batch), int(prompt_len)
        self.beam = gen.beam_size
        self.rows = self.batch * self.beam
        self.new = gen.max_new_tokens
        self.device = gen.device
        self.signature = (self.rows, self.prompt_len, self.new, self.beam,
                          cfg.kv_cache_dtype)
        dev, rows = self.device, self.rows
        total = self.prompt_len + self.new
        hd = cfg.d_model // cfg.num_heads
        shape = (rows, cfg.num_heads, total, hd)
        if gen.int8_kv:
            scale = (rows, cfg.num_heads, total, 1)
            kinds = ((shape, torch.int8), (scale, torch.float32)) * 2
        else:
            kinds = ((shape, gen.compute_dtype),) * 2
        self.caches: List[Tuple[torch.Tensor, ...]] = [
            tuple(torch.zeros(s, dtype=d, device=dev) for s, d in kinds)
            for _ in range(cfg.num_layers)]
        self.tokens = torch.zeros((rows,), dtype=torch.int32, device=dev)
        self.finished = torch.zeros((rows,), dtype=torch.bool, device=dev)
        self.scores = torch.zeros((rows,), dtype=torch.float32, device=dev)
        self.seqs = torch.zeros((rows, self.new), dtype=torch.int32, device=dev)
        self.index = torch.zeros((), dtype=torch.int32, device=dev)
        self.step = torch.zeros((), dtype=torch.int32, device=dev)
        self.frozen = None
        self.scratch: Dict[Tuple, torch.Tensor] = {}
        if self.beam > 1:
            self.frozen = frozen_row(cfg.vocab_size, gen.eos_id, dev)
            self.scratch = {(s, d): torch.empty(s, dtype=d, device=dev) for s, d in kinds}
        # the weights the step reads, the generator's: each layer's params
        # (the matmul weights cast to the compute dtype) and the head's weight
        self.layers, self.w_head = layers, w_head
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
        gen = self.gen
        col = self.step.reshape(1).long()
        if self.beam == 1:
            tokens = greedy_select(logp, self.finished, gen.eos_id)
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
        self.finished |= tokens == gen.eos_id
        self.tokens.copy_(tokens)
        self.step.add_(1)

    def _body(self) -> None:
        """The incremental step: what the graph holds."""
        logp = self.gen.decode_step(self.tokens, self.caches, self.index, self.layers,
                                    self.w_head)
        self._select(logp)
        self.index.add_(1)

    # -- a call -----------------------------------------------------------------

    def run(self, prompt_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        gen, K, p = self.gen, self.beam, self.prompt_len
        if self.on_card and self.graph is None and self.new > 1:
            self._capture()
        logp0, ks, vs = gen.prefill(prompt_ids, self.layers)
        for cache, prefix in zip(self.caches, gen.prefix_caches(ks, vs)):
            for c, a in zip(cache, prefix):
                c.view(self.batch, K, *c.shape[1:])[:, :, :, :p].copy_(a[:, None])
                c[:, :, p:].zero_()
        self.tokens.fill_(gen.bos_id)
        self.finished.zero_()
        self.seqs.zero_()
        if K > 1:
            self.scores.copy_(initial_scores(self.batch, K, self.device))
        self.index.fill_(p)
        self.step.zero_()
        # the first step: the prefill's distribution, no cache written
        self._select(logp0.repeat_interleave(K, dim=0) if K > 1 else logp0)
        for _ in range(self.new - 1):
            if self.graph is None:
                self._body()
            else:
                try:
                    self.graph.replay()
                except Exception as e:
                    raise CaptureError(f"replaying the captured decode step failed: {e}") \
                        from e
                self.replays += 1
        if K == 1:
            return {"ids": self.seqs.clone()}
        seqs, scores = finish_beams(self.seqs, self.scores, self.batch, K, gen.eos_id,
                                    gen.length_penalty_alpha)
        return {"ids": seqs, "scores": scores}

    def _capture(self) -> None:
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
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


__all__ = ["CapturedDecode"]
