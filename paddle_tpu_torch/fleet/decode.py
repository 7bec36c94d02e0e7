"""Decode-side serving workload: batched incremental decoding behind the
continuous-batching scheduler (counterpart of ``paddle_tpu.fleet.decode``).

``models/gpt.make_generator`` (prefill through the flash-attention
kernel, then greedy decode over a KV cache) exports through the ordinary
``save_inference_model`` door with batch buckets, so single-prompt
decode requests coalesce into one bucket-sized dispatch. Rows are
independent through prefill and decode (per-row attention, per-row
argmax), so a coalesced request's token ids equal the ids of its row in
a ``Predictor.run`` of the same merged batch.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np


def export_decoder(dirname: str, cfg, max_new_tokens: int,
                   example_prompt, params: Optional[Dict[str, Any]] = None,
                   batch_buckets: Sequence[int] = (),
                   seed: int = 0, compute_dtype="float32",
                   device=None) -> Tuple[Any, Dict[str, Any]]:
    """Export a ``gpt.make_generator`` program (greedy decode over a KV
    cache) as a multi-bucket ``save_inference_model`` artifact.

    ``example_prompt``: int32 ``[b, p]`` prompt ids — its batch size
    becomes a bucket; ``batch_buckets`` adds more. ``params`` is a flat
    ``{JAX param name: tensor or array}`` dict (``gpt.params_from_jax``
    carries the JAX package's params across); None draws a fresh init
    from ``seed`` through the port's initializers. ``compute_dtype``
    stands in for the JAX package's ``default_compute_dtype`` flag.
    The program is built on ``device`` (the CUDA card by default).
    Returns ``(program, params)``."""
    from .. import io as pio
    from ..models import gpt

    prog = gpt.make_generator(cfg, max_new_tokens=max_new_tokens,
                              compute_dtype=compute_dtype, device=device)
    if params is None:
        prog.init_params(seed)
    else:
        prog.load_params(params)
    params = prog.flat_params()
    feed = {"prompt_ids": np.asarray(example_prompt, np.int32)}
    pio.save_inference_model(dirname, prog, params, {}, feed,
                             batch_buckets=list(batch_buckets) or None)
    return prog, params


def decode_server(dirname: str, max_wait_ms: float = 5.0,
                  workers: int = 1, queue_size: int = 32, device=None,
                  **server_kw):
    """A ``PredictorServer`` over an :func:`export_decoder` artifact with
    continuous batching on — the decode serving front. Single prompts
    coalesce into the largest exported bucket within ``max_wait_ms``;
    token-id outputs slice back per caller. Loads onto ``device`` (the
    CUDA card by default)."""
    from .. import io as pio
    from ..serving import PredictorServer
    from .batching import BatchPolicy

    # load_inference_model has already run every bucket once, so the
    # server does not warm them again
    return PredictorServer(pio.load_inference_model(dirname, device=device),
                           workers=workers, queue_size=queue_size,
                           batch_policy=BatchPolicy(max_wait_ms=max_wait_ms),
                           warmup=False, **server_kw)


__all__ = ["decode_server", "export_decoder"]
