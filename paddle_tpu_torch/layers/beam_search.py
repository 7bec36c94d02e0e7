"""Greedy decoding (counterpart of ``paddle_tpu.layers.beam_search``).

The step-function contract is the JAX package's: ``step_fn(tokens
[rows], state) -> (logprobs [rows, vocab], new_state)``. The JAX
``lax.scan`` becomes a Python loop. ``beam_search`` comes later
(ROADMAP).
"""

from __future__ import annotations

import torch


def greedy_search(step_fn, init_state, batch_size: int, max_len: int,
                  bos_id: int = 1, eos_id: int = 2, device=None):
    """Greedy decode: [batch_size, max_len] int32 token ids. A row that
    emitted ``eos_id`` keeps emitting it; ties go to the first maximal
    id (``torch.argmax`` returns the first, as ``jnp.argmax`` does)."""
    tokens = torch.full((batch_size,), bos_id, dtype=torch.int32, device=device)
    finished = torch.zeros((batch_size,), dtype=torch.bool, device=device)
    seqs = torch.zeros((batch_size, max_len), dtype=torch.int32, device=device)
    eos = torch.tensor(eos_id, dtype=torch.int32, device=device)
    state = init_state
    for t in range(max_len):
        logp, state = step_fn(tokens, state)
        nxt = torch.argmax(logp, dim=-1).to(torch.int32)
        nxt = torch.where(finished, eos, nxt)
        seqs[:, t] = nxt
        finished = finished | (nxt == eos_id)
        tokens = nxt
    return seqs
