"""The memory advisor's estimate of a training step (counterpart of
``paddle_tpu.profiling.advisor``): so far :func:`device_hbm_bytes` and
:func:`memory_estimate`, which the device dataset cache
(``data.device_cache.residual_hbm_bytes``) budgets its admission
against. ``advise``, the remat projection and the rest of the advisor
come with ROADMAP item 24 (b).

The JAX package sums the intermediate values of the traced step's
jaxpr. Here one training forward runs on the trainer's device under
``torch.autograd.graph.saved_tensors_hooks``, and the bytes the backward
would keep are those of the tensors it saves, each storage once and the
training state's own storages left out (they are counted with the
scope). The count runs on the CPU as on the card.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..core.errors import NotYetPorted


def device_hbm_bytes(device=None) -> Optional[int]:
    """The card's total memory in bytes (``torch.cuda.mem_get_info``);
    None for the CPU, which has no such budget (pass one explicitly)."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return int(torch.cuda.mem_get_info(device)[1])


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if hasattr(tree, "to_local") else tree
        return t.numel() * t.element_size()
    return 0


def _storages(tree, out: set) -> set:
    if isinstance(tree, dict):
        for v in tree.values():
            _storages(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _storages(v, out)
    elif isinstance(tree, torch.Tensor):
        t = tree.to_local() if hasattr(tree, "to_local") else tree
        out.add(t.untyped_storage().data_ptr())
    return out


def _activation_bytes(trainer, feed: Dict[str, Any]) -> int:
    """Bytes one training forward of ``feed`` saves for its backward."""
    from ..executor import _put

    state = trainer._state_trees()
    owned = _storages(state, set())
    seen: set = set()
    total = [0]

    def pack(t):
        st = t.untyped_storage()
        ptr = st.data_ptr()
        if ptr not in owned and ptr not in seen:
            seen.add(ptr)
            total[0] += st.nbytes()
        # nothing is kept: no backward runs, and a node holding its own output
        # would keep the graph (and the params' AccumulateGrad nodes) alive
        # past the call, which a later CUDA graph capture of the step trips on
        return None

    example = trainer._logical_feed(feed)
    example = {k: (torch.zeros(v.shape, dtype=v.dtype, device=trainer.device)
                   if isinstance(v, torch.Tensor) and v.is_meta else _put(v, trainer.device))
               for k, v in example.items()}
    example = trainer._decode_feed(example, None, training=False)
    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), \
            trainer._remat_scope():
        trainer._run(example, training=True, rng=0)
    return total[0]


def memory_estimate(trainer, feed: Dict[str, Any], policy=None,
                    project_remat: bool = True) -> Dict[str, Any]:
    """The training step's memory appetite on its device: the scope's
    bytes (params, optimizer state, program state) plus the bytes one
    forward saves for the backward, as ``est_total_bytes``. ``feed`` is
    one step's sample feed (wire-typed fields are estimated at their
    logical dtype). Only ``project_remat=False`` is carried: the remat
    projection comes with ROADMAP item 24 (b)."""
    if project_remat or policy is not None:
        raise NotYetPorted("memory_estimate(project_remat=True): the remat projection "
                           "of the memory advisor, ROADMAP queue 1 item 24 (b)")
    scope = trainer.scope
    param_b = _tree_bytes(scope.params)
    opt_b = _tree_bytes(scope.opt_state or {})
    state_b = _tree_bytes(scope.state or {})
    act = _activation_bytes(trainer, feed)
    remat_on = bool(getattr(trainer.strategy, "remat", False))
    total = param_b + opt_b + state_b + act
    return {
        "param_bytes": int(param_b),
        "opt_state_bytes": int(opt_b),
        "state_bytes": int(state_b),
        "activation_bytes": int(act),
        "activation_bytes_remat": int(act),
        "remat_enabled": remat_on,
        "est_total_bytes": int(total),
        "est_total_mb": round(total / 1e6, 3),
    }


__all__ = ["device_hbm_bytes", "memory_estimate"]
