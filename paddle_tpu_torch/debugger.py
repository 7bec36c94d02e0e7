"""Program debugging (counterpart of ``paddle_tpu.debugger``): the
parameter table and the step's memory.

- :func:`summarize_params` — the parameter/memory table
  (memory_usage_calc.py analog), the JAX package's text;
- :func:`compiled_memory_usage` — the memory of one training step, the
  number ``profiling.advisor.verify_remat`` compares. The JAX package
  reads XLA's buffer assignment of the compiled step; PyTorch compiles
  nothing, so on the card one step runs (the trainer left as it was,
  ``profiling.fusion.isolated_step``) and ``temp_mb`` is its peak
  allocation over what was allocated before it (``source``
  ``"measured"``). On the CPU there is no device allocator to read, and
  the JAX package's own fallback answers: the advisor's estimate
  (``source`` ``"estimate"``, with its ``reason``).

The functions that trace or lower the program (``program_to_dot``,
``program_hlo``, ``op_frequence``, ``memory_usage``,
``collective_report``) come with ``Program.desc``, ROADMAP item 25; each
raises :class:`~paddle_tpu_torch.core.errors.NotYetPorted`.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .core.errors import NotYetPorted


def summarize_params(params: Dict[str, torch.Tensor]) -> str:
    """Parameter/memory table (memory_usage_calc.py analog)."""
    rows = []
    total = 0
    for name in sorted(params):
        v = params[name]
        n = int(v.numel())
        total += n * v.element_size()
        dtype = str(v.dtype).replace("torch.", "")
        rows.append(f"{name:<50} {str(tuple(v.shape)):<20} {dtype:<10} {n:>12,}")
    header = f"{'name':<50} {'shape':<20} {'dtype':<10} {'elements':>12}"
    rows.append(f"TOTAL {total / 1e6:.2f} MB")
    return "\n".join([header, "-" * len(header)] + rows)


def _bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if hasattr(tree, "to_local") else tree
        return t.numel() * t.element_size()
    return 0


def compiled_memory_usage(trainer, feed) -> Dict[str, Any]:
    """The memory of the Trainer's training step for the current scope
    and ``feed`` shapes, in MB, with its ``source``:

    - ``"measured"`` (a CUDA trainer): one step run and restored;
      ``temp_mb`` its peak allocation over the allocation before it (the
      activations, grads and the update's temporaries), ``argument_mb``
      the training state and the feed on the card, ``output_mb`` the
      training state the step writes (in place);
    - ``"estimate"`` (a CPU trainer): ``profiling.advisor.memory_estimate``
      fills in ``temp_mb`` (the activations the backward holds) and
      ``argument_mb``, and ``reason`` names why nothing was measured."""
    from .profiling.advisor import memory_estimate
    from .profiling.fusion import measured_step

    if trainer.device.type == "cuda":
        _, temp = measured_step(trainer, feed)
        state = _bytes(trainer._state_trees())
        feed_b = sum(v.nbytes if hasattr(v, "nbytes") else
                     (v.numel() * v.element_size() if isinstance(v, torch.Tensor) else 0)
                     for v in feed.values())
        return {
            "source": "measured",
            "temp_mb": temp / 1e6,
            "argument_mb": (state + feed_b) / 1e6,
            "output_mb": state / 1e6,
            "generated_code_mb": 0.0,
        }
    est = memory_estimate(trainer, feed, project_remat=False)
    act = (est["activation_bytes_remat"] if est["remat_enabled"]
           else est["activation_bytes"])
    return {
        "source": "estimate",
        "reason": (f"a {trainer.device.type} trainer has no device allocator to measure "
                   "(one step's peak is measured on a CUDA card)"),
        "temp_mb": act / 1e6,
        "argument_mb": (est["param_bytes"] + est["opt_state_bytes"]) / 1e6,
        "output_mb": est["param_bytes"] / 1e6,
        "generated_code_mb": 0.0,
        "estimate": est,
    }


def _item_25(name: str):
    def unported(*args, **kwargs):
        raise NotYetPorted(
            f"debugger.{name}: it traces or lowers the program, which comes with "
            "Program.desc (ROADMAP queue 1, item 25)")
    unported.__name__ = name
    unported.__doc__ = f"``paddle_tpu.debugger.{name}``; not ported yet (item 25)."
    return unported


program_to_dot = _item_25("program_to_dot")
program_hlo = _item_25("program_hlo")
op_frequence = _item_25("op_frequence")
memory_usage = _item_25("memory_usage")
collective_report = _item_25("collective_report")

__all__ = ["summarize_params", "compiled_memory_usage", "program_to_dot", "program_hlo",
           "op_frequence", "memory_usage", "collective_report"]
