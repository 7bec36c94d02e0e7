"""HBM budget / rematerialization advisor (counterpart of
``paddle_tpu.profiling.advisor``).

Estimate the train step's memory appetite on its device (params +
optimizer state + what the backward holds), compare it against the
card's memory and emit a ``memory:remat-candidate`` finding suggesting
``DistStrategy.remat``/``remat_policy`` with the projected saving, before
the allocator fails with an error that names nothing. The device dataset
cache (``data.device_cache.residual_hbm_bytes``) budgets its admission
against :func:`memory_estimate` too.

The JAX package sums the intermediate values of the traced step's
jaxpr. Here one training forward runs on the trainer's device under
``torch.autograd.graph.saved_tensors_hooks``, and the bytes the backward
would keep are those of the tensors it saves, each storage once and the
training state's own storages left out (they are counted with the
scope). Under remat (the projection runs the forward again with the
strategy's ``remat=True``) a checkpointed block saves nothing an outer
hook sees; what it holds, its inputs and the outputs its policy keeps,
is counted through ``framework.count_remat_kept``. The count runs on the
CPU as on the card.

:func:`verify_remat` measures the suggestion: a second Trainer with
``remat=True``, each one's ``debugger.compiled_memory_usage`` (one
step's measured peak on the card; the estimate on the CPU).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional

import torch

# suggest remat only when the projected saving is worth a recompute
# pass: below this fraction of the budget the advice would be noise
_MIN_SAVING_FRAC = 0.02


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
    """Bytes one training forward of ``feed`` saves for its backward
    (under remat, what its checkpointed blocks hold)."""
    from ..executor import _put
    from ..framework import count_remat_kept

    state = trainer._state_trees()
    owned = _storages(state, set())
    seen: set = set()
    # the counted storages, held until the count ends: a freed one's address
    # could come back for a later tensor, which would then go uncounted
    held: list = []
    total = [0]

    def keep(t):
        t = t.to_local() if hasattr(t, "to_local") else t
        if t.is_meta:  # a kept output's shape (framework.count_remat_kept)
            total[0] += t.numel() * t.element_size()
            return
        st = t.untyped_storage()
        ptr = st.data_ptr()
        if ptr not in owned and ptr not in seen:
            seen.add(ptr)
            held.append(st)
            total[0] += st.nbytes()

    def pack(t):
        keep(t)
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
            count_remat_kept(keep), trainer._remat_scope():
        trainer._run(example, training=True, rng=0)
    return total[0]


def _with_remat(trainer, policy=None):
    """Context: temporarily present the trainer's strategy with
    ``remat=True`` (and ``policy``, else the strategy's own) so a forward
    runs the checkpointed graph."""
    from ..parallel.strategy import DistStrategy

    @contextlib.contextmanager
    def ctx():
        old = trainer.strategy
        base = old if old is not None else DistStrategy()
        trainer.strategy = dataclasses.replace(
            base, remat=True,
            remat_policy=policy if policy is not None else base.remat_policy)
        try:
            yield
        finally:
            trainer.strategy = old

    return ctx()


def memory_estimate(trainer, feed: Dict[str, Any], policy=None,
                    project_remat: bool = True) -> Dict[str, Any]:
    """The training step's memory appetite on its device: the scope's
    bytes (params, optimizer state, program state) plus what one forward
    holds for the backward, with and without remat (the projected
    saving). ``feed`` is one step's sample feed (wire-typed fields are
    estimated at their logical dtype). ``project_remat=False`` skips the
    second (checkpointed) forward — for callers that only need the
    current-state number (``debugger.compiled_memory_usage``'s
    estimate); ``activation_bytes_remat`` then mirrors the current one.
    ``est_total_bytes`` counts the activations of the strategy the
    trainer runs."""
    scope = trainer.scope
    param_b = _tree_bytes(scope.params)
    opt_b = _tree_bytes(scope.opt_state or {})
    state_b = _tree_bytes(scope.state or {})
    act = _activation_bytes(trainer, feed)
    if project_remat:
        with _with_remat(trainer, policy):
            act_remat = _activation_bytes(trainer, feed)
    else:
        act_remat = act
    remat_on = bool(getattr(trainer.strategy, "remat", False))
    total = param_b + opt_b + state_b + (act_remat if remat_on else act)
    return {
        "param_bytes": int(param_b),
        "opt_state_bytes": int(opt_b),
        "state_bytes": int(state_b),
        "activation_bytes": int(act),
        "activation_bytes_remat": int(act_remat),
        "remat_enabled": remat_on,
        "est_total_bytes": int(total),
        "est_total_mb": round(total / 1e6, 3),
    }


def advise(trainer, feed, hbm_budget_bytes: Optional[int] = None,
           report=None, safety: float = 0.9, policy: str = "dots"):
    """Compare the step's estimated memory appetite against the budget
    and append ``memory:*`` findings to ``report`` (an
    :class:`analysis.LintReport`; one is created when None):

    - ``memory:remat-candidate`` (warning) — over budget, remat off,
      and the projected activation saving is material: suggests
      ``DistStrategy(remat=True, remat_policy=...)`` with numbers;
    - ``memory:over-budget`` (warning) — over budget with remat
      already on (the advisor has no cheaper lever: points at
      microbatching / sharding);
    - ``memory:fits`` (info) — under budget, with the margin.

    With no budget (the CPU and no explicit ``hbm_budget_bytes``) the
    family is inert and the report comes back unchanged."""
    from ..analysis.report import LintReport

    if report is None:
        report = LintReport(subject=f"memory({trainer.program.name})")
    budget = (hbm_budget_bytes if hbm_budget_bytes is not None
              else device_hbm_bytes(trainer.device))
    if budget is None:
        return report
    # one forward without the remat projection first: the common
    # memory:fits outcome never needs the second (checkpointed) one
    est = memory_estimate(trainer, feed, policy=policy, project_remat=False)
    usable = safety * budget
    if est["est_total_bytes"] > usable:
        est = memory_estimate(trainer, feed, policy=policy)
    saving = est["activation_bytes"] - est["activation_bytes_remat"]
    if est["est_total_bytes"] <= usable:
        report.add(
            "memory:fits", "info",
            f"estimated {est['est_total_mb']:.1f} MB/device (params "
            f"{est['param_bytes'] / 1e6:.1f} + opt "
            f"{est['opt_state_bytes'] / 1e6:.1f} + activations "
            f"{(est['activation_bytes_remat'] if est['remat_enabled'] else est['activation_bytes']) / 1e6:.1f}) "
            f"within {safety:.0%} of the {budget / 1e6:.0f} MB budget",
            where="hbm", **est, hbm_budget_bytes=int(budget))
    elif not est["remat_enabled"] and saving > _MIN_SAVING_FRAC * budget:
        report.add(
            "memory:remat-candidate", "warning",
            f"estimated {est['est_total_mb']:.1f} MB/device exceeds "
            f"{safety:.0%} of the {budget / 1e6:.0f} MB budget and "
            f"activations dominate ({est['activation_bytes'] / 1e6:.1f} MB "
            f"held for backward) — set DistStrategy(remat=True, "
            f"remat_policy={policy!r}) to trade recompute for "
            f"~{saving / 1e6:.1f} MB (projected from the checkpointed "
            f"forward; verify with debugger.compiled_memory_usage temp_mb)",
            where="hbm", **est, hbm_budget_bytes=int(budget),
            suggested_policy=policy,
            projected_saving_bytes=int(saving))
    else:
        report.add(
            "memory:over-budget", "warning",
            f"estimated {est['est_total_mb']:.1f} MB/device exceeds "
            f"{safety:.0%} of the {budget / 1e6:.0f} MB budget"
            + (" with remat already enabled"
               if est["remat_enabled"] else
               " and remat would not recover enough")
            + " — shrink the per-device batch (accum_steps), shard "
            "params/opt state (fsdp / reduce_strategy='sharded'), or "
            "store opt state in bf16 (opt_state_dtype)",
            where="hbm", **est, hbm_budget_bytes=int(budget))
    return report


def verify_remat(trainer, feed, policy: str = "dots") -> Dict[str, Any]:
    """Measure the advisor's suggestion: builds a second Trainer over the
    same program, optimizer and params with ``remat=True`` and
    ``policy``, and returns each one's ``temp_mb``
    (``debugger.compiled_memory_usage``: one step's measured peak over
    the allocation before it on the card, the estimate on the CPU) and
    the estimated activations before and after."""
    from .. import executor as _executor
    from ..debugger import compiled_memory_usage
    from ..parallel.strategy import DistStrategy

    base = (trainer.strategy if trainer.strategy is not None
            else DistStrategy())
    remat_strategy = dataclasses.replace(base, remat=True,
                                         remat_policy=policy)
    before = compiled_memory_usage(trainer, feed)
    est_before = memory_estimate(trainer, feed, policy=policy)
    tr2 = _executor.Trainer(
        trainer.program, trainer.optimizer, loss_name=trainer.loss_name,
        place=trainer.device, mesh=trainer.mesh,
        sharding_rules=trainer.sharding_rules_raw,
        strategy=remat_strategy,
        fetch_list=trainer.fetch_list,
        feed_wire=trainer.feed_wire, augment=trainer.feed_augment)
    tr2.startup(sample_feed=feed, params=trainer._logical_params())
    after = compiled_memory_usage(tr2, feed)
    est_after = memory_estimate(tr2, feed, policy=policy)
    return {
        "temp_mb_before": before.get("temp_mb"),
        "temp_mb_after": after.get("temp_mb"),
        "memory_source": (before.get("source"), after.get("source")),
        "est_activation_mb_before": est_before["activation_bytes"] / 1e6,
        "est_activation_mb_after": est_after["activation_bytes_remat"] / 1e6,
        "suggested_policy": policy,
    }


__all__ = ["advise", "device_hbm_bytes", "memory_estimate", "verify_remat"]
