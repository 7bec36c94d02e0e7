"""K optimizer steps a dispatch for ``Trainer.run_steps``: the step
captured once as a CUDA graph and replayed K times.

The JAX package compiles its K steps into one program (``lax.scan`` over
the step, executor.py:1174-1195). Here one CUDA graph holds ONE step,
``Trainer._step_body``, and a dispatch replays it K times, so any K
reuses the graph. It is kept per trainer and feed signature (the feed's
names, per-step shapes, dtypes and device, the fetch set, the loss
scaler and the guard).

Static buffers. A graph reads and writes fixed addresses, so:

- the training state (params, optimizer state with its 0-d ``step``,
  program state such as batch-norm statistics, loss-scale state) is
  written in place by the body itself (``executor.write_in_place``);
- each feed name has a slot of one step's shape, which gets a
  device-to-device copy of slice ``i`` of the stacked feed before replay
  ``i`` (on the consumer's stream, after the ``DeviceFeeder``'s staging
  copy that the stream already waits on);
- after each replay the graph's outputs are copied into slot ``i`` of
  the ``(K, ...)`` results, which are tensors of their own;
- the flash kernels encode their TMA tensor maps from the operands'
  addresses when they are captured: the operands are params, feed slots
  and activations of the graph's pool, all at fixed addresses.

Random numbers. The body draws from this runner's
:class:`~paddle_tpu_torch.framework.RngStream`, seeded on the host before
each replay with the seed ``step()`` would use at that global step; the
graph registers its generators (``CUDAGraph.register_generator_state``)
and advances their Philox offsets on the card, so the replay draws what
the eager step draws.

Capture. The body first runs eagerly on a side stream (the warm-up
PyTorch asks for), one stream a device for every capture
(:func:`side_stream`): it builds and loads every kernel the step launches
(``ops/_build``), runs cuDNN's algorithm search, and records the step's
side generators. The training state is copied before the warm-up and
copied back after it, so the warm-up takes no step; the capture itself
runs no kernel. Python side effects of the warm-up and the capture remain:
the flash kernels' launch counters count them (a replay runs no Python),
and the guard's bit names are set. The capture runs in
``thread_local`` mode: ``fit``'s prefetch thread keeps staging batches
(pinning memory, recording events) meanwhile, which the ``global`` mode
would refuse in that thread. A failed capture or replay raises
:class:`CaptureError`; nothing falls back to eager steps.

On the CPU there is nothing to capture: the same static-slot body runs K
times as a plain call, which the CPU tests hold against K ``step()``
calls.

Invalidation. A runner is valid while the trainer's training state is
the same tensors at the same addresses and the signature holds:
``startup``, ``io.load_trainer``, assigning a param or state tensor
(``scope.params[name] = t``, ``p.data = t``) or another feed signature
makes ``run_steps`` drop it and capture anew.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from . import framework
from .core.errors import EnforceError
from .framework import RngStream

CAPTURE_MODE = "thread_local"
WARMUP_RUNS = 2


class CaptureError(EnforceError):
    """Capturing or replaying a trainer's step as a CUDA graph failed."""


def state_key(trainer) -> Tuple:
    """Which tensors, at which addresses, hold the trainer's training
    state, leaf by leaf."""
    from .executor import _leaves, _local
    return tuple((id(t), _local(t).data_ptr()) for t in _leaves(trainer._state_trees()))


def signature(trainer, feed_k: Dict[str, torch.Tensor]) -> Tuple:
    """What a captured step is specific to, besides the state's tensors:
    the feed, the fetch set, the loss scaler and guard, the strategy's
    remat and accumulation (the Trainer's ``remat_mode``, whatever the
    ambient one), and ``amp_guard``'s compute dtype, the ambient switch a
    run reads when it starts."""
    feed = tuple((k, tuple(v.shape[1:]), v.dtype, v.device) for k, v in sorted(feed_k.items()))
    fetch = None if trainer.fetch_list is None else tuple(trainer.fetch_list)
    s = trainer.strategy
    strategy = None if s is None else (s.remat, s.remat_policy, s.accum_steps,
                                       s.accum_exchange, s.quantized_allreduce,
                                       s.zero_sharding, s.sequence_parallel, s.sp_impl)
    return (feed, fetch, trainer.loss_name, id(trainer.loss_scaler), id(trainer._guard),
            trainer.device, strategy, framework.compute_dtype())


_SIDE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def side_stream(device) -> "torch.cuda.Stream":
    """The one side stream the captures on ``device`` warm up on. cuBLAS
    keeps a workspace for each stream it has run on, for the life of the
    process, so a new stream a capture would leave one more workspace
    allocated after every trainer or generator."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = torch.cuda.Stream(index)
    return _SIDE_STREAMS[index]


def _copy(dsts: List[torch.Tensor], srcs: List[torch.Tensor]) -> None:
    """One multi-tensor copy; a mesh's DTensors copy their local shards
    (the slots share their placements with what fills them)."""
    from .executor import _local
    torch._foreach_copy_([_local(t) for t in dsts], [_local(t) for t in srcs])


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


class FusedSteps:
    """A trainer's step from fixed feed slots, run K times a dispatch:
    captured and replayed on the card, called on the CPU."""

    def __init__(self, trainer, feed_k: Dict[str, torch.Tensor]):
        self.trainer = trainer
        self.device = trainer.device
        self.signature = signature(trainer, feed_k)
        self.state_key = state_key(trainer)
        self.feed = {k: torch.empty_like(v[0]) for k, v in feed_k.items()}
        self.stream = RngStream(self.device)
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.out: Optional[Dict[str, torch.Tensor]] = None  # the last step's outputs
        self.grads: Dict[str, Optional[torch.Tensor]] = {}  # the graph's grad buffers
        self.captures = 0

    @property
    def on_card(self) -> bool:
        """Whether the step is captured and replayed (a CUDA device) or
        called (the CPU)."""
        return self.device.type == "cuda"

    def valid_for(self, trainer, feed_k: Dict[str, torch.Tensor]) -> bool:
        return (trainer is self.trainer and self.signature == signature(trainer, feed_k)
                and self.state_key == state_key(trainer))

    def run(self, feed_k: Dict[str, torch.Tensor], seeds: List[int]) -> Dict[str, torch.Tensor]:
        """``len(seeds)`` steps, step ``i`` from slice ``i`` of ``feed_k``
        drawing from seed ``seeds[i]``; the outputs stacked ``(K, ...)``."""
        names = list(self.feed)
        results: Optional[Dict[str, torch.Tensor]] = None
        for i, seed in enumerate(seeds):
            _copy([self.feed[n] for n in names], [feed_k[n][i] for n in names])
            out = self._step(seed)
            if results is None:
                results = {n: torch.empty((len(seeds), *v.shape), dtype=v.dtype,
                                          device=v.device) for n, v in out.items()}
            _copy([results[n][i] for n in out], list(out.values()))
        if self.on_card:
            # the grads of the last step stay on the params, as after step()
            for k, p in self.trainer.scope.params.items():
                p.grad = self.grads.get(k)
        return results

    def _step(self, seed: int) -> Dict[str, torch.Tensor]:
        if not self.on_card:
            self.out = self.trainer._step_body(self.feed, self.stream.reset(seed))
            return self.out
        if self.graph is None:
            self._capture(seed)
        self.stream.reset(seed)
        try:
            self.graph.replay()
        except Exception as e:
            raise CaptureError(f"replaying the captured step failed: {e}") from e
        return self.out

    def _capture(self, seed: int) -> None:
        tr = self.trainer
        trees = tr._state_trees()
        saved = _clone(trees)
        main = torch.cuda.current_stream(self.device)
        side = side_stream(self.device)
        side.wait_stream(main)
        try:
            with torch.cuda.stream(side):
                for _ in range(WARMUP_RUNS):
                    tr._step_body(self.feed, self.stream.reset(seed))
        finally:
            from .executor import write_in_place
            main.wait_stream(side)
            write_in_place(trees, saved)
        del saved
        self.stream.freeze()
        graph = torch.cuda.CUDAGraph()
        for g in self.stream.generators():
            graph.register_generator_state(g)
        self.stream.reset(seed)
        try:
            with torch.cuda.graph(graph, capture_error_mode=CAPTURE_MODE):
                out = tr._step_body(self.feed, self.stream)
        except Exception as e:
            raise CaptureError(f"capturing the step as a CUDA graph failed: {e}") from e
        self.graph, self.out = graph, out
        self.grads = {k: p.grad for k, p in tr.scope.params.items()}
        self.captures += 1


__all__ = ["CAPTURE_MODE", "CaptureError", "FusedSteps", "side_stream", "signature",
           "state_key"]
