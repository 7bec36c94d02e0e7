"""Transpiler surface (counterpart of ``paddle_tpu.transpiler``;
python/paddle/fluid/transpiler/).

The reference's transpilers rewrite programs: DistributeTranspiler splits
one program into trainer and pserver programs, memory_optimize reuses
variable storage by liveness. In both packages those rewrites become
strategy decisions: the transpile step keeps the program and returns the
:class:`~paddle_tpu_torch.parallel.DistStrategy` that the Trainer
consumes, ``reduce_strategy="sharded"`` for ``slice_var_up`` (params and
optimizer state sharded, the pserver's param slices), ``async_mode`` for
an asynchronous job (the C++ pserver of ``parallel.async_ps``), and
``remat`` for memory_optimize.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional

from .parallel.strategy import DistStrategy


class PSDispatcher:
    """Parameter placement over pserver endpoints or shard owners
    (ps_dispatcher.py): which owner holds each (split of a) parameter."""

    def __init__(self, eplist: List):
        self._eplist = list(eplist)
        self._step = 0

    def reset(self):
        self._step = 0

    def dispatch(self, varlist: List) -> List:
        raise NotImplementedError


class RoundRobin(PSDispatcher):
    """ps_dispatcher.py RoundRobin: parameters cycle over the owners."""

    def dispatch(self, varlist: List) -> List:
        out = []
        for _ in varlist:
            out.append(self._eplist[self._step % len(self._eplist)])
            self._step += 1
        return out


class HashName(PSDispatcher):
    """ps_dispatcher.py HashName: placement by a stable hash of the name
    (md5, not the salted builtin ``hash``), so it survives restarts."""

    def dispatch(self, varlist: List) -> List:
        def _stable_hash(v):
            name = v if isinstance(v, str) else getattr(v, "name", str(v))
            return int(hashlib.md5(name.encode()).hexdigest(), 16)

        return [self._eplist[_stable_hash(v) % len(self._eplist)] for v in varlist]


@dataclasses.dataclass
class DistributeTranspilerConfig:
    """distribute_transpiler.py DistributeTranspilerConfig: ``slice_var_up``
    decides whether params are sharded or replicated."""

    slice_var_up: bool = True
    split_method: type = RoundRobin
    min_block_size: int = 8192
    sync_mode: bool = True


class DistributeTranspiler:
    """The DistributeTranspiler API: ``transpile`` records the cluster
    layout; ``get_trainer_program``, ``get_pserver_program`` and
    ``get_startup_program`` return the same program with its
    DistStrategy (there is no trainer/pserver program split)."""

    def __init__(self, config: Optional[DistributeTranspilerConfig] = None):
        self.config = config or DistributeTranspilerConfig()
        self.trainer_id = 0
        self.trainers = 1
        self._program = None

    def transpile(self, trainer_id: int, program=None, pservers: str = "",
                  trainers: int = 1, sync_mode: bool = True, startup_program=None):
        self.sync_mode = bool(sync_mode and self.config.sync_mode)
        self.trainer_id = trainer_id
        self.trainers = trainers
        self._program = program
        self.pserver_endpoints = [ep for ep in pservers.split(",") if ep]

    def _strategy(self) -> DistStrategy:
        s = DistStrategy()
        if self.config.slice_var_up:
            s.reduce_strategy = "sharded"
        s.async_mode = not getattr(self, "sync_mode", True)
        return s

    def get_trainer_program(self):
        return self._program, self._strategy()

    def get_pserver_program(self, endpoint=None):
        return self._program, self._strategy()

    def get_startup_program(self, endpoint=None, pserver_program=None):
        return self._program, self._strategy()


def memory_optimize(input_program=None, skip_opt_set=None, print_log: bool = False,
                    level: int = 0):
    """memory_optimization_transpiler.py memory_optimize analog: buffer
    reuse is the allocator's; what a user controls is rematerialization,
    so this returns a DistStrategy with ``remat`` on, for the Trainer."""
    s = DistStrategy()
    s.remat = True
    return s


def release_memory(input_program=None, skip_opt_set=None):
    """release_memory analog: freeing buffers between steps is the caching
    allocator's job; kept for the API, it returns the program."""
    return input_program


__all__ = ["DistributeTranspiler", "DistributeTranspilerConfig", "HashName", "PSDispatcher",
           "RoundRobin", "memory_optimize", "release_memory"]
