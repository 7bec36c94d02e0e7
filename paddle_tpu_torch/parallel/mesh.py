"""Device meshes (counterpart of ``paddle_tpu.parallel.mesh``).

The JAX package builds a named ``jax.sharding.Mesh`` over the devices one
process sees. PyTorch runs one process per device: :func:`initialize`
starts the ``torch.distributed`` process group (NCCL on a CUDA place, gloo
on the CPU), and :func:`make_mesh` lays the world's ranks out as a
``torch.distributed.device_mesh.DeviceMesh`` with the JAX package's axis
names:

- ``dp``   data parallel (params replicated, grads all-reduced)
- ``fsdp`` data parallel with sharded params and optimizer state
- ``tp``   tensor parallel
- ``sp``   sequence (context) parallel: ring or Ulysses attention
- ``pp``   pipeline stages
- ``ep``   expert / embedding-shard parallel

:class:`Mesh` wraps the ``DeviceMesh`` and exposes ``shape`` (axis name →
size) and ``axis_names`` as the JAX ``Mesh`` does, plus the process group
of each axis. The JAX module's ``pvary`` (``shard_map``'s varying-axes
bookkeeping) has no counterpart: a rank's tensors here are its own.

No fallback: a CUDA place with no card raises :class:`NoCudaDevice`, and a
failed NCCL start raises :class:`DistributedInitError`; neither carries on
with gloo or on the CPU.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.errors import EnforceError, enforce
from ..core.place import NoCudaDevice, default_device

DP, FSDP, TP, SP, PP, EP = "dp", "fsdp", "tp", "sp", "pp", "ep"
DATA_AXES = (DP, FSDP)  # axes the batch dimension is sharded over


class DistributedInitError(EnforceError):
    """The process group could not be started (an NCCL or gloo init that
    failed, or a mesh asked for with no process group)."""


def initialize(place=None, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               timeout_s: float = 300.0) -> torch.device:
    """Start this process's rank of the world (``jax.distributed.initialize``
    analog, the gen_nccl_id bootstrap): NCCL when ``place`` is a CUDA
    place (the default), gloo when it is the CPU. ``init_method`` (e.g.
    ``tcp://127.0.0.1:29500``), ``world_size`` and ``rank`` default to the
    ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` environment
    that ``torchrun`` sets. Returns this rank's device (``cuda:<local
    rank>`` or ``cpu``). A second call with the group already up returns
    the device and changes nothing."""
    dev = default_device(place, "parallel.initialize")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dev.index or 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        _check_backend(dev)
        return dev
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if init_method is not None:
        kw["init_method"] = init_method
    if world_size is not None:
        kw["world_size"] = int(world_size)
    if rank is not None:
        kw["rank"] = int(rank)
    if dev.type == "cuda":
        kw["device_id"] = dev
    try:
        dist.init_process_group(backend, timeout=timedelta(seconds=timeout_s), **kw)
    except Exception as e:  # a typed error, never a retry on another backend
        raise DistributedInitError(f"parallel.initialize: {backend} process group "
                                   f"failed to start: {e}") from e
    return dev


def _check_backend(dev: torch.device) -> None:
    want = "nccl" if dev.type == "cuda" else "gloo"
    have = dist.get_backend()
    if have != want:
        raise DistributedInitError(
            f"the process group runs {have}, but a {dev.type} mesh needs {want}")


def mesh_device() -> torch.device:
    """The device this rank's mesh tensors live on: its card under NCCL,
    the CPU under gloo."""
    if not dist.is_initialized():
        raise DistributedInitError("no process group: call parallel.initialize() "
                                   "before making a mesh")
    if dist.get_backend() == "nccl":
        if not torch.cuda.is_available():
            raise NoCudaDevice("an NCCL mesh")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class Mesh:
    """A named mesh of the world's ranks: ``shape`` ({axis: size}, in axis
    order), ``axis_names``, ``size``, ``device_mesh`` (the
    ``DeviceMesh``), ``device`` (this rank's device), :meth:`group` (an
    axis's process group) and :meth:`coord` (this rank's index on an
    axis)."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = {a: int(s) for a, s in zip(self.axis_names, device_mesh.shape)}
        self.size = int(np.prod(list(self.shape.values())))
        self._flat = {}

    @property
    def devices(self) -> np.ndarray:
        """The global ranks laid out in the mesh's shape (the JAX
        ``Mesh.devices`` array, of ranks)."""
        return self.device_mesh.mesh.cpu().numpy()

    def dim(self, axis: str) -> int:
        return self.axis_names.index(axis)

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def coord(self, axis: str) -> int:
        return int(self.device_mesh.get_local_rank(axis))

    def axes_group(self, axes: Sequence[str]):
        """The process group over several axes together (their ranks in
        mesh order, the first axis major): one group for a collective
        that spans ``("dp", "fsdp")``."""
        axes = tuple(axes)
        if len(axes) == 1:
            return self.group(axes[0])
        if axes not in self._flat:
            self._flat[axes] = self.device_mesh[axes]._flatten("_".join(axes))
        return self._flat[axes].get_group()

    def axes_coord(self, axes: Sequence[str]) -> int:
        """This rank's index over ``axes`` taken together, first axis
        major (the row a ZeRO shard or a batch slice belongs to)."""
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coord(a)
        return idx

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


class AbstractMesh:
    """A mesh's axis names and sizes with no ranks behind it (the
    ``jax.sharding.AbstractMesh`` analog): the target layout that the
    static checks read (``analysis.contracts.check_artifacts(mesh=)``,
    ``ShardingRules.spec_for``), for a world that is not running."""

    def __init__(self, axes: Dict[str, int]):
        self.axis_names = tuple(str(a) for a in axes)
        self.shape = {str(a): int(s) for a, s in axes.items()}
        self.size = int(np.prod(list(self.shape.values()) or [1]))

    def dim(self, axis: str) -> int:
        return self.axis_names.index(axis)

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """A named mesh over the world (``make_mesh`` :58). ``axes`` maps axis
    name → size; one ``-1`` size is inferred from the world size. Default:
    every rank on ``dp``. Axis order follows the dict; put the axis whose
    collectives are the most frequent (conventionally ``tp``) last.
    ``devices``, when given, must list every rank of the world (one
    process per device: a mesh cannot leave a rank out). Needs
    :func:`initialize` first."""
    device = mesh_device()
    n = dist.get_world_size()
    if devices is not None:
        enforce(sorted(int(d) for d in devices) == list(range(n)),
                f"make_mesh(devices={list(devices)}): a mesh covers every rank of the "
                f"world of {n}")
    if not axes:
        axes = {DP: n}
    axes = dict(axes)
    unknown = [k for k, v in axes.items() if v == -1]
    if unknown:
        known = int(np.prod([v for v in axes.values() if v != -1]))
        if n % known:
            raise ValueError(f"cannot infer axis {unknown[0]}: {n} devices not divisible by {known}")
        axes[unknown[0]] = n // known
    total = int(np.prod(list(axes.values())))
    if total != n:
        raise ValueError(f"mesh axes {axes} need {total} devices, have {n}")
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(device.type, tuple(axes.values()), mesh_dim_names=tuple(axes))
    return Mesh(dm, device)


def data_axis_names(mesh: Mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in DATA_AXES)


def data_parallel_size(mesh: Mesh) -> int:
    return int(np.prod([mesh.shape[a] for a in data_axis_names(mesh)] or [1]))


__all__ = ["AbstractMesh", "DATA_AXES", "DP", "DistributedInitError", "EP", "FSDP", "Mesh",
           "PP", "SP", "TP", "data_axis_names", "data_parallel_size", "initialize", "make_mesh",
           "mesh_device"]
