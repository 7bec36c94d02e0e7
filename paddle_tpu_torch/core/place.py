"""Place / device rule (counterpart of ``paddle_tpu.core.place``).

A place is a ``torch.device``. The port's entry points run on the CUDA
card unless the caller asks for the CPU: :func:`default_device` resolves
``device=None`` to ``cuda:0`` and raises :class:`NoCudaDevice` when there
is no card, so nothing carries on quietly on the CPU.

:class:`Place` is the JAX package's device identity (``platform`` and
``device_id``, printed as ``CPUPlace(0)``), over a ``torch.device``
(:meth:`Place.device`); :func:`default_place`, :func:`available_places`
and :func:`device_count` query what torch sees: the CUDA cards when there
is one, else the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import torch

from .errors import EnforceError



@dataclasses.dataclass(frozen=True)
class Place:
    """Device identity (platform/place.h analog): ``platform`` is
    ``"gpu"`` (a CUDA card) or ``"cpu"``; ``"tpu"`` is the JAX package's."""

    platform: str
    device_id: int = 0

    def device(self) -> torch.device:
        """The ``torch.device`` this place names; a TPU place raises
        :class:`UnsupportedPlace`, a CUDA place with no card
        :class:`NoCudaDevice`."""
        if self.platform == "cpu":
            return torch.device("cpu")
        if self.platform != "gpu":
            raise UnsupportedPlace(f"{self!r}: the PyTorch port runs on CUDA or the CPU")
        return default_device(torch.device("cuda", self.device_id), repr(self))

    def __repr__(self) -> str:  # mirrors e.g. "CUDAPlace(0)"
        return f"{self.platform.upper()}Place({self.device_id})"


DeviceLike = Union[None, str, torch.device, Place]


class NoCudaDevice(EnforceError):
    """A CUDA card was needed (the default device, or one asked for) but
    ``torch.cuda.is_available()`` is False."""

    def __init__(self, what: str = "this entry point"):
        super().__init__(
            f"{what} runs on a CUDA card, but no CUDA card is available "
            "(torch.cuda.is_available() is False); pass device='cpu' to "
            "run on the CPU")


class UnsupportedPlace(EnforceError):
    """A place this port cannot run on (TPUPlace)."""


def default_device(device: DeviceLike = None,
                   what: str = "this entry point") -> torch.device:
    """The device an entry point runs on: ``device`` when given (checked
    to exist if it is a CUDA device), else ``cuda:0``. Raises
    :class:`NoCudaDevice` when a CUDA device is needed and absent."""
    if isinstance(device, Place):
        device = device.device()
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDevice(what)
    if dev.type not in ("cuda", "cpu"):
        raise UnsupportedPlace(f"device {dev} is not supported (cuda or cpu)")
    return dev


def CPUPlace(device_id: int = 0) -> torch.device:
    return torch.device("cpu")


def CUDAPlace(device_id: int = 0) -> torch.device:
    return torch.device("cuda", device_id)


def TPUPlace(device_id: int = 0):
    raise UnsupportedPlace(
        "TPUPlace: the PyTorch port runs on CUDA or the CPU; the TPU "
        "build is the paddle_tpu package")


def default_place() -> Place:
    """Best available place: the first CUDA card, else the CPU (the JAX
    package's TPU > GPU > CPU, InitDevices analog)."""
    return Place("gpu", 0) if torch.cuda.is_available() else Place("cpu", 0)


def available_places(platform: Optional[str] = None) -> List[Place]:
    """Every place of the default backend: the CUDA cards when there is
    one, else the CPU, filtered to ``platform`` when given."""
    places = ([Place("gpu", i) for i in range(torch.cuda.device_count())]
              if torch.cuda.is_available() else [Place("cpu", 0)])
    return [p for p in places if platform is None or p.platform == platform]


def device_count() -> int:
    """The number of places of the default backend."""
    return len(available_places())
