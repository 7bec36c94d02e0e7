"""Place / device rule (counterpart of ``paddle_tpu.core.place``).

A place is a ``torch.device``. The port's entry points run on the CUDA
card unless the caller asks for the CPU: :func:`default_device` resolves
``device=None`` to ``cuda:0`` and raises :class:`NoCudaDevice` when there
is no card, so nothing carries on quietly on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

from .errors import EnforceError

DeviceLike = Union[None, str, torch.device]


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
