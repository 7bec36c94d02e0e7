"""Dtype table (counterpart of ``paddle_tpu.core.dtypes``): user dtype
specs ('float32', np.float32, torch.float32) normalised to ``torch.dtype``."""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

_STR_TO_DTYPE = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}

DTypeLike = Union[str, np.dtype, type, torch.dtype]


def convert_dtype(dtype: DTypeLike):
    """Normalize a user dtype spec to a ``torch.dtype`` (None passes)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype not in _STR_TO_DTYPE:
            raise ValueError(
                f"Unsupported dtype {dtype!r}; expected one of {sorted(_STR_TO_DTYPE)}"
            )
        return _STR_TO_DTYPE[dtype]
    name = np.dtype(dtype).name
    if name not in _STR_TO_DTYPE:
        raise ValueError(f"Unsupported dtype {dtype!r}")
    return _STR_TO_DTYPE[name]


def dtype_name(dtype: torch.dtype) -> str:
    """The JAX/numpy name of a torch dtype ('bfloat16', 'int32', ...)."""
    return str(dtype).replace("torch.", "")
