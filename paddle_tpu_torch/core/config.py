"""Global flag registry (counterpart of ``paddle_tpu.core.config``).

A typed registry with environment overrides: a flag ``name`` is read from
``PDTPU_<NAME>`` when it is defined, as in the JAX package. The flags kept
are the ones that mean something on a CUDA card: ``check_nan_inf``,
``benchmark``, ``deterministic``, ``seed`` and ``default_compute_dtype``.
The JAX package's ``rng_impl`` (threefry or XLA's RngBitGenerator),
``compile_cache_dir`` (XLA's persistent compilation cache) and
``flash_block_q``/``flash_block_k`` (the Pallas kernel's TPU block sizes)
are facts of the TPU and XLA and have no counterpart here: the port draws
from ``torch.Generator``s, compiles nothing ahead, and its Hopper kernels
choose their own tiles.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict


@dataclasses.dataclass
class _Flag:
    name: str
    default: Any
    parser: Callable[[str], Any]
    help: str
    value: Any = None


_REGISTRY: Dict[str, _Flag] = {}


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes", "on")


def define_flag(name: str, default: Any, help: str = "") -> None:
    if isinstance(default, bool):
        parser: Callable[[str], Any] = _parse_bool
    elif isinstance(default, int):
        parser = int
    elif isinstance(default, float):
        parser = float
    else:
        parser = str
    env = os.environ.get(f"PDTPU_{name.upper()}")
    value = parser(env) if env is not None else default
    _REGISTRY[name] = _Flag(name, default, parser, help, value)


def get_flag(name: str) -> Any:
    return _REGISTRY[name].value


def set_flag(name: str, value: Any) -> None:
    _REGISTRY[name].value = value


def flags() -> Dict[str, Any]:
    return {k: f.value for k, f in _REGISTRY.items()}


_determinism_saved: Dict[str, Any] = {}


def enable_determinism() -> None:
    """Wire the ``deterministic`` flag to ``torch.use_deterministic_algorithms``
    (and cuDNN's deterministic mode): every op then takes a deterministic
    implementation or raises. CUDA's cuBLAS needs
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the environment before its first
    call for that; it is set here when absent. Invoked at package import
    when ``PDTPU_DETERMINISTIC=1``."""
    import torch

    if not _determinism_saved:
        _determinism_saved["algorithms"] = torch.are_deterministic_algorithms_enabled()
        _determinism_saved["cudnn"] = torch.backends.cudnn.deterministic
        _determinism_saved["cublas"] = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    set_flag("deterministic", True)


def disable_determinism() -> None:
    """Restore what :func:`enable_determinism` changed."""
    import torch

    if _determinism_saved:
        torch.use_deterministic_algorithms(_determinism_saved.pop("algorithms"))
        torch.backends.cudnn.deterministic = _determinism_saved.pop("cudnn")
        old = _determinism_saved.pop("cublas")
        if old is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = old
    set_flag("deterministic", False)


# the JAX package's core flags that have a meaning on the card
define_flag("check_nan_inf", False, "Scan outputs and grads for NaN/Inf (FLAGS_check_nan_inf analog)")
define_flag("benchmark", False, "Synchronize after each step (FLAGS_benchmark)")
define_flag("deterministic", False, "Force deterministic algorithms (FLAGS_cpu_deterministic)")
define_flag("default_compute_dtype", "float32", "Compute dtype of build programs ('bfloat16' for the tensor cores)")
define_flag("seed", 0, "Global random seed (startup-program seed analog)")
