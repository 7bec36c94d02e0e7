"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers: seconds,
not minutes). The library lands in ``paddle_tpu_torch/_build/`` under a
name that carries a hash of the source, so an edited source rebuilds and
an unchanged one is loaded as it is. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from ..core.errors import EnforceError

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> (seconds the build took, compiler output); 0 s when it was cached
build_log: Dict[str, Tuple[float, str]] = {}


class KernelBuildError(EnforceError):
    """nvcc is missing or refused a kernel source."""


def find_nvcc() -> Optional[str]:
    """``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on PATH, then the CUDA
    toolkit's standard install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def nvcc_command(nvcc: str, source: str, out: str) -> List[str]:
    return [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-o", out, source]


def library_path(name: str) -> str:
    """Where the library built from ``csrc/<name>.cu`` goes: the hash of
    the source is part of the file name."""
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library's path. Raises :class:`KernelBuildError`."""
    out = library_path(name)
    if os.path.exists(out):
        build_log.setdefault(name, (0.0, "cached"))
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelBuildError(
            f"cannot build kernel {name!r}: nvcc not found (set CUDA_HOME "
            "or put nvcc on PATH)")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}.{threading.get_ident()}"
    t0 = time.perf_counter()
    proc = subprocess.run(nvcc_command(nvcc, os.path.join(CSRC, f"{name}.cu"),
                                       tmp),
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise KernelBuildError(f"nvcc failed on {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    build_log[name] = (seconds, log)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use.
    Builds run outside the lock, so several sources compile at once
    (two threads building one source write two temp files and the
    second rename wins with identical bytes)."""
    lib = _libs.get(name)
    if lib is None:
        path = build(name)
        with _lock:
            lib = _libs.setdefault(name, ctypes.CDLL(path))
    return lib


def sources() -> List[str]:
    """Names of every kernel source under ``csrc/`` (``flash_fwd`` ...)."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def load_all() -> Dict[str, ctypes.CDLL]:
    """Build (one nvcc per source, all started together) and load every
    kernel library."""
    names = sources()
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        return dict(zip(names, ex.map(load, names)))
