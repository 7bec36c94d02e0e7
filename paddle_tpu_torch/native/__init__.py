"""Native C++ runtime pieces (counterpart of ``paddle_tpu.native``): the
asynchronous parameter server's ``pserver.cc``, the dataset master's
``master.cc`` and the RecordIO core ``recordio.cc``, copies of the JAX
package's sources as they are (they depend on no backend), and the build
helper that compiles them on first use."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from typing import Sequence

from ..core.errors import EnforceError

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")


class NativeBuildError(EnforceError):
    """g++ is missing or refused a native source."""


def build_native(src_name: str, bin_name: str,
                 extra_flags: Sequence[str] = ("-pthread",),
                 opt: str = "-O2", libs: Sequence[str] = ()) -> str:
    """Compile ``native/<src_name>`` with ``g++ <opt> -std=c++17
    <extra_flags> ... <libs>`` into ``_build/<bin_name>-<digest>`` unless it
    is already built there; returns the output's path. The digest covers
    the source and the flags, so an edited source or a change of flags
    rebuilds and an unchanged pair is used as it is. A shared library
    (``bin_name`` ending in ``.so``) keeps its suffix, as
    ``lib<name>-<digest>.so``, so ``ctypes`` loads it. Raises
    :class:`NativeBuildError`.

    Safe under concurrency: g++ writes to a path unique to the process
    and the result is renamed into place, so processes racing on the
    first build (parallel test workers sharing a checkout) each install
    a complete output and none runs a half-written one."""
    src = os.path.join(_DIR, src_name)
    flags = [opt, "-std=c++17", *extra_flags]
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update("\0".join(["flags", *flags, "libs", *libs]).encode())
    digest = h.hexdigest()[:16]
    stem, ext = os.path.splitext(bin_name) if bin_name.endswith(".so") else (bin_name, "")
    out = os.path.join(BUILD_DIR, f"{stem}-{digest}{ext}")
    if os.path.exists(out):
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeBuildError(f"cannot build {src_name}: g++ not found on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}"
    try:
        proc = subprocess.run([gxx, *flags, src, "-o", tmp, *libs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise NativeBuildError(f"g++ failed on {src_name} (exit "
                                   f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)  # atomic on POSIX
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


__all__ = ["BUILD_DIR", "NativeBuildError", "build_native"]
