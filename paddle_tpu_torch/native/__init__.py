"""Native C++ runtime pieces (counterpart of ``paddle_tpu.native``): the
asynchronous parameter server's ``pserver.cc``, a copy of the JAX
package's source as it is (it depends on no backend), and the build
helper that compiles it on first use."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

from ..core.errors import EnforceError

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")


class NativeBuildError(EnforceError):
    """g++ is missing or refused a native source."""


def build_native(src_name: str, bin_name: str) -> str:
    """Compile ``native/<src_name>`` with ``g++ -O2 -std=c++17 -pthread`` into
    ``_build/<bin_name>-<digest>`` unless it is already built there (the
    digest is the source's, so an edited source rebuilds and an unchanged
    one is run as it is); returns the binary's path. Raises
    :class:`NativeBuildError`.

    Safe under concurrency: g++ writes to a path unique to the process
    and the result is renamed into place, so processes racing on the
    first build (parallel test workers sharing a checkout) each install
    a complete binary and none runs a half-written one."""
    src = os.path.join(_DIR, src_name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"{bin_name}-{digest}")
    if os.path.exists(out):
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeBuildError(f"cannot build {src_name}: g++ not found on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}"
    try:
        proc = subprocess.run(
            [gxx, "-O2", "-std=c++17", "-pthread", src, "-o", tmp],
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
