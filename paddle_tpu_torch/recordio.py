"""RecordIO — Python binding over the C++ core (counterpart of
``paddle_tpu.recordio``, over the port's copy of ``native/recordio.cc``;
reference: paddle/fluid/recordio/ + recordio_writer.py).

Builds the shared library on first use with g++ into ``_build/`` (plain C
ABI + ctypes). The files are the JAX package's byte for byte: the same
records, ``compress`` and ``chunk_bytes`` write the same file, and each
package reads the other's. Provides:
- :class:`Writer` / :class:`Scanner` — raw byte records.
- ``write_arrays`` / ``read_arrays`` — numpy-tuple records with a tiny
  header (dtype/shape), the convert-reader-to-recordio capability
  (fluid.recordio_writer.convert_reader_to_recordio_file analog).
- ``reader_creator(path)`` — a reader-combinator-compatible creator.
"""

from __future__ import annotations

import ctypes
import io
import struct
from typing import Iterable, Iterator, Sequence, Tuple

import numpy as np

from .native import build_native

_lib = None


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    so = build_native("recordio.cc", "librecordio.so",
                      extra_flags=("-shared", "-fPIC"), opt="-O3",
                      libs=("-lz",))
    lib = ctypes.CDLL(so)
    lib.rio_writer_open.restype = ctypes.c_void_p
    lib.rio_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.rio_writer_write.restype = ctypes.c_int
    lib.rio_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
    lib.rio_writer_close.restype = ctypes.c_int
    lib.rio_writer_close.argtypes = [ctypes.c_void_p]
    lib.rio_scanner_open.restype = ctypes.c_void_p
    lib.rio_scanner_open.argtypes = [ctypes.c_char_p]
    lib.rio_scanner_next.restype = ctypes.c_int64
    lib.rio_scanner_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
    lib.rio_scanner_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class Writer:
    def __init__(self, path: str, compress: bool = True, chunk_bytes: int = 1 << 20):
        lib = _load_lib()
        self._lib = lib
        self._h = lib.rio_writer_open(path.encode(), int(compress), chunk_bytes)
        if not self._h:
            raise IOError(f"cannot open {path} for writing")

    def write(self, record: bytes) -> None:
        rc = self._lib.rio_writer_write(self._h, record, len(record))
        if rc != 0:
            raise IOError("recordio write failed")

    def close(self) -> None:
        if self._h:
            rc = self._lib.rio_writer_close(self._h)
            self._h = None
            if rc != 0:
                raise IOError("recordio close/flush failed")

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class Scanner:
    def __init__(self, path: str):
        lib = _load_lib()
        self._lib = lib
        self._h = lib.rio_scanner_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open {path}")

    def __iter__(self) -> Iterator[bytes]:
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        while True:
            n = self._lib.rio_scanner_next(self._h, ctypes.byref(ptr))
            if n == -1:
                break
            if n == -2:
                raise IOError("recordio corruption detected (crc/format)")
            yield ctypes.string_at(ptr, n)

    def close(self) -> None:
        if self._h:
            self._lib.rio_scanner_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# -- numpy tuple records -----------------------------------------------------


def _pack_arrays(arrays: Sequence[np.ndarray]) -> bytes:
    out = io.BytesIO()
    out.write(struct.pack("<I", len(arrays)))
    for a in arrays:
        a = np.ascontiguousarray(a)
        dt = a.dtype.str.encode()
        out.write(struct.pack("<I", len(dt)))
        out.write(dt)
        out.write(struct.pack("<I", a.ndim))
        out.write(struct.pack(f"<{a.ndim}q" if a.ndim else "<", *a.shape))
        raw = a.tobytes()
        out.write(struct.pack("<Q", len(raw)))
        out.write(raw)
    return out.getvalue()


def _unpack_arrays(rec: bytes) -> Tuple[np.ndarray, ...]:
    buf = io.BytesIO(rec)
    (n,) = struct.unpack("<I", buf.read(4))
    arrays = []
    for _ in range(n):
        (dl,) = struct.unpack("<I", buf.read(4))
        dt = np.dtype(buf.read(dl).decode())
        (nd,) = struct.unpack("<I", buf.read(4))
        shape = struct.unpack(f"<{nd}q", buf.read(8 * nd)) if nd else ()
        (rl,) = struct.unpack("<Q", buf.read(8))
        arrays.append(np.frombuffer(buf.read(rl), dtype=dt).reshape(shape))
    return tuple(arrays)


def write_arrays(path: str, samples: Iterable[Sequence[np.ndarray]],
                 compress: bool = True) -> int:
    """convert_reader_to_recordio_file analog: write tuple-of-array
    samples; returns count."""
    n = 0
    with Writer(path, compress=compress) as w:
        for s in samples:
            w.write(_pack_arrays([np.asarray(x) for x in s]))
            n += 1
    return n


def read_arrays(path: str) -> Iterator[Tuple[np.ndarray, ...]]:
    with Scanner(path) as s:
        for rec in s:
            yield _unpack_arrays(rec)


def reader_creator(path: str):
    """Reader-creator over a recordio file (open_recordio_file analog,
    layers/io.py:349)."""

    def reader():
        yield from read_arrays(path)

    return reader
