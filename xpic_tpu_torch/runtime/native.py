"""ctypes bindings to the native runtime library (native/xpic_native.cpp).

Provides:
* ``ReferenceRng`` — the reference's exact random stream
  (std::mt19937 default seed + libstdc++ uniform_real_distribution,
  reference: src/utils/random_generator.h) for bit-equal particle loads;
* ``AsyncWriter`` — background-thread binary file writer (the
  reference's MPI-IO dump path equivalent,
  src/utils/mpi_binary_file.{h,cpp}).

The library is built on demand with ``make -C native``; all users must
degrade gracefully when a toolchain is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libxpic_native.so")
_lib = None


def load_library(build: bool = True):
    """Load (building if needed) the native library; None on failure."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and build:
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, "-s"],
                check=True, capture_output=True, timeout=120,
            )
        except Exception:
            return None
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.xpic_rng_create.restype = ctypes.c_void_p
    lib.xpic_rng_create.argtypes = [ctypes.c_uint32, ctypes.c_int]
    lib.xpic_rng_destroy.argtypes = [ctypes.c_void_p]
    lib.xpic_rng_uniform.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int64
    ]
    lib.xpic_rng_raw.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64
    ]
    lib.xpic_writer_create.restype = ctypes.c_void_p
    lib.xpic_writer_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64
    ]
    lib.xpic_writer_flush.restype = ctypes.c_int64
    lib.xpic_writer_flush.argtypes = [ctypes.c_void_p]
    lib.xpic_writer_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class ReferenceRng:
    """The reference's uniform(0,1) stream, bit-for-bit."""

    def __init__(self, seed: int | None = None):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        if seed is None:
            self._h = lib.xpic_rng_create(0, 1)  # default-seeded mt19937
        else:
            self._h = lib.xpic_rng_create(seed, 0)

    def uniform(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.float64)
        self._lib.xpic_rng_uniform(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n
        )
        return out

    def raw(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.uint32)
        self._lib.xpic_rng_raw(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n
        )
        return out

    def __del__(self):
        try:
            self._lib.xpic_rng_destroy(self._h)
        except Exception:
            pass


class AsyncWriter:
    """Background binary file writer; ``submit`` copies, ``flush`` joins."""

    def __init__(self):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.xpic_writer_create()

    def submit(self, path: str, data: np.ndarray) -> None:
        buf = np.ascontiguousarray(data)
        self._lib.xpic_writer_submit(
            self._h, path.encode(), buf.ctypes.data, buf.nbytes
        )

    def flush(self) -> int:
        return int(self._lib.xpic_writer_flush(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.xpic_writer_destroy(self._h)
            self._h = None
